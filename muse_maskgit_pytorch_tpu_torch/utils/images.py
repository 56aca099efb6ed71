"""Image conversion helpers (the port's own copy of what it needs from
`muse_maskgit_pytorch_tpu/training/data.py`)."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def to_pil_images(images) -> List:
    """(b, h, w, c) float [0, 1] tensor or array -> list of PIL images.

    Pillow is imported here, not with the module: only this conversion
    needs it."""
    from PIL import Image

    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    arr = np.clip(np.asarray(images, np.float32), 0.0, 1.0)
    arr = (arr * 255).round().astype(np.uint8)
    return [Image.fromarray(a.squeeze()) for a in arr]
