"""Host-side data helpers of the trainers (counterpart of part of
`muse_maskgit_pytorch_tpu/training/data.py`): an infinite `cycle`, a
background `prefetch_iterator`, and image grids written as PNG through
`utils.png` (no Pillow). The image dataset and loader wait for ROADMAP A10.
"""

from __future__ import annotations

import queue
import threading
import warnings
from pathlib import Path
from typing import Iterator

import numpy as np

from muse_maskgit_pytorch_tpu_torch.utils.png import encode_png


def cycle(dl) -> Iterator:
    """Infinite loader."""
    while True:
        yield from dl


def prefetch_iterator(it: Iterator, size: int = 2) -> Iterator:
    """Run `it` in a background thread with a bounded queue, so that making
    the next item (host IO, the frozen T5) overlaps the consumer's step.
    Exceptions re-raise at the consumer; closing the generator stops the
    producer and waits for it, so the caller may free what `it` uses."""
    if size <= 0:
        yield from it
        return

    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    sentinel = object()

    def put_bounded(x) -> bool:
        """Put with stop-flag checks; False once the consumer walked away."""
        while not stop.is_set():
            try:
                q.put(x, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def run():
        try:
            for x in it:
                if not put_bounded(x):
                    return
            put_bounded(sentinel)
        except BaseException as e:  # surfaced to the consumer
            put_bounded(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    try:
        while True:
            x = q.get()
            if x is sentinel:
                return
            if isinstance(x, BaseException):
                raise x
            yield x
    finally:
        stop.set()
        # join, so that after close() the producer no longer touches `it`'s
        # resources (a native shard loader the caller frees next)
        waited = 0.0
        while True:
            t.join(timeout=15.0)
            if not t.is_alive():
                break
            waited += 15.0
            warnings.warn(
                f"prefetch producer still finishing its current item after {waited:.0f}s; waiting",
                stacklevel=2,
            )


def make_grid(images, nrow: int = 2, padding: int = 2, pad_value: float = 0.0) -> np.ndarray:
    """(n, h, w, c) -> one (H, W, c) grid, torchvision's layout."""
    arr = np.asarray(images, np.float32)
    n, h, w, c = arr.shape
    nrows = -(-n // nrow)
    grid = np.full((nrows * (h + padding) + padding, nrow * (w + padding) + padding, c), pad_value, np.float32)
    for i in range(n):
        r, col = divmod(i, nrow)
        y, x = padding + r * (h + padding), padding + col * (w + padding)
        grid[y : y + h, x : x + w] = arr[i]
    return grid


def save_image(image: np.ndarray, path) -> None:
    """(h, w, 3) or (h, w[, 1]) floats in [0, 1] -> an 8-bit PNG file."""
    arr = np.clip(np.asarray(image, np.float32), 0.0, 1.0)
    arr = (arr * 255).round().astype(np.uint8)
    Path(path).write_bytes(encode_png(arr.squeeze()))
