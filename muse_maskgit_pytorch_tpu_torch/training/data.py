"""Host-side data of the trainers (counterpart of
`muse_maskgit_pytorch_tpu/training/data.py`): the image folder dataset, its
shuffling batch loader and the train / valid split; an infinite `cycle`, a
background `prefetch_iterator`, and image grids written as PNG through
`utils.png`.

Pillow is not needed for PNG files: they decode through `utils.png`, and
the cover resize is `F.interpolate(mode="bilinear", antialias=True)` on
uint8 images (horizontal pass, uint8 rounding, vertical pass, as Pillow's
`BILINEAR` resamples), within one level of Pillow's pixels. JPEG files
decode through Pillow where it is installed; a folder with JPEGs on a
machine without it is refused when the dataset is built. The flips and the
shuffle draw from `random.Random(seed)` as the JAX package does; the flips
in batch order, so the batches are the same whatever the loader's threads
(the JAX loader's at `num_workers=1`).
"""

from __future__ import annotations

import queue
import random
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png

JPEG_SUFFIXES = (".jpg", ".jpeg")


def _pillow_available() -> bool:
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


def _read_rgb(path: Path) -> np.ndarray:
    """uint8 (h, w, 3): PNG through `utils.png`, JPEG through Pillow."""
    if path.suffix.lower() in JPEG_SUFFIXES:
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True  # as the JAX dataset reads them
        with Image.open(path) as img:
            return np.asarray(img.convert("RGB"))
    return decode_png(path.read_bytes(), mode="RGB")


def resize_bilinear(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """uint8 (H, W, 3) -> uint8 (h, w, 3), antialiased when it shrinks, as
    Pillow's `resize(..., BILINEAR)`; the same size returns a copy."""
    if image.shape[:2] == (h, w):
        return image.copy()
    t = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(h, w), mode="bilinear", antialias=True, align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


class ImageDataset:
    """Recursive glob of `exts`; an item is the image as RGB, cover-resized
    (scaled so both target sides are reached), flipped left-right at random
    with `random_flip`, centre-cropped to `image_size` (an int or (h, w)),
    as float32 (h, w, 3) in [0, 1]."""

    def __init__(self, folder, image_size, exts: Sequence[str] = ("jpg", "jpeg", "png"), random_flip: bool = True, seed: int = 0):
        self.folder = folder
        self.image_size = image_size
        self.paths = [p for ext in exts for p in Path(folder).glob(f"**/*.{ext}")]
        self.random_flip = random_flip
        self._rng = random.Random(seed)
        jpegs = [p for p in self.paths if p.suffix.lower() in JPEG_SUFFIXES]
        if jpegs and not _pillow_available():
            names = ", ".join(str(p) for p in jpegs[:5]) + (f" and {len(jpegs) - 5} more" if len(jpegs) > 5 else "")
            raise RuntimeError(f"{len(jpegs)} JPEG files need Pillow, which is not installed: {names}")
        print(f"{len(self.paths)} training samples found at {folder}")

    def __len__(self) -> int:
        return len(self.paths)

    def draw_flip(self) -> bool:
        """The next item's flip, from the dataset's generator."""
        return self.random_flip and self._rng.random() < 0.5

    def __getitem__(self, index: int) -> np.ndarray:
        return self.load(index, self.draw_flip())

    def load(self, index: int, flip: bool) -> np.ndarray:
        img = _read_rgb(self.paths[index])
        s = self.image_size
        th, tw = (s, s) if isinstance(s, int) else (int(s[0]), int(s[1]))
        h, w = img.shape[:2]
        scale = max(th / h, tw / w)
        img = resize_bilinear(img, max(th, round(h * scale)), max(tw, round(w * scale)))
        if flip:
            img = img[:, ::-1]
        h, w = img.shape[:2]
        top, left = (h - th) // 2, (w - tw) // 2
        return img[top : top + th, left : left + tw].astype(np.float32) / 255.0


class _Subset:
    """The items `indices` of `ds`, with its `draw_flip` and `load` where it
    has them."""

    def __init__(self, ds, indices):
        self.ds, self.indices = ds, indices
        if hasattr(ds, "load"):
            self.draw_flip = ds.draw_flip
            self.load = lambda i, flip: ds.load(indices[i], flip)

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int):
        return self.ds[self.indices[i]]


def split_dataset(dataset, valid_frac: float, seed: int = 42):
    """Random (train, valid) split; with `valid_frac` <= 0 both are the
    whole dataset."""
    if valid_frac <= 0:
        return dataset, dataset
    idx = list(range(len(dataset)))
    random.Random(seed).shuffle(idx)
    n_valid = int(len(idx) * valid_frac)
    return _Subset(dataset, idx[n_valid:]), _Subset(dataset, idx[:n_valid])


class DataLoader:
    """Shuffled batches (the last one partial) of a dataset, decoded on
    `num_workers` threads and assembled on a background thread, `prefetch`
    batches ahead. Every pass shuffles from `seed` anew, as the JAX loader
    does. A dataset with `draw_flip` and `load` (an `ImageDataset` or its
    split) has each batch's flips drawn in batch order before the decode."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0, prefetch: int = 2, num_workers: int = 4):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)

    def _batches(self) -> Iterator[np.ndarray]:
        ds = self.dataset
        order = list(range(len(ds)))
        if self.shuffle:
            random.Random(self.seed).shuffle(order)
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
            for start in range(0, len(order), self.batch_size):
                chunk = order[start : start + self.batch_size]
                if hasattr(ds, "load"):
                    flips = [ds.draw_flip() for _ in chunk]
                    items = list(pool.map(ds.load, chunk, flips))
                else:
                    items = list(pool.map(ds.__getitem__, chunk))
                yield np.stack(items)

    def __iter__(self) -> Iterator[np.ndarray]:
        return prefetch_iterator(self._batches(), self.prefetch)


def cycle(dl) -> Iterator:
    """Infinite loader; an empty one raises instead of spinning."""
    while True:
        empty = True
        for item in dl:
            empty = False
            yield item
        if empty:
            raise ValueError("cycle: the loader yields nothing (an empty dataset or split)")


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
