"""A PNG codec in the standard library (`zlib`, `struct`) and numpy, for the
HTTP server's images: the GPU machine need not have Pillow.

`encode_png` writes 8-bit greyscale (h, w) or RGB (h, w, 3) images, each row
unfiltered. `decode_png` reads 8-bit, non-interlaced PNGs of every colour
type (grey, grey + alpha, RGB, RGBA, palette) and all five row filters, and
converts them as Pillow's `Image.convert` does: to "RGB" (alpha dropped,
palette looked up) or to "L" (ITU-R 601-2 luma, (299 R + 587 G + 114 B) /
1000 in Pillow's 16-bit fixed point, rounded half up).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def encode_png(image: np.ndarray) -> bytes:
    """uint8 (h, w) greyscale or (h, w, 3) RGB -> PNG bytes."""
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"PNG images here are uint8, got {image.dtype}")
    if image.ndim == 2:
        colour = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"encode_png takes (h, w) or (h, w, 3) images, got shape {image.shape}")
    h, w = image.shape[:2]
    # filter type 0 (none) in front of every row
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0)
    return SIGNATURE + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(
        b"IEND", b""
    )


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of `raw`,
    h rows of a filter byte then `stride` bytes -> (h, stride) uint8."""
    if len(raw) != h * (stride + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, its header says {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs the one bpp to its left
            cur = bytearray(line.tobytes())
            up = prior.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}, not 0-4")
        out[y] = cur
        prior = out[y]
    return out


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes, mode: str = "RGB") -> np.ndarray:
    """PNG bytes -> uint8 array: (h, w, 3) for `mode="RGB"`, (h, w) for
    "L". 8-bit, non-interlaced images only."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, palette, idat = 8, None, None, []
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError("PNG chunk header cut short")
        (n,), kind = struct.unpack(">I", data[pos : pos + 4]), data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        crc = data[pos + 8 + n : pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"PNG chunk {kind!r} cut short")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG file without IHDR or IDAT")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS:
        raise ValueError(f"only 8-bit PNGs are read here, got bit depth {depth}, colour type {colour}")
    if interlace:
        raise ValueError("interlaced PNGs are not read here")
    ch = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch).reshape(h, w, ch)
    if colour == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        # indices past the palette read as black, as Pillow pads it
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette
        pixels = full[pixels[..., 0]]
    if mode == "RGB":
        return pixels[..., :3] if pixels.shape[2] >= 3 else np.repeat(pixels[..., :1], 3, axis=2)
    if mode == "L":
        return _luma(pixels) if pixels.shape[2] >= 3 else pixels[..., 0].copy()
    raise ValueError(f"mode must be 'RGB' or 'L', got {mode!r}")
