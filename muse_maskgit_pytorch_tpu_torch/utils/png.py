"""A PNG codec in the standard library (`zlib`, `struct`) and numpy, for the
HTTP server's images: the GPU machine need not have Pillow.

`encode_png` writes 8-bit greyscale (h, w) or RGB (h, w, 3) images, each row
unfiltered. `decode_png` reads every PNG the standard allows: each colour
type (grey, grey + alpha, RGB, RGBA, palette) at each of its bit depths
(1 / 2 / 4 / 8 / 16 for grey, 1 / 2 / 4 / 8 for palette, 8 / 16 for the
others), plain or Adam7-interlaced, with all five row filters. It converts
them as `PIL.Image.open(...).convert(...)` does, to the byte: grey below 8
bits scaled to 0-255 (x 255, 85, 17), 16-bit grey clipped to 255 (Pillow's
"I;16" to "RGB" / "L"), 16-bit colour and alpha to their high byte, palette
indices looked up (past the palette, black), alpha and tRNS dropped; then
to "RGB", or to "L" (ITU-R 601-2 luma, (299 R + 587 G + 114 B) / 1000 in
Pillow's 16-bit fixed point, rounded half up).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, palette, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# colour type -> the bit depths the standard allows it
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7's passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


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


def _unpack(rows: np.ndarray, depth: int, n: int) -> np.ndarray:
    """(h, stride) unfiltered bytes -> (h, n) samples of `depth` bits, big
    endian as PNG packs them (uint8, or uint16 at 16 bits)."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        pairs = rows[:, : 2 * n].reshape(rows.shape[0], n, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    samples = (rows[..., None] >> shifts) & np.uint8((1 << depth) - 1)
    return samples.reshape(rows.shape[0], -1)[:, :n]


def _to_8bit(samples: np.ndarray, depth: int, colour: int) -> np.ndarray:
    """Samples -> uint8 as Pillow opens them: grey below 8 bits scaled to
    0-255, 16-bit grey clipped ("I;16"), other 16-bit samples' high byte;
    palette indices stay indices."""
    if depth == 16:
        return np.minimum(samples, 255).astype(np.uint8) if colour == 0 else (samples >> 8).astype(np.uint8)
    if depth < 8 and colour == 0:
        return samples * np.uint8(255 // ((1 << depth) - 1))
    return samples


def _luma(rgb: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def decode_png(data: bytes, mode: str = "RGB") -> np.ndarray:
    """PNG bytes -> uint8 array: (h, w, 3) for `mode="RGB"`, (h, w) for
    "L"."""
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
    if colour not in _CHANNELS or depth not in _DEPTHS[colour]:
        raise ValueError(f"PNG bit depth {depth} with colour type {colour} is not a valid PNG")
    if interlace not in (0, 1):
        raise ValueError(f"PNG interlace method {interlace}, not 0 or 1")
    ch = _CHANNELS[colour]
    bits = ch * depth
    bpp = max(1, bits // 8)
    raw = zlib.decompress(b"".join(idat))
    if not interlace:
        stride = (w * bits + 7) // 8
        samples = _unpack(_unfilter(raw, h, stride, bpp), depth, w * ch).reshape(h, w, ch)
    else:
        # seven sub-images, each filtered on its own; an empty pass has no bytes
        samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            stride = (pw * bits + 7) // 8
            part = raw[pos : pos + ph * (stride + 1)]
            pos += ph * (stride + 1)
            samples[y0::dy, x0::dx] = _unpack(_unfilter(part, ph, stride, bpp), depth, pw * ch).reshape(ph, pw, ch)
        if pos != len(raw):
            raise ValueError(f"PNG image data holds {len(raw)} bytes, its interlaced passes {pos}")
    pixels = _to_8bit(samples, depth, colour)
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
