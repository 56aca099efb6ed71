"""The port's PNG reader on every kind of PNG the standard allows, against
Pillow and against the JAX package's `ImageDataset`, which opens every file
with `PIL.Image.open(p).convert("RGB")`.

The files are written by hand with `zlib` (every colour type at each of its
bit depths, plain and Adam7-interlaced, rows under all five filters) or by
Pillow (16-bit greyscale and palettes at 1 / 2 / 4 bits). `decode_png`
must give Pillow's bytes exactly, in "RGB" and in "L". The datasets must
agree exactly at the files' own size (no resampling) and within one level
(1/255) where the port resamples with its own bilinear filter, as the
image data path's own test holds it.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from muse_maskgit_pytorch_tpu.training import data as jdata
from muse_maskgit_pytorch_tpu_torch.training import data as pdata
from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png

PIXEL_TOL = 1 / 255 + 1e-6
SIGNATURE = b"\x89PNG\r\n\x1a\n"
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
KINDS = [(c, d, il) for c, ds in DEPTHS.items() for d in ds for il in (0, 1)]


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def _pack_rows(samples: np.ndarray, depth: int) -> list:
    """(h, n) samples -> each row's bytes, packed big endian."""
    if depth == 16:
        return [row.astype(">u2").tobytes() for row in samples]
    if depth == 8:
        return [row.astype(np.uint8).tobytes() for row in samples]
    per = 8 // depth
    rows = []
    for row in samples.astype(np.uint8):
        row = np.concatenate([row, np.zeros((-len(row)) % per, np.uint8)]).reshape(-1, per)
        packed = np.zeros(len(row), np.uint8)
        for i in range(per):
            packed |= row[:, i] << (8 - depth * (i + 1))
        rows.append(packed.tobytes())
    return rows


def _filter(rows: list, bpp: int, rng) -> bytes:
    """Each row under a filter drawn from 0-4, as an encoder writes it."""
    out, prior = b"", bytes(len(rows[0]))
    for row in rows:
        kind = int(rng.integers(0, 5))
        filtered = bytearray(len(row))
        for i in range(len(row)):
            a = row[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            if kind == 0:
                pred = 0
            elif kind == 1:
                pred = a
            elif kind == 2:
                pred = b
            elif kind == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            filtered[i] = (row[i] - pred) & 0xFF
        out += bytes([kind]) + bytes(filtered)
        prior = row
    return out


def write_png(pixels: np.ndarray, colour: int, depth: int, interlace: int = 0, palette=None, trns=None, seed=0) -> bytes:
    """(h, w, channels) integer samples -> PNG bytes, written by hand."""
    rng = np.random.default_rng(seed)
    h, w, ch = pixels.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b""
        for x0, y0, dx, dy in ADAM7:
            sub = pixels[y0::dy, x0::dx]
            if sub.size:
                raw += _filter(_pack_rows(sub.reshape(sub.shape[0], -1), depth), bpp, rng)
    else:
        raw = _filter(_pack_rows(pixels.reshape(h, -1), depth), bpp, rng)
    data = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace))
    if palette is not None:
        data += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        data += _chunk(b"tRNS", trns)
    return data + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _random_png(colour, depth, interlace, h, w, seed) -> bytes:
    rng = np.random.default_rng(seed)
    pixels = rng.integers(0, 2**depth, (h, w, CHANNELS[colour]))
    # a palette shorter than the index range: indices past it read as black
    palette = rng.integers(0, 256, (max(1, 2**depth - 3), 3)) if colour == 3 else None
    return write_png(pixels, colour, depth, interlace, palette, seed=seed)


def _pillow_pngs(seed=0) -> dict:
    """Files Pillow writes itself: 16-bit greyscale and low-depth palettes."""
    rng = np.random.default_rng(seed)
    files = {}
    grey16 = rng.integers(0, 65536, (13, 10)).astype(np.uint16)
    grey16[0, :4] = [0, 1, 255, 256]  # both sides of Pillow's clip
    buf = io.BytesIO()
    Image.frombytes("I;16", (10, 13), grey16.tobytes()).save(buf, "PNG")
    files["pillow_grey16"] = buf.getvalue()
    for bits in (1, 2, 4):
        img = Image.fromarray(rng.integers(0, 2**bits, (9, 14)).astype(np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 3 * 2**bits).astype(np.uint8).tobytes())
        buf = io.BytesIO()
        img.save(buf, "PNG", bits=bits)
        files[f"pillow_palette{bits}"] = buf.getvalue()
    return files


@pytest.mark.parametrize("colour,depth,interlace", KINDS, ids=[f"c{c}-d{d}-i{i}" for c, d, i in KINDS])
def test_decode_matches_pillow(colour, depth, interlace):
    for seed, (h, w) in enumerate([(1, 1), (3, 2), (7, 11), (9, 17), (16, 16)]):
        data = _random_png(colour, depth, interlace, h, w, seed)
        img = Image.open(io.BytesIO(data))
        assert img.info.get("interlace", 0) == interlace
        for mode in ("RGB", "L"):
            want = np.asarray(img.convert(mode))
            got = decode_png(data, mode)
            assert got.dtype == want.dtype and got.shape == want.shape, (h, w, mode)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} {mode}")


def test_pillow_written_files_and_transparency():
    files = _pillow_pngs()
    rng = np.random.default_rng(5)
    # tRNS on grey, RGB and palette images: Pillow's "RGB" conversion drops it
    files["trns_grey16"] = write_png(rng.integers(0, 65536, (5, 6, 1)), 0, 16, trns=struct.pack(">H", 7))
    files["trns_rgb8"] = write_png(rng.integers(0, 256, (5, 6, 3)), 2, 8, trns=struct.pack(">HHH", 1, 2, 3))
    files["trns_palette4"] = write_png(
        rng.integers(0, 16, (5, 6, 1)), 3, 4, palette=rng.integers(0, 256, (16, 3)), trns=bytes([0, 128])
    )
    for name, data in files.items():
        img = Image.open(io.BytesIO(data))
        np.testing.assert_array_equal(decode_png(data, "RGB"), np.asarray(img.convert("RGB")), err_msg=name)
        np.testing.assert_array_equal(decode_png(data, "L"), np.asarray(img.convert("L")), err_msg=name)
    assert Image.open(io.BytesIO(files["pillow_grey16"])).mode == "I;16"


def test_eight_bit_files_decode_as_before():
    rng = np.random.default_rng(3)
    for image in (rng.integers(0, 256, (6, 9, 3), dtype=np.uint8), rng.integers(0, 256, (4, 5), dtype=np.uint8)):
        got = decode_png(encode_png(image))
        want = image if image.ndim == 3 else np.repeat(image[..., None], 3, axis=2)
        np.testing.assert_array_equal(got, want)


def test_invalid_depth_and_short_interlaced_data_are_refused():
    good = write_png(np.zeros((4, 4, 3), int), 2, 8, interlace=1)
    bad_depth = good.replace(struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1), struct.pack(">IIBBBBB", 4, 4, 4, 2, 0, 0, 1))
    ihdr_end = 8 + 8 + 13
    bad_depth = bad_depth[: ihdr_end] + struct.pack(">I", zlib.crc32(bad_depth[12:ihdr_end])) + bad_depth[ihdr_end + 4 :]
    with pytest.raises(ValueError, match="bit depth 4 with colour type 2"):
        decode_png(bad_depth)
    # an interlaced file whose data ends inside its last pass
    raw = zlib.decompress(good[good.index(b"IDAT") + 4 : -16])
    short = SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", 4, 4, 8, 2, 0, 0, 1)) + _chunk(
        b"IDAT", zlib.compress(raw[:-3])
    ) + _chunk(b"IEND", b"")
    with pytest.raises(ValueError, match="bytes"):
        decode_png(short)


@pytest.fixture(scope="module")
def png_folder(tmp_path_factory):
    """One file of each kind the datasets must read alike, all 16 x 16."""
    folder = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(11)
    wanted = [(0, 16, 0), (2, 16, 0), (0, 1, 0), (0, 2, 0), (0, 4, 0), (3, 1, 0), (3, 2, 0), (3, 4, 0), (2, 8, 1), (6, 16, 1)]
    for i, (colour, depth, interlace) in enumerate(wanted):
        pixels = rng.integers(0, 2**depth, (16, 16, CHANNELS[colour]))
        palette = rng.integers(0, 256, (2**depth, 3)) if colour == 3 else None
        (folder / f"c{colour}_d{depth}_i{interlace}.png").write_bytes(write_png(pixels, colour, depth, interlace, palette, seed=i))
    pillow = _pillow_pngs(seed=2)
    for name, data in pillow.items():
        (folder / f"{name}.png").write_bytes(data)
    return folder


@pytest.mark.parametrize("size", [16, 12])
def test_image_dataset_matches_jax(png_folder, size):
    """At the files' size (16; the Pillow-written ones are resampled) and
    shrunk to 12, with the flips drawn alike on both sides."""
    jds = jdata.ImageDataset(png_folder, size, random_flip=True, seed=3)
    pds = pdata.ImageDataset(png_folder, size, random_flip=True, seed=3)
    assert [str(p) for p in pds.paths] == [str(p) for p in jds.paths] and len(pds) == 14
    for i in range(len(jds)):
        want, got = jds[i], pds[i]
        assert got.dtype == np.float32 and got.shape == want.shape == (size, size, 3)
        same_size = Image.open(jds.paths[i]).size == (16, 16) and size == 16
        tol = 0.0 if same_size else PIXEL_TOL
        assert np.abs(got - want).max() <= tol, (pds.paths[i].name, np.abs(got - want).max())
