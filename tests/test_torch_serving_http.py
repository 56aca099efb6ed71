"""The port's HTTP front end (`muse_maskgit_pytorch_tpu_torch.serving_http`)
over a toy CPU pipeline: endpoints, coalescing, validation and status codes
as in the JAX package's server, errors sent to every waiter, round-robin
between kinds; and the PNG codec behind it (`utils.png`) against Pillow.

Tolerances: images coming through the batcher equal a direct pipeline call
exactly (uint8); decoded PNGs equal Pillow's decode and `convert` exactly.
"""

import base64
import io
import json
import struct
import sys
import threading
import urllib.error
import urllib.request
import zlib

import numpy as np
import pytest
from PIL import Image

from muse_maskgit_pytorch_tpu_torch.serving import GeneratePipeline
from muse_maskgit_pytorch_tpu_torch.serving_http import DynamicBatcher, GenerateServer, _b64_image, _b64_mask
from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png

from tests.test_torch_serving import TEXT_LEN, toy_maskgit


def pipeline(**kw):
    kw = dict(batch_size=4, timesteps=2, text_len=TEXT_LEN, device="cpu") | kw
    return GeneratePipeline(toy_maskgit(), **kw)


@pytest.fixture(scope="module")
def server():
    srv = GenerateServer(pipeline(), port=0, max_wait_ms=150.0, request_timeout_s=300.0, warmup=True)
    srv.start()
    yield srv
    srv.stop()


def _post(port, payload, path="/generate"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read())


def _pil_b64(arr, mode, **save):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", **save)
    return base64.b64encode(buf.getvalue()).decode()


def _decode(b64):
    return decode_png(base64.b64decode(b64))


# -- the server ---------------------------------------------------------------


def test_generate_endpoint(server):
    status, out = _post(server.port, {"prompts": ["a cat", "a dog"]})
    assert status == 200 and len(out["images"]) == 2
    img = _decode(out["images"][0])
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8
    # the port's PNG is a PNG: Pillow reads the same pixels
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(base64.b64decode(out["images"][0])))), img)


def test_healthz_and_stats(server):
    status, health = _get(server.port, "/healthz")
    assert status == 200 and health["ok"] and health["batch_size"] == 4 and health["image_size"] == 16
    assert "generate" in health["warm_surfaces"]
    _post(server.port, {"prompts": "one string is accepted"})
    status, stats = _get(server.port, "/stats")
    assert status == 200 and stats["images"] >= 1 and stats["batches"] >= 1
    assert "pipeline" in stats and stats["avg_batch_fill"] >= 1
    assert stats["backend_compiles"] == 0  # no kernel library on the CPU


def test_concurrent_requests_coalesce(server):
    """Concurrent one-prompt requests share batches."""
    before = dict(server.batcher.stats)
    results = [None] * 4

    def one(i):
        results[i] = _post(server.port, {"prompts": [f"prompt {i}"]})

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(not t.is_alive() for t in threads)
    assert all(r is not None and r[0] == 200 for r in results)
    assert server.batcher.stats["images"] - before["images"] == 4
    # 4 requests, batch 4, a 150 ms window: fewer batches than requests
    assert server.batcher.stats["batches"] - before["batches"] < 4
    assert server.batcher.stats["coalesced_batches"] >= 1


def test_edit_endpoint(server):
    rng = np.random.default_rng(7)
    src = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    mask = np.zeros((16, 16), np.uint8)
    mask[:8] = 255
    payload = {"prompts": ["a cat", "a dog"], "images": [_pil_b64(src, "RGB")] * 2, "masks": [_pil_b64(mask, "L")] * 2}
    status, out = _post(server.port, payload, path="/edit")
    assert status == 200
    assert all(_decode(b).shape == (16, 16, 3) for b in out["images"])
    status, _ = _post(server.port, {"prompts": ["x"], "images": [], "masks": []}, path="/edit")
    assert status == 400
    # a per-request scale on an edit
    payload = {"prompts": ["edit me"], "images": [_pil_b64(src, "RGB")], "masks": [_pil_b64(mask, "L")], "cond_scale": 5.5}
    status, out = _post(server.port, payload, path="/edit")
    assert status == 200 and len(out["images"]) == 1


def test_bad_requests(server):
    assert _post(server.port, {"prompts": []})[0] == 400
    assert _post(server.port, {"nope": 1})[0] == 400
    assert _post(server.port, {"prompts": ["x"]}, path="/other")[0] == 404
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/missing", timeout=10)


def test_cond_scale_and_negative_prompt_validation(server):
    assert _post(server.port, {"prompts": ["a cat"], "cond_scale": 6.0})[0] == 200
    assert _post(server.port, {"prompts": ["a cat", "a dog"], "cond_scale": [1.5, 6.0]})[0] == 200
    status, out = _post(server.port, {"prompts": ["a", "b"], "cond_scale": [1.0]})
    assert status == 400 and "cond_scale" in out["error"]
    assert _post(server.port, {"prompts": ["a"], "cond_scale": "high"})[0] == 400
    status, out = _post(server.port, {"prompts": ["a cat"], "negative_prompt": "blurry"})
    assert status == 200 and len(out["images"]) == 1
    status, out = _post(
        server.port, {"prompts": ["a cat", "a dog"], "negative_prompt": ["blurry", None], "cond_scale": [1.5, 6.0]}
    )
    assert status == 200 and len(out["images"]) == 2
    assert "neg_dynamic" in _get(server.port, "/healthz")[1]["warm_surfaces"]
    status, out = _post(server.port, {"prompts": ["a", "b"], "negative_prompt": ["only one"]})
    assert status == 400 and "negative_prompt" in out["error"]
    assert _post(server.port, {"prompts": ["a"], "negative_prompt": 3})[0] == 400
    # /edit takes no negative prompt: refused, not dropped
    status, out = _post(server.port, {"prompts": ["a"], "images": [], "masks": [], "negative_prompt": "x"}, path="/edit")
    assert status == 400 and "negative_prompt" in out["error"]


def test_edit_wrong_size_rejected_before_batching(server):
    """A wrong-size edit is a 400 at the handler, not a 500 for every request
    coalesced with it."""
    rng = np.random.default_rng(9)
    bad = {
        "prompts": ["x"],
        "images": [_pil_b64(rng.integers(0, 256, (20, 20, 3), dtype=np.uint8), "RGB")],
        "masks": [_pil_b64(np.zeros((20, 20), np.uint8), "L")],
    }
    good_mask = np.zeros((16, 16), np.uint8)
    good_mask[:8] = 255
    good = {
        "prompts": ["y"],
        "images": [_pil_b64(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8), "RGB")],
        "masks": [_pil_b64(good_mask, "L")],
    }
    results = {}
    threads = [
        threading.Thread(target=lambda n=n, p=p: results.__setitem__(n, _post(server.port, p, path="/edit")))
        for n, p in (("bad", bad), ("good", good))
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    status, out = results["bad"]
    assert status == 400 and "16x16" in out["error"]
    status, out = results["good"]
    assert status == 200 and len(out["images"]) == 1
    bad_mask = dict(good, masks=[_pil_b64(np.zeros((20, 20), np.uint8), "L")])
    status, out = _post(server.port, bad_mask, path="/edit")
    assert status == 400 and "masks[0]" in out["error"]


def test_failed_batch_is_a_500_with_the_error(server, monkeypatch):
    """A failure inside the batch (a kernel that does not build or launch,
    say) reaches every client of the batch as a 500 with its text."""

    def boom(*a, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(server.pipeline, "_generate_batch", boom)
    status, out = _post(server.port, {"prompts": ["a", "b"]})
    assert status == 500 and out["error"] == "RuntimeError: kernel launch failed"


# -- the batcher --------------------------------------------------------------


class _Recorder:
    """A pipeline stand-in that records what it was sent."""

    batch_size = 2
    return_pil = False
    cond_scale = 3.0

    def __init__(self):
        self.served = []

    def __call__(self, prompts, **kw):
        self.served.append(("generate", list(prompts), kw))
        return np.zeros((len(prompts), 2, 2, 3), np.uint8)

    def edit(self, images, masks, prompts, **kw):
        self.served.append(("edit", list(prompts), kw))
        return np.zeros((len(prompts), 2, 2, 3), np.uint8)


def test_batcher_sends_errors_to_every_waiter():
    class Boom(_Recorder):
        def __call__(self, prompts, **kw):
            raise RuntimeError("device on fire")

    b = DynamicBatcher(Boom(), max_wait_ms=50.0)
    pendings = b.submit(["x", "y"])
    b.start()
    try:
        for p in pendings:
            assert p.event.wait(timeout=10)
            assert isinstance(p.error, RuntimeError) and p.image is None
    finally:
        b.stop()
    assert b.stats["batches"] == 1 and b.stats["coalesced_batches"] == 1


def test_submit_length_mismatch_errors():
    b = DynamicBatcher(_Recorder(), max_wait_ms=1.0)
    with pytest.raises(ValueError, match="cond_scales"):
        b.submit(["a", "b", "c"], cond_scales=[2.0])
    with pytest.raises(ValueError, match="prompts but"):
        b.submit_edit(["a", "b"], sources=[0], masks=[0, 1])
    assert b._queues["generate"].empty() and b._queues["edit"].empty()


def test_batcher_round_robins_between_kinds():
    """A backlog of generates does not starve an edit: the edit batch runs
    before the last generate batch."""
    rec = _Recorder()
    b = DynamicBatcher(rec, max_wait_ms=10.0)
    gen = b.submit([f"g{i}" for i in range(6)])
    edit = b.submit_edit(["e0"], [np.zeros((2, 2, 3))], [np.ones((2, 2), bool)])
    b.start()
    try:
        for p in gen + edit:
            assert p.event.wait(timeout=10)
    finally:
        b.stop()
    kinds = [k for k, _, _ in rec.served]
    assert "edit" in kinds[:-1]


def test_batcher_passes_per_row_settings():
    """Default rows get the pipeline's scale beside a request's own; a
    negative prompt anywhere sends the per-row list; all-default batches
    send neither."""
    rec = _Recorder()
    b = DynamicBatcher(rec, max_wait_ms=200.0)
    first = b.submit(["a", "b"], cond_scales=[None, 5.0], negative_prompts=[None, "blurry"])
    second = b.submit(["c", "d"])
    b.start()
    try:
        for p in first + second:
            assert p.event.wait(timeout=10)
    finally:
        b.stop()
    assert rec.served[0] == ("generate", ["a", "b"], {"cond_scale": [3.0, 5.0], "negative_prompts": [None, "blurry"]})
    assert rec.served[1] == ("generate", ["c", "d"], {})


def test_batcher_under_many_threads():
    """More submitting threads than cores, a short switch interval: every
    request gets its own image and the counters add up."""

    class Echo(_Recorder):
        batch_size = 8

        def __call__(self, prompts, **kw):
            return np.stack([np.full((2, 2, 3), int(p), np.uint8) for p in prompts])

    b = DynamicBatcher(Echo(), max_wait_ms=2.0)
    b.start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    results = {}
    try:

        def client(t):
            for i in range(10):
                (p,) = b.submit([str(t * 10 + i)])
                assert p.event.wait(timeout=30)
                results[t * 10 + i] = int(p.image[0, 0, 0])

        threads = [threading.Thread(target=client, args=(t,)) for t in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(not t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        b.stop()
    assert results == {k: k for k in range(240)}
    assert b.stats["images"] == b.stats["batch_fill_sum"] == 240


def test_per_request_settings_through_the_batcher_equal_a_direct_call():
    """Requests with different scales and negative prompts coalesce into one
    batch, and each row equals the direct pipeline call with the same
    per-row settings (same seed)."""
    kw = dict(batch_size=2, seed=23)
    batcher = DynamicBatcher(pipeline(**kw), max_wait_ms=200.0)
    pendings = batcher.submit(["a cat", "a dog"], cond_scales=[2.0, None], negative_prompts=["blurry", None])
    batcher.start()
    try:
        for p in pendings:
            assert p.event.wait(timeout=300) and p.error is None
    finally:
        batcher.stop()
    assert batcher.stats["coalesced_batches"] == 1
    direct = pipeline(return_pil=False, **kw)(["a cat", "a dog"], cond_scale=[2.0, 3.0], negative_prompts=["blurry", None])
    np.testing.assert_array_equal(np.stack([p.image for p in pendings]), direct)


# -- the PNG codec ------------------------------------------------------------


@pytest.mark.parametrize("shape", [(16, 16, 3), (5, 7, 3), (9, 4)])
def test_png_round_trip(shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    data = encode_png(img)
    np.testing.assert_array_equal(decode_png(data, mode="RGB" if img.ndim == 3 else "L"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)


def _pil_image(mode, rng):
    h, w = 13, 17
    if mode == "P":
        img = Image.fromarray(rng.integers(0, 200, (h, w), dtype=np.uint8), "P")
        img.putpalette(rng.integers(0, 256, 768, dtype=np.uint8).tolist())
        return img
    channels = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # a smooth ramp plus noise: Pillow's adaptive filter picks several types
    ramp = np.add.outer(np.arange(h), np.arange(w))[..., None] * 7 + np.arange(channels) * 40
    arr = (ramp + rng.integers(0, 12, (h, w, channels))).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if channels == 1 else arr, mode)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
def test_png_decode_equals_pillow(mode):
    img = _pil_image(mode, np.random.default_rng(1))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    data = buf.getvalue()
    for target in ("RGB", "L"):
        want = np.asarray(Image.open(io.BytesIO(data)).convert(target))
        np.testing.assert_array_equal(decode_png(data, mode=target), want, err_msg=f"{mode} -> {target}")


def _filtered_png(arr: np.ndarray, colour: int, kinds) -> bytes:
    """A PNG whose row y uses filter `kinds[y % len(kinds)]`, written with a
    plain per-byte reference filter."""
    h = arr.shape[0]
    rows = arr.reshape(h, -1).astype(np.int64)
    bpp = arr.shape[2] if arr.ndim == 3 else 1
    raw = bytearray()
    for y in range(h):
        kind, cur = kinds[y % len(kinds)], rows[y]
        prev = rows[y - 1] if y else np.zeros_like(cur)
        out = []
        for i, x in enumerate(cur):
            a = cur[i - bpp] if i >= bpp else 0
            b = prev[i]
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            paeth = a if abs(p - a) <= abs(p - b) and abs(p - a) <= abs(p - c) else (b if abs(p - b) <= abs(p - c) else c)
            out.append((x - [0, a, b, (a + b) // 2, paeth][kind]) & 0xFF)
        raw += bytes([kind]) + bytes(out)

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))

    header = struct.pack(">IIBBBBB", arr.shape[1], h, 8, colour, 0, 0, 0)
    return b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4], ids=["none", "sub", "up", "average", "paeth"])
def test_png_every_filter_equals_pillow(kind):
    rng = np.random.default_rng(kind)
    for arr, colour in ((rng.integers(0, 256, (6, 9, 4), dtype=np.uint8), 6), (rng.integers(0, 256, (5, 8), dtype=np.uint8), 0)):
        data = _filtered_png(arr, colour, [kind, (kind + 1) % 5])
        for target in ("RGB", "L"):
            want = np.asarray(Image.open(io.BytesIO(data)).convert(target))
            np.testing.assert_array_equal(decode_png(data, mode=target), want)


def test_b64_mask_and_image_equal_pillow():
    rng = np.random.default_rng(3)
    rgb = rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
    for b64 in (_pil_b64(rgb, "RGB"), _pil_b64(rgb[..., 0], "L"), _pil_b64(np.dstack([rgb, rgb[..., :1]]), "RGBA")):
        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        np.testing.assert_array_equal(_b64_mask(b64), np.asarray(img.convert("L")) > 127)
        np.testing.assert_array_equal(_b64_image(b64), np.asarray(img.convert("RGB")))


def test_png_rejects_what_it_does_not_read():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + encode_png(img)[6:])
    bad = bytearray(encode_png(img))
    bad[-20] ^= 0xFF  # inside IDAT
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(bad))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="PNG")  # 16-bit grey: read as Pillow reads it
    np.testing.assert_array_equal(decode_png(buf.getvalue()), np.asarray(Image.open(buf).convert("RGB")))
    bad_depth = bytearray(encode_png(img))
    bad_depth[24] = 3  # IHDR's bit depth: 3 bits is no PNG's, then its CRC
    bad_depth[29:33] = struct.pack(">I", zlib.crc32(bytes(bad_depth[12:29])))
    with pytest.raises(ValueError, match="not a valid PNG"):
        decode_png(bytes(bad_depth))
    interlaced = bytearray(encode_png(img))
    interlaced[28] = 1  # IHDR's interlace method, then its CRC: the rows are not Adam7's passes
    interlaced[29:33] = struct.pack(">I", zlib.crc32(bytes(interlaced[12:29])))
    with pytest.raises(ValueError, match="bytes"):
        decode_png(bytes(interlaced))
    with pytest.raises(ValueError, match="uint8"):
        encode_png(np.zeros((2, 2, 3), np.float32))
