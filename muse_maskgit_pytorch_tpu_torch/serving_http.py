"""HTTP serving front end with dynamic batching (counterpart of
`muse_maskgit_pytorch_tpu/serving_http.py`).

`GenerateServer` turns a `GeneratePipeline` into a network service: one
worker thread owns the card and always submits the pipeline's fixed
`batch_size`, while a request-coalescing queue fills each batch from the
concurrent HTTP requests in flight. A lone request waits at most
`max_wait_ms` for companions before its batch is padded out and sent, so
latency is bounded and throughput under load approaches the pipeline's
img/s. HTTP handler threads only parse, enqueue and wait.

Endpoints:
  POST /generate   {"prompts": [...], "cond_scale"?, "negative_prompt"?} -> {"images": [b64 PNG]}
  POST /edit       {"prompts": [...], "images": [b64 PNG], "masks": [b64 PNG], "cond_scale"?}
  GET  /healthz    liveness, warm surfaces, batch and image size
  GET  /stats      batching counters, the pipeline's stats, backend_compiles

Usage:
    pipe = GeneratePipeline(model, batch_size=16)   # on the card
    server = GenerateServer(pipe, port=8000, warmup="all")
    server.start()          # returns at once; serves until .stop()

Standard library only (`http.server`, `threading`, `queue`, `json`,
`base64`); PNGs through `utils.png`.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Tuple

import numpy as np

from muse_maskgit_pytorch_tpu_torch.serving import backend_compile_count
from muse_maskgit_pytorch_tpu_torch.utils.png import decode_png, encode_png


class _Pending:
    """One enqueued prompt (and its edit payload) and its result slot."""

    __slots__ = ("prompt", "source", "mask", "cond_scale", "negative_prompt", "event", "image", "error", "enqueued")

    def __init__(self, prompt: str, source=None, mask=None, cond_scale=None, negative_prompt=None):
        self.prompt = prompt
        self.source = source  # (H, W, 3) source image of an edit
        self.mask = mask  # (H, W) bool edit mask of an edit
        self.cond_scale = cond_scale  # per-request guidance (None: the default)
        self.negative_prompt = negative_prompt  # per-request negative (None: the default)
        self.event = threading.Event()
        self.image: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        self.enqueued = time.monotonic()  # for the queue wait


class DynamicBatcher:
    """Coalesces single prompts into the pipeline's fixed-size batches.

    One worker thread drains the queues: it waits up to `max_wait_ms` for a
    batch to fill, then sends what it has (the pipeline pads it to
    `batch_size`). All device work happens on that thread, so concurrent
    requests never contend for the card.
    """

    def __init__(self, pipeline, max_wait_ms: float = 50.0):
        self.pipeline = pipeline
        self.max_wait = max_wait_ms / 1000.0
        # generate and edit batches run different programs, so they batch
        # apart: one FIFO queue per kind, one worker
        self._queues = {"generate": queue.Queue(), "edit": queue.Queue()}
        # round-robin start between kinds: a sustained stream of one kind
        # must not starve the other
        self._kinds = list(self._queues)
        self._rr = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stats = {
            "batches": 0,
            "images": 0,
            "coalesced_batches": 0,  # batches serving more than one prompt
            "batch_fill_sum": 0,  # real prompts per batch, for the fill rate
            # seconds from a prompt's enqueue to the start of its batch:
            # summed over prompts (over `images`: the mean wait) and the longest
            "queue_wait_seconds": 0.0,
            "queue_wait_max_seconds": 0.0,
        }

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)

    def submit(self, prompts: List[str], cond_scales=None, negative_prompts=None) -> List[_Pending]:
        """`cond_scales` / `negative_prompts`: optional, one entry a prompt
        (None: the pipeline's default). Requests with different scales and
        negatives still share one batch (per-row scales and negatives)."""
        if cond_scales is None:
            cond_scales = [None] * len(prompts)
        if negative_prompts is None:
            negative_prompts = [None] * len(prompts)
        # zip would drop requests silently on a length mismatch; ValueError,
        # not assert: request validation must survive python -O
        if not len(cond_scales) == len(negative_prompts) == len(prompts):
            raise ValueError(
                f"submit got {len(prompts)} prompts but {len(cond_scales)} cond_scales / "
                f"{len(negative_prompts)} negative_prompts"
            )
        pendings = [_Pending(p, cond_scale=s, negative_prompt=ng) for p, s, ng in zip(prompts, cond_scales, negative_prompts)]
        for p in pendings:
            self._queues["generate"].put(p)
        return pendings

    def submit_edit(self, prompts, sources, masks, cond_scales=None) -> List[_Pending]:
        if cond_scales is None:
            cond_scales = [None] * len(prompts)
        if not len(sources) == len(masks) == len(cond_scales) == len(prompts):
            raise ValueError(
                f"submit_edit got {len(prompts)} prompts but {len(sources)} sources / {len(masks)} masks / "
                f"{len(cond_scales)} cond_scales (zip would silently drop the excess)"
            )
        pendings = [_Pending(p, source=s, mask=m, cond_scale=c) for p, s, m, c in zip(prompts, sources, masks, cond_scales)]
        for p in pendings:
            self._queues["edit"].put(p)
        return pendings

    def _collect(self) -> Tuple[str, List[_Pending]]:
        """Wait for the first request of either kind, then fill the batch
        from the same kind for up to max_wait."""
        first = kind = None
        deadline_poll = time.monotonic() + 0.1
        while first is None:
            for i in range(len(self._kinds)):
                k = self._kinds[(self._rr + i) % len(self._kinds)]
                try:
                    first = self._queues[k].get_nowait()
                except queue.Empty:
                    continue
                kind = k
                # the other kind polls first next time
                self._rr = (self._rr + i + 1) % len(self._kinds)
                break
            if first is None:
                if time.monotonic() >= deadline_poll or self._stop.is_set():
                    return "", []
                time.sleep(0.005)
        q = self._queues[kind]
        batch = [first]
        deadline = time.monotonic() + self.max_wait
        while len(batch) < self.pipeline.batch_size:
            remaining = deadline - time.monotonic()
            try:
                # past the deadline the batch goes out, but takes what is ready
                batch.append(q.get_nowait() if remaining <= 0 else q.get(timeout=remaining))
            except queue.Empty:
                break
        return kind, batch

    def _scales(self, batch: List[_Pending]):
        """Per-row scales when any request set one (the default for the
        rest); all-default batches keep the pipeline's own scale."""
        if all(p.cond_scale is None for p in batch):
            return {}
        default = self.pipeline.cond_scale
        return {"cond_scale": [default if p.cond_scale is None else p.cond_scale for p in batch]}

    def _serve(self, kind: str, batch: List[_Pending]) -> None:
        kw = self._scales(batch)
        if kind == "edit":
            images = self.pipeline.edit(
                np.stack([p.source for p in batch]), np.stack([p.mask for p in batch]), [p.prompt for p in batch], **kw
            )
        else:
            if any(p.negative_prompt is not None for p in batch):
                kw["negative_prompts"] = [p.negative_prompt for p in batch]
            images = self.pipeline([p.prompt for p in batch], **kw)
        if len(images) != len(batch):
            raise RuntimeError(f"the pipeline returned {len(images)} images for a batch of {len(batch)}")
        for p, im in zip(batch, images):
            p.image = np.asarray(im)

    def _run(self):
        while not self._stop.is_set():
            kind, batch = self._collect()
            if not batch:
                continue
            started = time.monotonic()
            waits = [started - p.enqueued for p in batch]
            self.stats["queue_wait_seconds"] += sum(waits)
            self.stats["queue_wait_max_seconds"] = max(self.stats["queue_wait_max_seconds"], *waits)
            try:
                self._serve(kind, batch)
            except Exception as e:  # sent to every waiter of the batch
                for p in batch:
                    p.error = e
            finally:
                self.stats["batches"] += 1
                self.stats["images"] += len(batch)
                self.stats["batch_fill_sum"] += len(batch)
                if len(batch) > 1:
                    self.stats["coalesced_batches"] += 1
                for p in batch:
                    if p.image is None and p.error is None:  # a BaseException is on its way up
                        p.error = RuntimeError("the batch worker stopped")
                    p.event.set()


def _png_b64(image: np.ndarray) -> str:
    return base64.b64encode(encode_png(image)).decode("ascii")


def _b64_image(b64: str) -> np.ndarray:
    return decode_png(base64.b64decode(b64), mode="RGB")


def _b64_mask(b64: str) -> np.ndarray:
    return decode_png(base64.b64decode(b64), mode="L") > 127


class _BadRequest(ValueError):
    """A request that the handler answers with 400 and this message."""


class GenerateServer:
    """Threaded HTTP server over a `GeneratePipeline` (module docstring)."""

    def __init__(
        self,
        pipeline,
        host: str = "127.0.0.1",
        port: int = 8000,
        max_wait_ms: float = 50.0,
        request_timeout_s: float = 600.0,
        warmup=False,
    ):
        """`warmup`: False (none), True (the "generate" surface), "all", or
        the surfaces to warm (`GeneratePipeline.WARMUP_SURFACES`). Warm every
        surface the deployment serves, or its first live request pays the
        first-call costs."""
        self.pipeline = pipeline
        self.batcher = DynamicBatcher(pipeline, max_wait_ms=max_wait_ms)
        self.request_timeout_s = request_timeout_s
        self._warm = False
        self._warmup_on_start = warmup
        self._httpd = ThreadingHTTPServer((host, port), self._handler_class())
        self._serve_thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self):
        if self._warmup_on_start:
            self.pipeline.warmup(("generate",) if self._warmup_on_start is True else self._warmup_on_start)
            self._warm = True
        self.batcher.start()
        self._serve_thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._serve_thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self.batcher.stop()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)

    # -- request handling -------------------------------------------------

    def _await(self, pendings: List[_Pending]) -> List[str]:
        images = []
        for p in pendings:
            if not p.event.wait(timeout=self.request_timeout_s):
                raise TimeoutError(f"generation timed out after {self.request_timeout_s}s (warm the server first)")
            if p.error is not None:
                raise p.error
            images.append(_png_b64(p.image))
        self._warm = True
        return images

    def _parse(self, path: str, req: dict):
        """Validate a POST body -> (prompts, scales, negatives, edit payload);
        raises _BadRequest with the reason."""
        prompts = req.get("prompts")
        if isinstance(prompts, str):
            prompts = [prompts]
        if not prompts or not all(isinstance(p, str) for p in prompts):
            raise _BadRequest('body must be {"prompts": ["...", ...]}')
        n = len(prompts)
        # a number for every prompt of the request, or one a prompt
        scales = req.get("cond_scale")
        if scales is not None:
            if isinstance(scales, (int, float)):
                scales = [scales] * n
            if not (isinstance(scales, list) and len(scales) == n and all(isinstance(x, (int, float)) for x in scales)):
                raise _BadRequest("cond_scale must be a number or one number per prompt")
            scales = [float(x) for x in scales]
        # a string for every prompt, or one entry a prompt (null: none)
        negs = req.get("negative_prompt")
        if negs is not None:
            if isinstance(negs, str):
                negs = [negs] * n
            if not (isinstance(negs, list) and len(negs) == n and all(x is None or isinstance(x, str) for x in negs)):
                raise _BadRequest("negative_prompt must be a string or one entry (string or null) per prompt")
            if all(x is None for x in negs):
                negs = None
        if path != "/edit":
            return prompts, scales, negs, None
        if negs is not None:
            raise _BadRequest("negative_prompt is not supported on /edit (generate only)")
        srcs, masks = req.get("images") or [], req.get("masks") or []
        if not len(srcs) == len(masks) == n:
            raise _BadRequest(
                "edit needs equal-length prompts, images (b64 PNG) and masks (b64 grayscale PNG, >127 = regenerate)"
            )
        sources = [_b64_image(s) for s in srcs]
        edit_masks = [_b64_mask(m) for m in masks]
        # checked before enqueuing: a wrong size would fail in the worker's
        # np.stack and fail every request coalesced with it
        size = self.pipeline.image_size
        for i, (s, m) in enumerate(zip(sources, edit_masks)):
            if s.shape != (size, size, 3):
                raise _BadRequest(f"images[{i}] is {s.shape[1]}x{s.shape[0]}, the pipeline serves {size}x{size}")
            if m.shape != (size, size):
                raise _BadRequest(f"masks[{i}] is {m.shape[1]}x{m.shape[0]}, expected {size}x{size}")
        return prompts, scales, None, (sources, edit_masks)

    def _handler_class(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    pipe = server.pipeline
                    self._reply(
                        200,
                        {
                            "ok": True,
                            "warm": server._warm,
                            "warm_surfaces": sorted(getattr(pipe, "warm_surfaces", ())),
                            "batch_size": pipe.batch_size,
                            "image_size": pipe.image_size,
                        },
                    )
                elif self.path == "/stats":
                    stats = dict(server.batcher.stats)
                    if stats["batches"]:
                        stats["avg_batch_fill"] = stats["batch_fill_sum"] / stats["batches"]
                    stats["pipeline"] = dict(server.pipeline.stats)
                    stats["backend_compiles"] = backend_compile_count()
                    self._reply(200, stats)
                else:
                    self._reply(404, {"error": "not found"})

            def do_POST(self):
                if self.path not in ("/generate", "/edit"):
                    self._reply(404, {"error": "not found"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    try:
                        prompts, scales, negs, edit = server._parse(self.path, req)
                    except _BadRequest as e:
                        self._reply(400, {"error": str(e)})
                        return
                    if edit is not None:
                        pendings = server.batcher.submit_edit(prompts, *edit, scales)
                    else:
                        pendings = server.batcher.submit(prompts, scales, negs)
                    self._reply(200, {"images": server._await(pendings)})
                except TimeoutError as e:
                    self._reply(503, {"error": str(e)})
                except BrokenPipeError:
                    pass  # the client went away mid-reply
                except Exception as e:  # a failed batch: the error's text to the client
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        return Handler
