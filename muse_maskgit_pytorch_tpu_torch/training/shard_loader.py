"""ctypes binding of the native C++ token-shard loader (the port's own copy
of `muse_maskgit_pytorch_tpu/training/shard_loader.py`, which needs only
numpy and ctypes but whose import runs the JAX package's `__init__`).

`native/shard_loader.cpp` at the root of the checkout is built with g++ at
first use into `build/torch_kernels/`, beside the CUDA kernels, under a name
that hashes its source. Also here: the shard writer and the caption
sidecars, in the JAX package's file formats (shards written by either
package read in the other).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

_MAGIC = b"MUSETOK1"
_MAGIC_V2 = b"MUSETOK2"
_REPO_ROOT = Path(__file__).resolve().parents[2]
_SRC = _REPO_ROOT / "native" / "shard_loader.cpp"
_BUILD_DIR = _REPO_ROOT / "build" / "torch_kernels"

_build_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def _build_lib() -> Path:
    code = _SRC.read_bytes()
    out = _BUILD_DIR / f"libshard_loader-{hashlib.sha256(code).hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", str(_SRC), "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {_SRC.name} (exit {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _lib_handle
    with _build_lock:
        if _lib_handle is None:
            lib = ctypes.CDLL(str(_build_lib()))
            lib.msl_open.restype = ctypes.c_void_p
            lib.msl_open.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_uint64,
                ctypes.c_int,
                ctypes.c_int,
                ctypes.c_int64,
            ]
            lib.msl_delivered.restype = ctypes.c_int64
            lib.msl_delivered.argtypes = [ctypes.c_void_p]
            lib.msl_epoch.restype = ctypes.c_int64
            lib.msl_epoch.argtypes = [ctypes.c_void_p]
            lib.msl_seq_len.restype = ctypes.c_int64
            lib.msl_seq_len.argtypes = [ctypes.c_void_p]
            lib.msl_grid_h.restype = ctypes.c_int64
            lib.msl_grid_h.argtypes = [ctypes.c_void_p]
            lib.msl_grid_w.restype = ctypes.c_int64
            lib.msl_grid_w.argtypes = [ctypes.c_void_p]
            lib.msl_num_seqs.restype = ctypes.c_int64
            lib.msl_num_seqs.argtypes = [ctypes.c_void_p]
            lib.msl_batches_per_epoch.restype = ctypes.c_int64
            lib.msl_batches_per_epoch.argtypes = [ctypes.c_void_p]
            lib.msl_next_batch.restype = ctypes.c_int
            lib.msl_next_batch.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
            ]
            lib.msl_next_batch_meta.restype = ctypes.c_int
            lib.msl_next_batch_meta.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.msl_close.restype = None
            lib.msl_close.argtypes = [ctypes.c_void_p]
            _lib_handle = lib
    return _lib_handle


def write_shard(
    path,
    tokens: np.ndarray,
    captions: Optional[Sequence[str]] = None,
    grid: Optional[tuple] = None,
) -> None:
    """tokens: (num_seqs, seq_len) int32 -> binary shard file. `captions`
    (one per sequence) additionally writes the `<path>.captions` sidecar.

    `grid=(fh, fw)`: token-grid metadata (v2 header) for aspect-bucketed
    rectangular training — the leading fh*fw ids of each row reshape to that
    grid (rows may carry extra trailing ids, e.g. paired super-res cond ids).
    Without it the v1 header is written (square isqrt contract downstream)."""
    tokens = np.ascontiguousarray(tokens, np.int32)
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be (num_seqs, seq_len), got shape {tokens.shape}")
    if grid is not None:
        fh, fw = int(grid[0]), int(grid[1])
        if fh <= 0 or fw <= 0 or fh * fw > tokens.shape[1]:
            raise ValueError(f"grid {grid} does not fit rows of {tokens.shape[1]} ids")
    with open(path, "wb") as f:
        f.write(_MAGIC if grid is None else _MAGIC_V2)
        f.write(np.int64(tokens.shape[0]).tobytes())
        f.write(np.int64(tokens.shape[1]).tobytes())
        if grid is not None:
            f.write(np.int64(fh).tobytes())
            f.write(np.int64(fw).tobytes())
        f.write(tokens.tobytes())
    if captions is not None:
        if len(captions) != tokens.shape[0]:
            raise ValueError("one caption per sequence")
        write_caption_file(caption_path_for(path), captions)


def read_shard_header(path) -> dict:
    """Cheap header peek (no mmap): {num_seqs, seq_len, grid} — `grid` is
    (fh, fw) for v2 shards, None for v1. Used to group shard lists into
    same-static-shape buckets before opening loaders."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic not in (_MAGIC, _MAGIC_V2):
            raise ValueError(f"{path}: not a MUSETOK shard")
        num_seqs, seq_len = np.frombuffer(f.read(16), np.int64)
        grid = None
        if magic == _MAGIC_V2:
            fh, fw = np.frombuffer(f.read(16), np.int64)
            grid = (int(fh), int(fw))
    return {"num_seqs": int(num_seqs), "seq_len": int(seq_len), "grid": grid}


_CAPTION_MAGIC = b"MUSECAP1"


def caption_path_for(shard_path) -> Path:
    return Path(str(shard_path) + ".captions")


def write_caption_file(path, captions: Sequence[str]) -> None:
    """Length-prefixed utf-8 caption sidecar: magic, int64 n, int64[n+1]
    byte offsets into the blob, then the concatenated utf-8 blob. Offsets
    (not newline splits) so captions may contain any character."""
    blobs = [c.encode("utf-8") for c in captions]
    offsets = np.zeros(len(blobs) + 1, np.int64)
    np.cumsum([len(b) for b in blobs], out=offsets[1:])
    with open(path, "wb") as f:
        f.write(_CAPTION_MAGIC)
        f.write(np.int64(len(blobs)).tobytes())
        f.write(offsets.tobytes())
        f.write(b"".join(blobs))


class CaptionStore:
    """Random access to per-sequence captions across shards, addressed by the
    loader's (shard ordinal, row) provenance. Offset tables load eagerly
    (16 bytes/caption); text blobs are read lazily per lookup."""

    def __init__(self, shard_paths: Sequence):
        self._paths = [caption_path_for(p) for p in shard_paths]
        self._offsets, self._files = [], []
        for p in self._paths:
            f = open(p, "rb")  # held open: lookups seek the page cache
            self._files.append(f)
            if f.read(8) != _CAPTION_MAGIC:
                raise ValueError(f"{p}: not a caption sidecar")
            n = int(np.frombuffer(f.read(8), np.int64)[0])
            self._offsets.append(np.frombuffer(f.read(8 * (n + 1)), np.int64))
        self._blob_start = [8 + 8 + 8 * len(o) for o in self._offsets]

    def lookup(self, shard_idx: np.ndarray, row_idx: np.ndarray) -> list:
        out = []
        for si, ri in zip(shard_idx.tolist(), row_idx.tolist()):
            off = self._offsets[si]
            start, end = int(off[ri]), int(off[ri + 1])
            f = self._files[si]
            f.seek(self._blob_start[si] + start)
            out.append(f.read(end - start).decode("utf-8"))
        return out

    def close(self):
        for f in self._files:
            f.close()
        self._files = []


class ShardLoader:
    """Shuffled, prefetched batches of token sequences from mmap'd shards.

    Deterministic resume: `state_dict()` returns the consumed-batch count;
    reconstructing with the SAME (paths, batch_size, seed, process_*) args
    plus `skip_batches=state["delivered_batches"]` fast-forwards the shuffle
    stream (per-epoch reshuffles replayed in C++) so training continues the
    exact data order (bit-identical with num_threads=1; with more prefetch
    threads, delivery order may interleave exactly as in a live run).
    """

    def __init__(
        self,
        paths: Sequence,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 2,
        drop_last: bool = True,
        process_index: int = 0,
        process_count: int = 1,
        skip_batches: int = 0,
    ):
        # multi-host data parallelism: each host mmaps only its round-robin
        # slice of the shard list (and offsets its shuffle seed) so the
        # global batch is disjoint across hosts
        if process_count > 1:
            paths = [p for i, p in enumerate(sorted(map(str, paths)))
                     if i % process_count == process_index]
            if not paths:
                raise ValueError("fewer shards than processes")
            seed = seed * process_count + process_index
        self._lib = _lib()
        c_paths = (ctypes.c_char_p * len(paths))(
            *[str(p).encode() for p in paths]
        )
        self._h = self._lib.msl_open(
            c_paths, len(paths), batch_size, seed, num_threads, int(drop_last),
            int(skip_batches),
        )
        if not self._h:
            raise ValueError(f"failed to open shards: {list(paths)}")
        self.batch_size = batch_size
        self.seq_len = int(self._lib.msl_seq_len(self._h))
        gh, gw = int(self._lib.msl_grid_h(self._h)), int(self._lib.msl_grid_w(self._h))
        #: (fh, fw) token grid from the v2 header; None for v1 shards
        self.grid = (gh, gw) if gh > 0 else None
        self.num_seqs = int(self._lib.msl_num_seqs(self._h))
        self.batches_per_epoch = int(self._lib.msl_batches_per_epoch(self._h))
        self._buf = np.empty((batch_size, self.seq_len), np.int32)
        self._shard_buf = np.empty((batch_size,), np.int32)
        self._row_buf = np.empty((batch_size,), np.int64)
        self._paths_used = [str(p) for p in paths]

    @property
    def delivered_batches(self) -> int:
        """Batches handed to the consumer since open (includes skip_batches)."""
        return int(self._lib.msl_delivered(self._h))

    @property
    def epoch(self) -> int:
        """Zero-based shuffle epoch of the next claim (monitoring)."""
        return int(self._lib.msl_epoch(self._h))

    def state_dict(self) -> dict:
        """Resume token — save next to the train-state checkpoint and pass
        `skip_batches=state["delivered_batches"]` to a new loader constructed
        with identical (paths, batch_size, seed, process_*) arguments."""
        return {"delivered_batches": self.delivered_batches}

    def next_batch(self) -> np.ndarray:
        rows = self._lib.msl_next_batch(
            self._h, self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        )
        if rows == 0:
            raise StopIteration
        return self._buf[:rows].copy()

    def next_batch_meta(self):
        """(tokens, shard_idx, row_idx) — provenance arrays index the
        loader's (post-process-slice) shard list, for sidecar joins."""
        rows = self._lib.msl_next_batch_meta(
            self._h,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._shard_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self._row_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
        if rows == 0:
            raise StopIteration
        return (
            self._buf[:rows].copy(),
            self._shard_buf[:rows].copy(),
            self._row_buf[:rows].copy(),
        )

    def captioned(self) -> "Iterator":
        """Yield (tokens, list[str]) batches by joining the `<shard>.captions`
        sidecars (written by `write_shard(..., captions=)`)."""
        store = CaptionStore(self._paths_used)
        try:
            while True:
                try:
                    tokens, si, ri = self.next_batch_meta()
                except StopIteration:
                    return  # PEP 479: StopIteration may not cross a generator
                yield tokens, store.lookup(si, ri)
        finally:
            # the store holds one open fd per sidecar — release them when the
            # generator is closed/abandoned, not at process exit
            store.close()

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            try:
                batch = self.next_batch()
            except StopIteration:
                return  # PEP 479: StopIteration may not cross a generator
            yield batch

    def close(self):
        if self._h:
            self._lib.msl_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
