"""Single-file module checkpoints in the JAX package's format (counterpart of
the module tier of `muse_maskgit_pytorch_tpu/utils/checkpoint.py`).

`save_module` writes a module's state as the JAX package's `save_module`
does: the JAX module's pure state dict (`utils.from_jax.to_jax_state`, the
JAX layout and names) serialized as flax's msgpack (`utils.msgpack_codec`),
through a `.tmp` file and `os.replace`. `load_module` reads such a file, from
either package, into a port module through `utils.from_jax.load_jax_state`.
Neither needs JAX, flax or the `msgpack` package. The checksum manifest
(`manifest.json` beside the file: sha256, bytes and, for a whole-module save,
each leaf's shape and dtype) has the JAX package's format, so a manifest
written by either package verifies in the other.

The train-state tier (`save_train_state`, `load_train_state`, the JAX
package's Orbax tier) keeps a trainer's whole state (parameters, optimizer
moments, EMA, step, generator state; for `VQGanVAETrainer` the generator's
and the discriminator's parameters and optimizers and the VAE's buffers,
EMA-VQ's codebook statistics among them) in torch's own format, one directory a
step, `step_XXXXXXXX/state.pt`: it is written under a temporary name and
renamed when complete, so a listed step is always a whole one. Only module
checkpoints cross between the packages.

Under a process group every rank calls the saves: the caller hands them the
whole state (a sharded trainer gathers it on every rank first), rank 0
alone writes it, and a barrier follows, so no rank reads a file before it
is renamed into place. An async save's barrier is in `wait_for_saves`,
which every rank calls at the same points.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from muse_maskgit_pytorch_tpu_torch.parallel.mesh import is_main_process
from muse_maskgit_pytorch_tpu_torch.utils import msgpack_codec
from muse_maskgit_pytorch_tpu_torch.utils.from_jax import load_jax_state, to_jax_state

MANIFEST_NAME = "manifest.json"


def _barrier() -> None:
    """Wait for every rank, under a process group."""
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _str_keys(tree):
    """msgpack forbids int map keys; nnx.List subtrees index by int."""
    if isinstance(tree, dict):
        return {str(k): _str_keys(v) for k, v in tree.items()}
    return tree


def _unstr_keys(tree):
    if isinstance(tree, dict):
        return {(int(k) if isinstance(k, str) and k.isdigit() else k): _unstr_keys(v) for k, v in tree.items()}
    return tree


def _state_tree(module: nn.Module, exclude: Sequence[str] = ()) -> Dict:
    return _str_keys({k: v for k, v in to_jax_state(module).items() if k not in exclude})


def module_state_bytes(module: nn.Module, exclude: Sequence[str] = ()) -> bytes:
    """The bytes `save_module` writes: the JAX state's msgpack."""
    return msgpack_codec.packb(_state_tree(module, exclude))


def save_module(module: nn.Module, path, exclude: Sequence[str] = ()) -> None:
    """Write `module`'s state (less the top-level subtrees in `exclude`) to
    `path`: a file the JAX package's `load_module` reads. The write goes to
    `path.tmp` and is renamed over `path`, so a crash leaves the old file or
    none, never a truncated one; a manifest beside it that lists the file is
    brought up to date. Under a process group rank 0 writes and every rank
    waits for it."""
    path = Path(path)
    if is_main_process():
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "wb") as f:
            for piece in msgpack_codec.iter_packb(_state_tree(module, exclude)):
                f.write(piece)
        os.replace(tmp, path)
        # leaves recorded only for whole-module saves: with `exclude` the file's
        # contents differ from the live module tree
        _refresh_manifest_entry(path, module if not exclude else None)
    _barrier()


def load_module(module: nn.Module, path, exclude: Sequence[str] = ()) -> List[str]:
    """Load a `save_module` file of either package into `module`, in place.

    The file is checked against a manifest beside it, if one lists it. The
    top-level subtrees named in `exclude` keep their current values. Raises
    if a parameter or buffer of `module` is missing from the file or has
    another shape; returns the file's leaves that no part of `module` took
    (e.g. a `Discriminator`'s, "discr.…", when `module` has none), by
    dotted path."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"checkpoint not found: {path}")
    data = path.read_bytes()  # read once: the leaves are views of it
    _check(path, data, _entry(path, None))  # no-op when no manifest lists the file
    restored = _unstr_keys(msgpack_codec.unpackb(data))
    tree = {k: v for k, v in restored.items() if k not in exclude}
    if exclude:
        current = to_jax_state(module)
        tree.update({k: current[k] for k in exclude if k in current})
    return load_jax_state(module, tree)


# ---------------------------------------------------------------------------
# Checksum manifest
# ---------------------------------------------------------------------------


def _manifest_key(path: Path, mpath: Path, manifest: dict) -> Optional[str]:
    """Keys are paths relative to the manifest's directory or bare names."""
    try:
        rel = str(path.resolve().relative_to(mpath.parent.resolve()))
    except ValueError:
        rel = path.name
    return rel if rel in manifest else (path.name if path.name in manifest else None)


def _refresh_manifest_entry(path: Path, module: Optional[nn.Module]) -> None:
    """Keep an adjacent manifest true after `save_module` overwrites a file
    it lists: a stale sha256 would make every later `load_module` reject the
    file. Only touches entries that already exist."""
    mpath = path.parent / MANIFEST_NAME
    if not mpath.exists():
        return
    try:
        manifest = json.loads(mpath.read_text())
    except (OSError, json.JSONDecodeError):
        return
    key = _manifest_key(path, mpath, manifest)
    if key is not None:
        write_manifest(path.parent, {key: manifest_entry(path, module)})


def manifest_entry(path, module: Optional[nn.Module] = None) -> dict:
    """sha256 and byte size of a checkpoint file, plus each leaf's shape and
    dtype, by "/"-joined path, when the source `module` is given."""
    data = Path(path).read_bytes()
    entry = {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}
    if module is not None:
        leaves = {}

        def walk(tree, prefix):
            for k, v in sorted(tree.items(), key=lambda kv: str(kv[0])):
                p = f"{prefix}/{k}" if prefix else str(k)
                if isinstance(v, dict):
                    walk(v, p)
                else:
                    leaves[p] = [list(v.shape), str(v.dtype)]

        walk(_str_keys(to_jax_state(module)), "")
        entry["leaves"] = leaves
    return entry


def write_manifest(out_dir, entries: dict) -> Path:
    """entries: {file name: manifest_entry(...)}, merged into the manifest
    of `out_dir` (written through a `.tmp` file and a rename)."""
    out = Path(out_dir) / MANIFEST_NAME
    merged = json.loads(out.read_text()) if out.exists() else {}
    merged.update(entries)
    tmp = out.with_name(out.name + ".tmp")
    tmp.write_text(json.dumps(merged, indent=1, sort_keys=True))
    os.replace(tmp, out)
    return out


def _entry(path: Path, manifest_path) -> Optional[dict]:
    """The manifest's entry for `path`, or None."""
    mpath = Path(manifest_path) if manifest_path else path.parent / MANIFEST_NAME
    if not mpath.exists():
        return None
    manifest = json.loads(mpath.read_text())
    key = _manifest_key(path, mpath, manifest)
    return manifest[key] if key is not None else None


def _check(path: Path, data: bytes, entry: Optional[dict]) -> bool:
    if entry is None:
        return False
    if len(data) != entry["bytes"]:
        raise ValueError(f"{path.name}: size {len(data)} != manifest {entry['bytes']} (truncated or wrong file)")
    digest = hashlib.sha256(data).hexdigest()
    if digest != entry["sha256"]:
        raise ValueError(
            f"{path.name}: sha256 {digest[:16]}... != manifest {entry['sha256'][:16]}... (corrupt or tampered checkpoint)"
        )
    return True


def verify_manifest(path, manifest_path=None, *, require: bool = False) -> bool:
    """Check `path` against the manifest next to it (or `manifest_path`).

    Returns True when verified; False when there is no manifest or no entry
    for the file (with `require=True` that raises instead: an unverified
    file must not be trusted). A size or sha256 mismatch raises ValueError."""
    path = Path(path)
    entry = _entry(path, manifest_path)
    if entry is None and require:
        raise ValueError(f"no manifest entry for {path.name} beside it or in {manifest_path}")
    return _check(path, path.read_bytes(), entry) if entry is not None else False


# ---------------------------------------------------------------------------
# Train-state checkpoints (torch's format, one directory a step)
# ---------------------------------------------------------------------------

STATE_NAME = "state.pt"
# a finalized step: an exact `step_<digits>` name (a save in flight or one
# that a killed process left behind has a `.tmp-...` suffix)
_STEP_RE = re.compile(r"^step_(\d+)$")
# one writer thread for the whole process, so async saves serialize against
# each other and `wait_for_saves` has one place to drain
_saver_lock = threading.Lock()
_saver: Optional[ThreadPoolExecutor] = None
_in_flight: Optional[Future] = None


def _to_host(tree: Any) -> Any:
    """A copy of `tree` whose tensors are detached host copies: the live
    tensors may change (in-place updates) while a thread writes this one."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write_step(path: Path, tree: Any) -> None:
    suffix = f"{os.getpid()}-{threading.get_ident()}"
    tmp = path.with_name(f"{path.name}.tmp-{suffix}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(tree, tmp / STATE_NAME)
    old = path.with_name(f"{path.name}.old-{suffix}")
    if path.exists():  # an earlier save of the same step: renamed away, then removed
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def wait_for_saves() -> None:
    """Block until the async save in flight (if any) is on disk; raises
    what it raised. Call before reading a just-written checkpoint and at the
    end of training (the trainer does both)."""
    _drain()
    _barrier()  # rank 0's save in flight is on disk for every rank


def _drain() -> None:
    global _in_flight
    with _saver_lock:
        fut, _in_flight = _in_flight, None
    if fut is not None:
        fut.result()


def finalized_steps(ckpt_dir) -> List[int]:
    """Sorted steps of the complete checkpoints in `ckpt_dir`."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir() if (m := _STEP_RE.match(p.name)) and p.is_dir())


def latest_step(ckpt_dir) -> Optional[int]:
    steps = finalized_steps(ckpt_dir)
    return steps[-1] if steps else None


def prune_checkpoints(ckpt_dir, keep: int, current_step: Optional[int] = None) -> None:
    """Delete all but the newest `keep` finalized checkpoints (and
    `current_step`, which may still be in flight). Counting finalized ones
    only, a save in flight never displaces a complete checkpoint."""
    if keep < 1:
        raise ValueError(f"keep must be >= 1, got {keep}")
    ckpt_dir = Path(ckpt_dir)
    steps = finalized_steps(ckpt_dir)
    retained = set(steps[-keep:])
    if current_step is not None:
        retained.add(current_step)
    for s in steps:
        if s not in retained:
            shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)


def save_train_state(ckpt_dir, step: int, tree: Dict, async_save: bool = False, keep: Optional[int] = None) -> None:
    """Write `tree` (nested dicts of tensors and numbers) as step `step` of
    `ckpt_dir`. `keep=N` keeps the newest N finalized checkpoints and this
    one. With `async_save` the save in flight (if any) is drained first,
    then the older checkpoints are pruned (this one is not finalized yet, so
    N finalized ones stay besides it), the tensors are copied to the host
    and written on a thread; `wait_for_saves()` drains it. Under a process
    group rank 0 writes and prunes; a synchronous save ends in a barrier."""
    global _saver, _in_flight
    if not is_main_process():
        if not async_save:
            _barrier()
        return
    ckpt_dir = Path(ckpt_dir).absolute()
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"step_{step:08d}"
    if not async_save:
        _write_step(path, tree)
    else:
        _drain()
    if keep is not None:
        prune_checkpoints(ckpt_dir, keep, current_step=step)
    if async_save:
        host = _to_host(tree)
        with _saver_lock:
            if _saver is None:
                _saver = ThreadPoolExecutor(max_workers=1, thread_name_prefix="train-state-save")
            _in_flight = _saver.submit(_write_step, path, host)
    else:
        _barrier()


def load_train_state(ckpt_dir, step: Optional[int] = None) -> Tuple[Dict, int]:
    """(tree, step) of step `step` of `ckpt_dir` (the latest finalized one
    when None), its tensors on the CPU."""
    ckpt_dir = Path(ckpt_dir).absolute()
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}" / STATE_NAME
    return torch.load(path, map_location="cpu", weights_only=True), step
