"""The subset of MessagePack that `flax.serialization.msgpack_serialize`
writes, in pure Python and numpy (the GPU machine has no `msgpack` and no
`flax`).

Types: maps, arrays, str, bin, ints, floats, nil, bool, and flax's ext type
`ndarray` (1: a packed `(shape, dtype name, raw bytes)`), which is what a
module's state holds (flax's complex and numpy-scalar ext types are not read
or written here). Leaves over `MAX_CHUNK_SIZE` bytes travel in flax's
chunked form `{"__msgpack_chunked_array__": True, "shape": {...}, "chunks":
{...}}`; `unpackb` joins them again.

`unpackb` reads an array leaf as `np.frombuffer` over a slice of the input,
so the leaf is not copied (the arrays are read-only views of the buffer). A
`bfloat16` leaf, which numpy cannot hold without `ml_dtypes`, becomes a
`torch.bfloat16` tensor with the same bits. `packb` writes what flax's
encoder writes, byte for byte: the smallest int form, floats as f64, str8 for
str, bin for bytes; numpy arrays and `torch` tensors (bf16 included) as the
ndarray ext type.
"""

from __future__ import annotations

import struct
import sys
from typing import Any, Iterator, List, Union

import numpy as np

EXT_NDARRAY = 1
# flax's limit per leaf, below the 2**31 - 1 bytes msgpack's C packer takes
MAX_CHUNK_SIZE = 2**30
CHUNKED = "__msgpack_chunked_array__"

_Buffer = Union[bytes, bytearray, memoryview]


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: _Buffer):
        self.buf = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        start = self.pos
        end = start + n
        if end > len(self.buf):
            raise ValueError(f"msgpack data ends at byte {len(self.buf)}, an object needs up to {end}")
        self.pos = end
        return self.buf[start:end]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self._array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        fixed = _FIXED.get(b)
        if fixed is not None:
            return self.unpack(fixed)
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.unpack(_LEN[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.unpack(_LEN[b])
            return self._ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self._ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):  # str 8 / 16 / 32
            return self._str(self.unpack(_LEN[b]))
        if b in (0xDC, 0xDD):  # array 16 / 32
            return self._array(self.unpack(_LEN[b]))
        if b in (0xDE, 0xDF):  # map 16 / 32
            return self._map(self.unpack(_LEN[b]))
        raise ValueError(f"msgpack type byte 0x{b:02x} at {self.pos - 1} is not in the subset flax writes")

    def _str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def _ext(self, code: int, n: int):
        data = self.take(n)
        if code != EXT_NDARRAY:
            raise ValueError(f"msgpack ext type {code} is not flax's ndarray")
        return _ndarray_from(data)


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {
    0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H", 0xC9: ">I",
    0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
}


def _ndarray_from(data: memoryview):
    """flax's `_ndarray_from_bytes`: the ext payload is a packed (shape,
    dtype name, raw bytes)."""
    r = _Reader(data)
    if r.take(1)[0] != 0x93:
        raise ValueError("an ndarray ext payload must be a 3-array (shape, dtype, data)")
    shape = tuple(r.read())
    name = r.read()
    tag = r.take(1)[0]
    if tag not in (0xC4, 0xC5, 0xC6):
        raise ValueError(f"an ndarray's data must be bin, got type byte 0x{tag:02x}")
    raw = r.take(r.unpack(_LEN[tag]))  # a view: the leaf is not copied
    if name == "bfloat16":
        import torch

        # one copy into a writable buffer; the bits stay as written
        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """flax's `_unchunk_array_leaves_in_place`: chunked leaves -> arrays."""
    if isinstance(tree, dict):
        if CHUNKED in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            if any(not isinstance(c, np.ndarray) for c in chunks):
                import torch

                return torch.cat([torch.as_tensor(c) for c in chunks]).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        for k, v in tree.items():
            tree[k] = _unchunk(v)
    return tree


def unpackb(data: _Buffer) -> Any:
    """Decode one msgpack object (and unchunk its chunked leaves)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes of trailing data after the msgpack object")
    return _unchunk(out)


# ---------------------------------------------------------------------------
# encoding
# ---------------------------------------------------------------------------


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -32 <= n < 0:
        return bytes((n & 0xFF,))
    if n > 0:
        for tag, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16), (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes((tag,)) + struct.pack(fmt, n)
    else:
        for tag, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)), (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes((tag,)) + struct.pack(fmt, n)
    raise OverflowError(f"int {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_limit: int, tags) -> bytes:
    """The type-and-length prefix of a str / bin / array / map / ext of n
    (`fix`: the fix-form's tag, used below `fix_limit`; 0: none)."""
    if n < fix_limit:
        return bytes((fix | n,))
    for tag, fmt, top in tags:
        if n < top:
            return bytes((tag,)) + struct.pack(fmt, n)
    raise ValueError(f"a msgpack object of {n} bytes or entries is too large")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _str(s: str) -> bytes:
    raw = s.encode("utf-8")
    return _header(len(raw), 0xA0, 32, _STR) + raw


def _ext_header(code: int, n: int) -> bytes:
    fixed = _FIXEXT.get(n)
    if fixed is not None:
        return bytes((fixed,)) + struct.pack(">b", code)
    return _header(n, 0, 0, _EXT) + struct.pack(">b", code)


def _itemsize(x) -> int:
    return x.itemsize if isinstance(x, np.ndarray) else x.element_size()


def _nbytes(x) -> int:
    return x.size * x.itemsize if isinstance(x, np.ndarray) else x.numel() * x.element_size()


def _array_parts(arr) -> List[Any]:
    """flax's `_ndarray_to_bytes` as pieces: the (shape, dtype name) header,
    then the array's own memory (no copy of a C-contiguous leaf)."""
    if isinstance(arr, np.ndarray):
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise ValueError("object and structured dtypes have no msgpack form")
        shape, name, raw = arr.shape, arr.dtype.name, np.ascontiguousarray(arr)
    else:  # a torch tensor; bf16 goes as its bits, under flax's dtype name
        import torch

        t = arr.detach().cpu().contiguous()
        shape = tuple(t.shape)
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy()
        else:
            raw = t.numpy()
            name = raw.dtype.name
    data = memoryview(raw.reshape(-1).view(np.uint8))
    head = b"\x93" + _header(len(shape), 0x90, 16, _ARRAY) + b"".join(_int(d) for d in shape)
    head += _str(name) + _header(len(data), 0, 0, _BIN)
    return [head, data]


def _chunk(arr) -> dict:
    """flax's `_chunk`: a leaf over MAX_CHUNK_SIZE bytes as flat chunks."""
    flat = arr.reshape(-1)
    step = max(1, MAX_CHUNK_SIZE // _itemsize(arr))
    return {
        CHUNKED: True,
        "shape": {str(i): int(d) for i, d in enumerate(arr.shape)},
        "chunks": {str(i): flat[s : s + step] for i, s in enumerate(range(0, flat.shape[0], step))},
    }


def iter_packb(obj: Any) -> Iterator[Any]:
    """`packb` as a stream of byte pieces (bytes or memoryviews), so a large
    tree can go to a file without first being joined in memory."""
    if obj is None:
        yield b"\xc0"
    elif obj is True:
        yield b"\xc3"
    elif obj is False:
        yield b"\xc2"
    elif type(obj) is int:
        yield _int(obj)
    elif type(obj) is float:
        yield b"\xcb" + struct.pack(">d", obj)
    elif type(obj) is str:
        yield _str(obj)
    elif type(obj) in (bytes, bytearray):
        yield _header(len(obj), 0, 0, _BIN) + bytes(obj)
    elif type(obj) is dict:
        yield _header(len(obj), 0x80, 16, _MAP)
        for k, v in obj.items():
            yield from iter_packb(k)
            yield from iter_packb(v)
    elif type(obj) is list:
        yield _header(len(obj), 0x90, 16, _ARRAY)
        for v in obj:
            yield from iter_packb(v)
    elif _is_array(obj):
        if _nbytes(obj) > MAX_CHUNK_SIZE:
            yield from iter_packb(_chunk(obj))
            return
        parts = _array_parts(obj)
        yield _ext_header(EXT_NDARRAY, sum(len(p) for p in parts))
        yield from parts
    else:
        raise TypeError(f"{type(obj).__name__} is not in the msgpack subset flax writes")


def _is_array(obj) -> bool:
    # torch is looked up, not imported: a tree of numpy leaves needs no torch
    torch = sys.modules.get("torch")
    return isinstance(obj, np.ndarray) or (torch is not None and isinstance(obj, torch.Tensor))


def packb(obj: Any) -> bytes:
    """Encode `obj` as `flax.serialization.msgpack_serialize` would (leaves
    over `MAX_CHUNK_SIZE` bytes chunked)."""
    return b"".join(bytes(p) if isinstance(p, memoryview) else p for p in iter_packb(obj))
