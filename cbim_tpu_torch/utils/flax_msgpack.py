"""A pure-Python reader of what ``flax.serialization.to_bytes`` writes: the
JAX package's ``.ckpt`` files (``cbim_tpu/training/checkpoint.py``).

It decodes the msgpack types Flax emits (maps, strings, binaries, arrays,
nil, booleans, integers, float 32/64, and the ext types) and Flax's three
ext types (``flax/serialization.py`` ``_MsgpackExtType``): 1, an ndarray,
itself a msgpack ``(shape, dtype name, C-order bytes)``; 2, a native
complex ``(real, imag)``; 3, a numpy scalar (an ndarray of shape ()).  It
rebuilds the ``{"__msgpack_chunked_array__": True, "shape", "chunks"}``
dicts Flax writes for leaves over its ``MAX_CHUNK_SIZE``.

The result is a nested dict of numpy arrays, numpy scalars, ints and
floats, as ``flax.serialization.msgpack_restore`` returns it, but for
bfloat16 leaves, which numpy cannot hold without ``ml_dtypes``: those are
read as uint16 and returned as ``torch.bfloat16`` tensors.  Nothing here
imports ``msgpack``, jax or flax; the installed ``msgpack`` of a machine
does not matter.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

#: Flax's ext type codes
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
#: the key of a chunked array leaf
CHUNKED = "__msgpack_chunked_array__"
#: msgpack's one-byte values, its sized types (the size's struct format,
#: the kind), its numbers (struct format) and its ext types (fixext: the
#: data size; ext: the size's struct format)
_SIMPLE = {0xc0: None, 0xc2: False, 0xc3: True}
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map")}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


class _Truncated(Exception):
    pass


class _Reader:
    """Decodes one msgpack object at a time from ``buf`` (a memoryview)."""

    def __init__(self, buf: memoryview):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise _Truncated
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _SIZED:
            fmt, kind = _SIZED[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            return getattr(self, kind)(n)
        if b in _NUMBERS:
            return self.unpack(_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b in _EXT:
            return self.ext(self.unpack(_EXT[b]))
        raise ValueError(f"not msgpack: byte 0x{b:02x} at offset "
                         f"{self.pos - 1}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == EXT_NDARRAY:
            return _ndarray(data)
        if code == EXT_NPSCALAR:
            arr = _ndarray(data)
            return arr if isinstance(arr, torch.Tensor) else arr[()]
        if code == EXT_COMPLEX:
            real, imag = _whole(data)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one Flax writes")


def _whole(data: memoryview):
    """The one msgpack object that fills ``data``."""
    r = _Reader(data)
    obj = r.obj()
    if r.pos != len(data):
        raise ValueError("trailing bytes after a msgpack object")
    return obj


def _ndarray(data: memoryview):
    """Flax's ndarray ext: msgpack (shape, dtype name, C-order bytes)."""
    shape, name, buf = _whole(data)
    if isinstance(name, memoryview):
        name = bytes(name).decode()
    if name == "bfloat16":
        flat = np.frombuffer(buf, dtype=np.uint16).copy()
        return torch.from_numpy(flat).view(torch.bfloat16).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    """Chunked array leaves back into arrays, anywhere in the tree (and a
    binary leaf, a view of the file's bytes while decoding, into bytes)."""
    if isinstance(tree, memoryview):
        return bytes(tree)
    if isinstance(tree, list):
        return [_unchunk(v) for v in tree]
    if not isinstance(tree, dict):
        return tree
    if tree.get(CHUNKED) is True:
        shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes):
    """The tree ``flax.serialization.to_bytes`` encoded into ``data``."""
    try:
        return _unchunk(_whole(memoryview(data)))
    except _Truncated:
        raise ValueError("truncated msgpack") from None


def read_flax_msgpack(path: str):
    """The tree of a Flax msgpack file; a truncated or non-msgpack file
    raises ValueError naming ``path``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return restore(data)
    except (ValueError, struct.error, UnicodeDecodeError, TypeError) as e:
        raise ValueError(f"{path}: not a Flax msgpack checkpoint ({e})") \
            from None
