"""A pure-Python reader for the msgpack files flax writes.

The JAX package exports params with `flax.serialization.to_bytes`
(`sparrowrecsys_tpu/training/checkpoint.py:49`). Neither flax nor the
`msgpack` package is a dependency of the port, so this module decodes
the subset of msgpack those files use:

- maps, arrays, strings, bin, ints, floats, nil and bool;
- ext code 1 (flax's ndarray): a packed `(shape, dtype name, raw bytes)`
  triple, C order.

Anything else raises `ValueError`: other ext codes (flax's complex and
numpy-scalar leaves) and flax's `__msgpack_chunked_array__` form for
leaves above 2**30 bytes, which no export of the repo reaches.

Arrays come back as numpy arrays, except bfloat16, which numpy lacks:
those come back as `torch.bfloat16` tensors, bit for bit.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_CHUNKED_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {
            0xC4: (">B", self.bin), 0xC5: (">H", self.bin), 0xC6: (">I", self.bin),
            0xD9: (">B", self.str), 0xDA: (">H", self.str), 0xDB: (">I", self.str),
            0xDC: (">H", self.array), 0xDD: (">I", self.array),
            0xDE: (">H", self.map), 0xDF: (">I", self.map),
        }
        if b in sized:
            fmt, read = sized[b]
            return read(self.unpack(fmt))
        scalars = {
            0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in scalars:
            return self.unpack(scalars[b])
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def bin(self, n: int) -> bytes:
        return bytes(self.take(n))

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        if _CHUNKED_KEY in out:
            raise ValueError(
                "flax chunked-array leaf (> 2**30 bytes) is not supported"
            )
        return out

    def ext(self, code: int, n: int) -> Any:
        payload = bytes(self.take(n))
        if code != _EXT_NDARRAY:
            raise ValueError(f"unsupported msgpack ext code {code}")
        shape, dtype, raw = _Reader(payload).value()
        return _ndarray(tuple(shape), dtype, raw)


def _ndarray(shape: Tuple[int, ...], dtype: str, raw: bytes):
    if dtype == "bfloat16":
        import torch

        return torch.frombuffer(bytearray(raw), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()


def unpackb(data: bytes) -> Any:
    """Decode one msgpack document (the whole of `data`)."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack document")
    return out
