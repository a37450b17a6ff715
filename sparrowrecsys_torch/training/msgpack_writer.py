"""A pure-Python writer of the msgpack files flax reads.

The counterpart of `msgpack_reader.py`: `packb` encodes a tree as
`flax.serialization.to_bytes` does (msgpack-python's `packb` with flax's
ndarray extension), so the JAX package's `checkpoint.load_latest`
restores what the port exports. It packs:

- dicts: maps with their keys sorted, as flax's tree map leaves them,
  except an `OrderedDict`, which keeps its order (flax writes a
  NamedTuple's fields and a list's indices in order);
- str, None (nil: a `master_big` entry), ints (the smallest msgpack int
  that holds them), floats (float64), bytes, and lists and tuples;
- numpy arrays and torch tensors as ext code 1: a packed
  `(shape, dtype name, raw bytes in C order)` triple. bfloat16 tensors,
  which numpy lacks, are written as their raw 2-byte words.

Leaves above 2**30 bytes, which flax splits into chunks, raise
`ValueError`; no export of the repo reaches them.
"""

from __future__ import annotations

import struct
from collections import OrderedDict
from typing import Any, List

import numpy as np

_EXT_NDARRAY = 1
_MAX_LEAF_BYTES = 2 ** 30


def _int(out: List[bytes], v: int) -> None:
    if 0 <= v <= 0x7F:
        out.append(struct.pack(">B", v))
    elif -32 <= v < 0:
        out.append(struct.pack(">b", v))
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(struct.pack(">B", code) + struct.pack(fmt, v))
                return
        raise ValueError(f"int {v} does not fit msgpack")


def _sized(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: fix form below fix_max, else 8/16/32-bit forms
    (`codes` maps a struct format to its type byte; None skips a form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack(">B", fix | n))
        return
    for fmt, top in ((">B", 0xFF), (">H", 0xFFFF), (">I", 0xFFFFFFFF)):
        code = codes.get(fmt)
        if code is not None and n <= top:
            out.append(struct.pack(">B", code) + struct.pack(fmt, n))
            return
    raise ValueError(f"length {n} does not fit msgpack")


def _array_payload(value: Any) -> bytes:
    """flax's ext-1 payload: packb((shape, dtype name, raw bytes))."""
    if isinstance(value, np.ndarray):
        arr = np.asarray(value, order="C")  # keeps a 0-d leaf 0-d (a step count)
        shape, name, raw = arr.shape, arr.dtype.name, arr.tobytes("C")
    else:  # a torch tensor
        import torch

        t = value.detach().cpu().contiguous()
        shape = tuple(t.shape)
        if t.dtype == torch.bfloat16:
            name, raw = "bfloat16", t.view(torch.int16).numpy().tobytes("C")
        else:
            arr = t.numpy()
            name, raw = arr.dtype.name, arr.tobytes("C")
    if len(raw) > _MAX_LEAF_BYTES:
        raise ValueError("leaves above 2**30 bytes (flax's chunked form) are not supported")
    return packb((list(shape), name, raw))


def _pack(out: List[bytes], v: Any) -> None:
    if v is None:
        out.append(b"\xc0")
    elif isinstance(v, bool):
        raise TypeError("bool is not part of a flax param tree")
    elif isinstance(v, (int, np.integer)):
        _int(out, int(v))
    elif isinstance(v, (float, np.floating)):
        out.append(b"\xcb" + struct.pack(">d", float(v)))
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _sized(out, len(data), 0xA0, 32, {">B": 0xD9, ">H": 0xDA, ">I": 0xDB})
        out.append(data)
    elif isinstance(v, (bytes, bytearray)):
        _sized(out, len(v), None, 0, {">B": 0xC4, ">H": 0xC5, ">I": 0xC6})
        out.append(bytes(v))
    elif isinstance(v, dict):
        _sized(out, len(v), 0x80, 16, {">H": 0xDE, ">I": 0xDF})
        for k in (v if isinstance(v, OrderedDict) else sorted(v)):
            _pack(out, k)
            _pack(out, v[k])
    elif isinstance(v, (list, tuple)):
        _sized(out, len(v), 0x90, 16, {">H": 0xDC, ">I": 0xDD})
        for x in v:
            _pack(out, x)
    elif isinstance(v, np.ndarray) or type(v).__module__.startswith("torch"):
        payload = _array_payload(v)
        n = len(payload)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            out.append(struct.pack(">Bb", fixext[n], _EXT_NDARRAY))
        else:
            _sized(out, n, None, 0, {">B": 0xC7, ">H": 0xC8, ">I": 0xC9})
            out.append(struct.pack(">b", _EXT_NDARRAY))
        out.append(payload)
    else:
        raise TypeError(f"cannot pack {type(v).__name__}")


def packb(value: Any) -> bytes:
    """Encode one msgpack document."""
    out: List[bytes] = []
    _pack(out, value)
    return b"".join(out)
