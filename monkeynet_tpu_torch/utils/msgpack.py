"""A reader of the msgpack files the JAX package writes, in pure Python.

The JAX package saves its checkpoints with `flax.serialization.
msgpack_serialize` (monkeynet_tpu/utils/checkpoint.py); the port reads them
without flax or the msgpack package. `msgpack_restore` returns what
`flax.serialization.msgpack_restore` returns for the same bytes:

- nil, bool, ints of every width, float32 and float64 (Python floats), str8 /
  16 / 32 (str), bin8 / 16 / 32 (bytes), arrays (lists) and maps (dicts);
- flax's ext types: 1, an ndarray packed as msgpack (shape, dtype name,
  bytes in C order); 2, a Python complex packed as (real, imag); 3, a numpy
  scalar packed as a 0-d ndarray;
- a dict {'__msgpack_chunked_array__': True, 'shape', 'chunks'}, which flax
  writes for an array of more than 2**30 bytes, joined back into the array.

Arrays come out as writable numpy arrays that own a copy of their bytes. A
'bfloat16' array, which numpy cannot name, comes out as a torch.bfloat16
tensor. An unknown type or ext code raises ValueError with its byte offset.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3

# type code -> (struct format of the fixed-width value, its size)
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# type code -> size of the length field that follows it
_STR = {0xD9: 1, 0xDA: 2, 0xDB: 4}
_BIN = {0xC4: 1, 0xC5: 2, 0xC6: 4}
_ARRAY = {0xDC: 2, 0xDD: 4}
_MAP = {0xDE: 2, 0xDF: 4}
_EXT = {0xC7: 1, 0xC8: 2, 0xC9: 4}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
_LENGTH = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes, base: int = 0):
        self.data = memoryview(data)
        self.pos = 0
        self.base = base  # offset of `data` in the file, for error messages

    def take(self, n: int) -> memoryview:
        start = self.pos
        if start + n > len(self.data):
            raise ValueError(f"msgpack: truncated at byte {self.base + start}")
        self.pos = start + n
        return self.data[start:self.pos]

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LENGTH[size], size)

    def value(self) -> Any:
        at = self.base + self.pos
        code = self.unpack(">B", 1)
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _FIXED:
            return self.unpack(*_FIXED[code])
        if code in _STR:
            return str(self.take(self.length(_STR[code])), "utf-8")
        if code in _BIN:
            return bytes(self.take(self.length(_BIN[code])))
        if code in _ARRAY:
            return [self.value() for _ in range(self.length(_ARRAY[code]))]
        if code in _MAP:
            return self.map(self.length(_MAP[code]))
        if code in _EXT or code in _FIXEXT:
            n = self.length(_EXT[code]) if code in _EXT else _FIXEXT[code]
            ext = self.unpack(">b", 1)
            payload_at = self.base + self.pos
            return _ext(ext, self.take(n), at, payload_at)
        raise ValueError(f"msgpack: unknown type code 0x{code:02x} at byte {at}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _ndarray(payload: memoryview, at: int, payload_at: int):
    reader = _Reader(payload, payload_at)
    parts = reader.value()
    if not (isinstance(parts, list) and len(parts) == 3):
        raise ValueError(f"msgpack: ndarray ext at byte {at} is not (shape, dtype, bytes)")
    shape, name, buffer = parts
    shape = tuple(shape)
    if name == "bfloat16":
        import torch

        if not buffer:
            return torch.empty(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(buffer), dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: memoryview, at: int, payload_at: int) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(payload, at, payload_at)
    if code == _EXT_NPSCALAR:
        return _ndarray(payload, at, payload_at)[()]
    if code == _EXT_COMPLEX:
        real, imag = _Reader(payload, payload_at).value()
        return complex(real, imag)
    raise ValueError(f"msgpack: unknown ext code {code} at byte {at}")


def _by_index(d: dict) -> Tuple:
    return tuple(d[str(i)] for i in range(len(d)))


def _unchunk(tree: Any) -> Any:
    """flax's chunked arrays joined back, through nested dicts."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        return np.concatenate(_by_index(tree["chunks"])).reshape(_by_index(tree["shape"]))
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes) -> Any:
    """The tree that `flax.serialization.msgpack_restore(data)` gives."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"msgpack: {len(reader.data) - reader.pos} bytes after the value "
                         f"at byte {reader.pos}")
    return _unchunk(tree)


def read_msgpack(path: str) -> Any:
    with open(path, "rb") as f:
        return msgpack_restore(f.read())
