"""Reading the JAX package's checkpoints without JAX, flax or msgpack.

A tpurec checkpoint is a pickle envelope (``Trainer.save_checkpoint``)
whose ``"state"`` holds the TrainState as flax msgpack bytes
(``flax.serialization.to_bytes``).  :func:`msgpack_restore` is a small
reader of exactly that format, so the port's serving entry points load a
checkpoint on a machine that has only torch and numpy:

- plain msgpack (maps, arrays, strings, binary, ints, floats, nil, bools);
- ext type 1, an ndarray packed as msgpack ``(shape, dtype name,
  C-order bytes)``; ext type 3, a numpy scalar packed the same way;
  ext type 2, a complex number;
- arrays over 2**30 bytes, stored as ``{"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}}`` and joined back here.

numpy has no bfloat16, so a bfloat16 array comes back as the float32 array
of the same values (exact).  Arrays are read-only views of the input bytes.

The layout-version guard is the JAX package's (``train/checkpoint.py:35-45``):
the fused table's row order is ``smallfirst-v2`` in both packages.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

# Generation tag of the fused embedding table's row layout
# (tpurec_torch.nn.core.EmbeddingLayout, the same as the JAX package's).
EMBED_LAYOUT_VERSION = "smallfirst-v2"


def check_embed_layout_version(found, where: str) -> None:
    if found != EMBED_LAYOUT_VERSION:
        raise ValueError(
            f"checkpoint {where} was written with embedding-table layout "
            f"{found or 'v1 (pre-tag)'}, but this build uses "
            f"{EMBED_LAYOUT_VERSION}; restoring would silently misread "
            f"embedding rows.  Re-train or convert the checkpoint."
        )


_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}        # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        if b in (0xC7, 0xC8, 0xC9):                          # ext
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        if 0xD4 <= b <= 0xD8:                                # fixext
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in scalars:
            return self.unpack(scalars[b])
        if b in (0xD9, 0xDA, 0xDB):                          # str
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def _ndarray(data: memoryview) -> np.ndarray:
    shape, name, buf = _Reader(data).value()
    if not isinstance(name, str):
        name = bytes(name).decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data: memoryview):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = _Reader(data).value()
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """flax msgpack bytes -> nested dicts of numpy arrays and scalars
    (what ``flax.serialization.msgpack_restore`` returns)."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError("trailing bytes after msgpack data")
    return _unchunk(tree)
