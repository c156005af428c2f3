"""Reading and writing the JAX package's checkpoints without JAX, flax or
msgpack.

A tpurec checkpoint is a pickle envelope (``Trainer.save_checkpoint``)
whose ``"state"`` holds the TrainState as flax msgpack bytes
(``flax.serialization.to_bytes``).  :func:`msgpack_restore` is a small
reader of exactly that format, and :func:`msgpack_dumps` its writer, so
the port's Trainer and serving entry points write and load checkpoints
the JAX package reads and writes, on a machine that has only torch and
numpy:

- plain msgpack (maps, arrays, strings, binary, ints, floats, nil, bools);
- ext type 1, an ndarray packed as msgpack ``(shape, dtype name,
  C-order bytes)``; ext type 3, a numpy scalar packed the same way;
  ext type 2, a complex number;
- arrays over 2**30 bytes, stored as ``{"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}}`` and joined back here.

numpy has no bfloat16: the reader turns a bfloat16 array into the float32
array of the same values (exact); the writer writes a bfloat16 tensor's
raw 2-byte payload under the name ``"bfloat16"``.  Arrays read are
read-only views of the input bytes.

:class:`PickleBackend` keeps versioned single-file checkpoints of a port
TrainState (``tpurec/train/checkpoint.py:120-186``).
:class:`AsyncBackend` is the port's counterpart of the JAX package's
``OrbaxBackend`` (``tpurec/train/checkpoint.py:48-103``), which
``make_backend("orbax")`` returns: asynchronous, versioned, sharded.  Its
files are the port's own (orbax imports jax, so the JAX package cannot
read them, nor the port orbax's); the pickle checkpoint of
``Trainer.save_checkpoint`` stays the format that crosses packages.

The layout-version guard is the JAX package's (``train/checkpoint.py:35-45``):
the fused table's row order is ``smallfirst-v2`` in both packages.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import struct
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

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


# -- writer --------------------------------------------------------------

# flax splits arrays above this many bytes into chunks (msgpack's objects
# hold at most 2**31 - 1 bytes)
MAX_CHUNK_SIZE = 2**30


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                              (0xD2, ">i", -0x80000000),
                              (0xD3, ">q", -0x8000000000000000)):
            if v >= lo:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit msgpack")


def _sized(n: int, fix: Optional[int], fix_max: int, codes, what) -> bytes:
    """The header of a str/bin/array/map of n entries."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in codes:
        if n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"{what} of {n} entries is too long for msgpack")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF), (0xC9, ">I", 0xFFFFFFFF))


def _ext_header(code: int, n: int) -> bytes:
    if n in _FIXEXT:
        return bytes((_FIXEXT[n],)) + struct.pack(">b", code)
    return _sized(n, None, 0, _EXT, "ext") + struct.pack(">b", code)


def _array_parts(a):
    """-> (shape, dtype name, C-order bytes) of a numpy array or tensor."""
    if torch.is_tensor(a):
        t = a.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy(
                ).tobytes()
        a = t.numpy()
    return a.shape, a.dtype.name, a.tobytes("C")


def _ndarray_bytes(a) -> bytes:
    shape, name, buf = _array_parts(a)
    return b"".join([
        _sized(3, 0x90, 15, _ARR, "array"),
        _sized(len(shape), 0x90, 15, _ARR, "array"),
        *(_int(int(d)) for d in shape), _str(name),
        _sized(len(buf), None, 0, _BIN, "bin"), buf])


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, _STR, "str") + b


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if torch.is_tensor(a) else a.nbytes


def _chunked(a) -> Dict:
    """flax's chunked form of an array over MAX_CHUNK_SIZE bytes."""
    itemsize = (a.element_size() if torch.is_tensor(a) else a.dtype.itemsize)
    step = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = a.reshape(-1)
    return {"__msgpack_chunked_array__": True,
            "shape": {str(i): int(d) for i, d in enumerate(a.shape)},
            "chunks": {str(i): flat[j:j + step] for i, j in
                       enumerate(range(0, flat.shape[0], step))}}


def _pack(v, out: list) -> None:
    if isinstance(v, dict):
        out.append(_sized(len(v), 0x80, 15, _MAP, "map"))
        for k, x in v.items():
            _pack(k, out)
            if (torch.is_tensor(x) or isinstance(x, np.ndarray)) \
                    and _nbytes(x) > MAX_CHUNK_SIZE:
                x = _chunked(x)
            _pack(x, out)
    elif isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        out.append(_int(v))
    elif isinstance(v, str):
        out.append(_str(v))
    elif torch.is_tensor(v) or isinstance(v, np.ndarray):
        body = _ndarray_bytes(v)
        out.append(_ext_header(_EXT_NDARRAY, len(body)))
        out.append(body)
    elif isinstance(v, np.generic):
        body = _ndarray_bytes(np.asarray(v))
        out.append(_ext_header(_EXT_NPSCALAR, len(body)))
        out.append(body)
    else:
        raise TypeError(f"cannot write {type(v).__name__} as flax msgpack")


def msgpack_dumps(tree) -> bytes:
    """Nested dicts (string keys) of numpy arrays, torch tensors (bfloat16
    included), numpy scalars, ints, bools and strings -> flax msgpack
    bytes (what ``flax.serialization.msgpack_serialize`` writes for the
    same tree).  A tensor is copied to the host first."""
    out: list = []
    _pack(tree, out)
    return b"".join(out)


# -- versioned checkpoints -------------------------------------------------


class PickleBackend:
    """Versioned single-file checkpoints of a port TrainState
    (``ckpt_<step>.pkl``: the state as flax msgpack bytes, ``extra``, the
    step and the table's layout tag), of which the newest ``max_to_keep``
    stay.  On a mesh the state is gathered and rank 0 writes the file
    (every rank calls :meth:`save`; they leave together)."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.pkl")

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        from tpurec_torch.convert import train_state_to_flax
        from tpurec_torch.parallel.embedding import table_shard
        from tpurec_torch.parallel.mesh import barrier

        payload = {
            "state": msgpack_dumps(train_state_to_flax(state)),
            "extra": extra or {},
            "step": step,
            "embed_layout": EMBED_LAYOUT_VERSION,
        }
        shard = table_shard(state.model)
        if shard is not None:       # a mesh: rank 0 writes, all leave
            if shard.mesh.rank == 0:
                self._write(step, payload)
            if torch.distributed.is_initialized():
                barrier(shard.mesh.device)
            return
        self._write(step, payload)

    def _write(self, step: int, payload: Dict) -> None:
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(payload, f)
        os.replace(tmp, self._path(step))
        steps = sorted(self.all_steps())
        for s in steps[: -self.max_to_keep]:
            os.unlink(self._path(s))

    def restore(self, state_template: Any, step: Optional[int] = None):
        """-> (state, extra) from ``step`` (default: the newest); the state
        is ``state_template``, loaded in place.

        TRUST BOUNDARY: the file is a pickle; restore only checkpoints you
        wrote or trust."""
        from tpurec_torch.convert import restore_train_state

        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        with open(self._path(step), "rb") as f:
            payload = pickle.load(f)
        check_embed_layout_version(payload.get("embed_layout"),
                                   self._path(step))
        restore_train_state(state_template, msgpack_restore(payload["state"]))
        return state_template, payload["extra"]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self):
        out = []
        if not os.path.isdir(self.directory):
            return out
        for f in os.listdir(self.directory):
            if f.startswith("ckpt_") and f.endswith(".pkl"):
                try:
                    out.append(int(f[len("ckpt_"):-len(".pkl")]))
                except ValueError:
                    pass
        return out

    def wait_until_finished(self):
        pass

    def close(self):
        pass


def _split_leaves(tree, prefix=""):
    """Nested dicts -> {dotted path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_split_leaves(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _nest(flat: Dict[str, Any]) -> Dict:
    """{dotted path: leaf} -> nested dicts (empty subtrees kept as
    ``{}`` leaves by their writer)."""
    out: Dict = {}
    for key, v in flat.items():
        *path, last = key.split(".")
        t = out
        for k in path:
            t = t.setdefault(k, {})
        t[last] = v
    return out


def _json_leaf(obj):
    """numpy arrays and scalars in ``meta.json`` as lists and numbers (a
    CDC state's matrices ride in its ``extra``)."""
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    raise TypeError(f"{type(obj).__name__} is not JSON serializable")


class AsyncBackend:
    """Asynchronous versioned checkpoints of a port TrainState, sharded as
    the state is (``make_backend("orbax")``).

    ``save`` copies the state to host memory and returns; a writer thread
    writes the step into ``<step>.partial/`` and, once every file of the
    step is there, rank 0's writer renames it ``<step>/``.  On a mesh
    (the table one shard of its rows) each model coordinate's rank of
    data coordinate 0 writes its rows of the table and its moments, with
    their row range (``shard_<m>.msgpack``); rank 0 writes every other
    leaf (``state.msgpack``: expert banks split over the model axis are
    gathered to it first) and ``meta.json`` (the step, ``extra`` as
    JSON, the table layout tag, the shard count).  The directory must be
    shared by the ranks.  ``max_to_keep`` newest complete steps stay;
    ``latest_step``/``all_steps`` list complete steps only.  ``restore``
    assembles the whole table and loads it onto any mesh shape or one
    device (each rank keeps its rows)."""

    POLL_S = 0.01
    TIMEOUT_S = 600.0

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending: Optional[int] = None

    def _path(self, step: int, partial: bool = False) -> str:
        return os.path.join(self.directory,
                            f"{step}.partial" if partial else str(step))

    def save(self, step: int, state: Any, extra: Optional[Dict] = None):
        """Copy ``state`` to host memory and start writing it as ``step``
        (waits for the previous save first)."""
        from tpurec_torch.convert import train_state_to_flax
        from tpurec_torch.parallel.embedding import table_shard
        from tpurec_torch.parallel.mesh import row_sharded

        self.wait_until_finished()
        shard = table_shard(state.model)
        mesh = None if shard is None else shard.mesh
        rank, d, m = (0, 0, 0) if mesh is None else (mesh.rank, mesh.d,
                                                     mesh.m)
        n_shards = 1 if mesh is None else mesh.n_model
        # the table's rows stay local; split expert banks are gathered
        flat = _split_leaves(train_state_to_flax(state, local=True,
                                                 local_experts=False))
        rows = {k: v for k, v in flat.items() if row_sharded(k)}
        V = (state.model.get_parameter("embedding.table").shape[0]
             if shard is None else shard.V)
        row_lo = 0 if shard is None else shard.row_lo
        n_rows = max(0, min(V - row_lo, next(iter(rows.values())).shape[0]))
        files = {}
        if d == 0:
            files[f"shard_{m}.msgpack"] = {
                "row_lo": row_lo,
                "leaves": {k: v[:n_rows] for k, v in rows.items()}}
        if rank == 0:
            files["state.msgpack"] = {
                k: v for k, v in flat.items() if k not in rows}
            files["meta.json"] = {
                "step": int(step), "extra": extra or {},
                "embed_layout": EMBED_LAYOUT_VERSION, "n_rows": int(V),
                "n_shards": n_shards}
        expected = (["state.msgpack", "meta.json"]
                    + [f"shard_{i}.msgpack" for i in range(n_shards)])
        self._pending = step
        self._error = None
        self._thread = threading.Thread(
            target=self._write, args=(step, files, expected if rank == 0
                                      else None), daemon=True)
        self._thread.start()

    def _write(self, step: int, files: Dict, expected) -> None:
        try:
            if not files and expected is None:
                return              # a data rank d > 0: nothing to write
            tmp = self._path(step, partial=True)
            os.makedirs(tmp, exist_ok=True)
            for name, obj in files.items():
                data = (json.dumps(obj, default=_json_leaf).encode()
                        if name.endswith(".json")
                        else msgpack_dumps(obj))
                part = os.path.join(tmp, f"{name}.{os.getpid()}.tmp")
                with open(part, "wb") as f:
                    f.write(data)
                os.replace(part, os.path.join(tmp, name))
            if expected is None:
                return
            self._wait(lambda: all(os.path.exists(os.path.join(tmp, n))
                                   for n in expected), f"step {step}'s files")
            final = self._path(step)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            for s in sorted(self.all_steps())[: -self.max_to_keep]:
                shutil.rmtree(self._path(s), ignore_errors=True)
        except BaseException as e:      # raised by wait_until_finished
            self._error = e

    def _wait(self, done, what: str) -> None:
        t0 = time.monotonic()
        while not done():
            if time.monotonic() - t0 > self.TIMEOUT_S:
                raise TimeoutError(f"{what} not written in "
                                   f"{self.TIMEOUT_S} s")
            time.sleep(self.POLL_S)

    def wait_until_finished(self):
        """Block until the last save is complete on every rank (its step
        listed); raise what its writer raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        if self._pending is not None:
            step, self._pending = self._pending, None
            self._wait(lambda: os.path.isdir(self._path(step)),
                       f"step {step}")

    def restore(self, state_template: Any, step: Optional[int] = None):
        """-> (state, extra) from ``step`` (default: the newest complete
        one), loaded into ``state_template`` in place: the whole table is
        assembled from the shards' rows and each rank keeps its own."""
        from tpurec_torch.convert import restore_train_state

        self.wait_until_finished()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        check_embed_layout_version(meta.get("embed_layout"), path)
        flat = _split_leaves(msgpack_restore(self._read(path,
                                                        "state.msgpack")))
        parts: Dict[str, list] = {}
        for i in range(meta["n_shards"]):
            sh = msgpack_restore(self._read(path, f"shard_{i}.msgpack"))
            for k, v in sh["leaves"].items():
                parts.setdefault(k, []).append((sh["row_lo"], v))
        for k, chunks in parts.items():
            full = np.concatenate([v for _, v in sorted(
                chunks, key=lambda c: c[0])])
            if full.shape[0] != meta["n_rows"]:
                raise ValueError(f"{path}: {k} has {full.shape[0]} rows, "
                                 f"expected {meta['n_rows']}")
            flat[k] = full
        restore_train_state(state_template, _nest(flat))
        return state_template, meta["extra"]

    @staticmethod
    def _read(path: str, name: str) -> bytes:
        with open(os.path.join(path, name), "rb") as f:
            return f.read()

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return [int(f) for f in os.listdir(self.directory)
                if f.isdigit() and os.path.exists(
                    os.path.join(self.directory, f, "meta.json"))]

    def close(self):
        self.wait_until_finished()


def make_backend(kind: str, directory: str, max_to_keep: int = 3):
    """``"pickle"`` (:class:`PickleBackend`) or ``"orbax"`` (the port's
    :class:`AsyncBackend`)."""
    if kind == "orbax":
        return AsyncBackend(directory, max_to_keep)
    if kind == "pickle":
        return PickleBackend(directory, max_to_keep)
    raise ValueError(f"unknown checkpoint backend {kind!r}")
