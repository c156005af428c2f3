"""Lazy g++ build + ctypes loading of the port's native CSV loader.

``csv_loader.cpp`` (the port's own copy of the JAX package's loader)
compiles with g++ into ``tpurec_torch/_build/libtpurec_torch_native-<hash>.so``
(or under ``$TPUREC_TORCH_NATIVE_CACHE``).  The hash covers the source and
the flags, so an edited source rebuilds and an unchanged one loads the
library already built.  This is host code: the card plays no part.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_SRC = Path(__file__).resolve().parent / "csv_loader.cpp"
_DEFAULT_CACHE = Path(__file__).resolve().parent.parent / "_build"
CACHE_ENV = "TPUREC_TORCH_NATIVE_CACHE"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
             "-pthread")

_lock = threading.Lock()
_lib = None
_build_failed = False


def _lib_path() -> Path:
    cache = Path(os.environ.get(CACHE_ENV) or _DEFAULT_CACHE)
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return cache / f"libtpurec_torch_native-{h.hexdigest()[:16]}.so"


def _build(lib: Path) -> None:
    lib.parent.mkdir(parents=True, exist_ok=True)
    # build into a temp file then rename: concurrent processes race benignly
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=lib.parent)
    os.close(fd)
    cmd = ["g++", *CXX_FLAGS, "-o", tmp, str(_SRC)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_library():
    """ctypes handle to the native library, building it if needed.

    Returns None when no toolchain is available (callers fall back to
    pandas)."""
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib_file = _lib_path()
        try:
            if not lib_file.exists():
                _build(lib_file)
            lib = ctypes.CDLL(str(lib_file))
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
            return None
        lib.trc_count_rows.restype = ctypes.c_int
        lib.trc_count_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.trc_parse_i32.restype = ctypes.c_int64
        lib.trc_parse_i32.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_library() is not None
