"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``tpurec_torch/csrc/<name>.cu`` has a plain C interface and compiles,
on its own, into ``tpurec_torch/_build/<name>-<hash>.so`` for Hopper
(``sm_90a``).  The hash covers the source and the flags, so an edited
source rebuilds and an unchanged one loads the library already built.
Nothing includes PyTorch's headers: ``nvcc`` takes seconds per file.

A build happens at first use (the first launch of a kernel, or
:func:`build` called up front to build every source in parallel).  It
raises :class:`KernelCompileError` when ``nvcc`` is missing or fails;
there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelCompileError(RuntimeError):
    """A kernel could not be built (no nvcc, or nvcc failed)."""


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float      # 0.0 when the library was already built
    log: str            # nvcc's output (ptxas register/shared-memory use)


_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise KernelCompileError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "CUDA kernels are built from source")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Build the named kernels (default: all), one nvcc each, in parallel."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KernelCompileError(
            f"no source for kernel(s) {unknown} in {CSRC_DIR}")
    out: Dict[str, Built] = {}
    running = {}
    for name in names:
        path = _lib_path(srcs[name])
        if path.exists():
            out[name] = Built(name, path, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(srcs[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, path, tmp, time.perf_counter())
    failed = []
    for name, (proc, path, tmp, t0) in running.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, path)
        out[name] = Built(name, path, secs, log)
    if failed:
        raise KernelCompileError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be.

    ``signatures`` maps each C entry point to ``(restype, argtypes)``.
    Every library also exports ``tpurec_cuda_error_string``.
    """
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name].path))
            for fn, (restype, argtypes) in signatures.items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            lib.tpurec_cuda_error_string.restype = ctypes.c_char_p
            lib.tpurec_cuda_error_string.argtypes = [ctypes.c_int]
            _LIBS[name] = lib
        return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero cudaError_t."""
    if rc != 0:
        msg = lib.tpurec_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg}) at launch")
