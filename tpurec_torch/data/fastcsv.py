"""Fast integer-CSV ingestion with a native parser and binary caching (the
port's copy of ``tpurec/data/fastcsv.py``).

The preprocessed tables are all-integer CSVs, parsed by the multithreaded
native loader (tpurec_torch/native/csv_loader.cpp) straight into one int32
[N, C] array, then memoized as .npy + a header json so later loads skip
parsing entirely.  Falls back to pandas when no C++ toolchain is available.
"""

from __future__ import annotations

import ctypes
import json
import os
from typing import List, Optional, Tuple

import numpy as np

from tpurec_torch.native import load_library


def read_int_csv(
    path: str, n_threads: int = 0, strict: bool = True
) -> Tuple[List[str], np.ndarray]:
    """Parse a comma-separated all-integer CSV with one header line.

    -> (column_names, int32 array [n_rows, n_cols]).
    ``strict`` raises on malformed fields (they parse as 0 otherwise)."""
    lib = load_library()
    if lib is None:
        return _read_int_csv_pandas(path)

    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip("\r\n")
    names = header.split(",")

    n_rows = ctypes.c_int64()
    n_cols = ctypes.c_int64()
    offset = ctypes.c_int64()
    rc = lib.trc_count_rows(
        path.encode(), 1, ctypes.byref(n_rows), ctypes.byref(n_cols),
        ctypes.byref(offset),
    )
    if rc != 0:
        raise OSError(f"native loader failed to open {path!r}")
    if n_cols.value != len(names):
        raise ValueError(
            f"{path!r}: header has {len(names)} columns, "
            f"first line has {n_cols.value}"
        )

    out = np.empty((n_rows.value, n_cols.value), np.int32)
    bad = lib.trc_parse_i32(
        path.encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_rows.value, n_cols.value, offset.value, n_threads,
    )
    if bad < 0:
        raise OSError(f"native parse of {path!r} failed (rc={bad})")
    if bad > 0 and strict:
        raise ValueError(
            f"{path!r}: {bad} non-integer/overflowed fields "
            "(use strict=False to parse them as 0)"
        )
    return names, out


def _read_int_csv_pandas(path: str) -> Tuple[List[str], np.ndarray]:
    import pandas as pd

    df = pd.read_csv(path)
    return list(df.columns), df.values.astype(np.int32)


def load_table_cached(
    path: str, cache_dir: Optional[str] = None, n_threads: int = 0
) -> Tuple[List[str], np.ndarray]:
    """read_int_csv memoized as .npy + .json beside the CSV (or in
    ``cache_dir``), invalidated when the CSV's mtime changes."""
    cache_base = os.path.join(
        cache_dir or os.path.dirname(os.path.abspath(path)),
        os.path.basename(path) + ".trc",
    )
    npy, meta = cache_base + ".npy", cache_base + ".json"
    src_mtime = os.path.getmtime(path)
    if os.path.exists(npy) and os.path.exists(meta):
        with open(meta) as f:
            info = json.load(f)
        if info.get("src_mtime") == src_mtime:
            return info["columns"], np.load(npy, mmap_mode="r")
    names, arr = read_int_csv(path, n_threads=n_threads)
    tmp = npy + ".tmp"
    np.save(tmp, arr)
    os.replace(tmp + ".npy" if os.path.exists(tmp + ".npy") else tmp, npy)
    with open(meta, "w") as f:
        json.dump({"columns": names, "src_mtime": src_mtime}, f)
    return names, arr
