"""The port's native CSV loader (tpurec_torch/native/csv_loader.cpp, built
by tpurec_torch/native/build.py) and ``tpurec_torch.data.fastcsv`` against
the JAX package's, on CSVs written from a seeded numpy draw: bitwise equal
arrays, strict mode's error, CRLF and no final newline, the .trc cache and
its invalidation; the native path is the one used here (g++ is present),
and its library is the port's own, under tpurec_torch/_build/."""

import os
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

import tpurec.data.fastcsv as J
import tpurec.native.build as jbuild
import tpurec_torch.data.fastcsv as P
import tpurec_torch.native.build as pbuild
from tpurec_torch.native import native_available

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def csv_file(tmp_path):
    rng = np.random.default_rng(4)
    df = pd.DataFrame({
        "userid": rng.integers(-500, 10_000, 5000),
        "itemid": rng.integers(0, 2**31 - 1, 5000),
        "domain": rng.integers(0, 50, 5000),
        "neg": rng.integers(-2**31, 0, 5000),
    })
    p = tmp_path / "table.csv"
    df.to_csv(p, index=False)
    return str(p), df


@pytest.mark.parametrize("n_threads", [0, 1, 3, 16])
def test_read_int_csv_is_tpurecs(csv_file, n_threads):
    path, df = csv_file
    names, arr = P.read_int_csv(path, n_threads=n_threads)
    jnames, jarr = J.read_int_csv(path, n_threads=n_threads)
    assert names == jnames == list(df.columns)
    assert arr.dtype == jarr.dtype == np.int32
    np.testing.assert_array_equal(arr, jarr)
    np.testing.assert_array_equal(arr, df.values.astype(np.int32))


def test_native_path_is_used(csv_file, monkeypatch):
    assert native_available()
    monkeypatch.setattr(P, "_read_int_csv_pandas", None)   # not reached
    path, df = csv_file
    _, arr = P.read_int_csv(path, n_threads=2)
    np.testing.assert_array_equal(arr, df.values.astype(np.int32))


def test_pandas_fallback_without_a_toolchain(csv_file, monkeypatch):
    monkeypatch.setattr(P, "load_library", lambda: None)
    path, df = csv_file
    names, arr = P.read_int_csv(path)
    assert names == list(df.columns)
    np.testing.assert_array_equal(arr, J.read_int_csv(path)[1])


def test_strict_rejects_non_integer(tmp_path):
    p = tmp_path / "bad.csv"
    p.write_text("a,b\n1,2\n3,x\n99999999999,4\n")
    for mod in (P, J):
        with pytest.raises(ValueError, match="2 non-integer"):
            mod.read_int_csv(str(p))
    got = P.read_int_csv(str(p), strict=False)[1]
    np.testing.assert_array_equal(got, J.read_int_csv(str(p), strict=False)[1])
    np.testing.assert_array_equal(got[:2], [[1, 2], [3, 0]])


def test_short_row_and_missing_file_fail_as_tpurecs(tmp_path):
    p = tmp_path / "short.csv"
    p.write_text("a,b,c\n1,2\n")
    errors = []
    for mod in (P, J):
        with pytest.raises(ValueError) as e:
            mod.read_int_csv(str(p))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    for mod in (P, J):
        with pytest.raises(FileNotFoundError):
            mod.read_int_csv(str(tmp_path / "missing.csv"))


@pytest.mark.parametrize("body", [b"a,b\r\n1,2\r\n-3,44", b"a,b\n1,2\n-3,44",
                                  b"a,b\r\n1,2\r\n-3,44\r\n"])
def test_crlf_and_no_final_newline(tmp_path, body):
    p = tmp_path / "crlf.csv"
    p.write_bytes(body)
    names, arr = P.read_int_csv(str(p))
    assert names == ["a", "b"]
    np.testing.assert_array_equal(arr, [[1, 2], [-3, 44]])
    np.testing.assert_array_equal(arr, J.read_int_csv(str(p))[1])


def test_cache_roundtrip(csv_file, tmp_path):
    path, df = csv_file
    cache = tmp_path / "cache"
    cache.mkdir()
    n1, a1 = P.load_table_cached(path, cache_dir=str(cache))
    assert isinstance(a1, np.ndarray) and not isinstance(a1, np.memmap)
    n2, a2 = P.load_table_cached(path, cache_dir=str(cache))  # cached load
    assert isinstance(a2, np.memmap)
    assert n1 == n2 == list(df.columns)
    np.testing.assert_array_equal(np.asarray(a2), df.values.astype(np.int32))
    assert sorted(os.listdir(cache)) == ["table.csv.trc.json",
                                         "table.csv.trc.npy"]
    # the JAX package reads the port's cache and the other way round
    jn, ja = J.load_table_cached(path, cache_dir=str(cache))
    assert jn == n1 and isinstance(ja, np.memmap)
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(a2))
    # beside the CSV by default
    P.load_table_cached(path)
    assert os.path.exists(path + ".trc.npy")


def test_cache_invalidation_on_rewrite(csv_file, tmp_path):
    path, df = csv_file
    P.load_table_cached(path, cache_dir=str(tmp_path))
    df2 = df.copy()
    df2["domain"] = 0
    df2.to_csv(path, index=False)
    t = os.path.getmtime(path) + 2
    os.utime(path, (t, t))
    _, arr = P.load_table_cached(path, cache_dir=str(tmp_path))
    assert not isinstance(arr, np.memmap)           # parsed again
    assert (np.asarray(arr)[:, 2] == 0).all()
    _, again = P.load_table_cached(path, cache_dir=str(tmp_path))
    assert isinstance(again, np.memmap) and (np.asarray(again)[:, 2] == 0).all()


def test_library_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(pbuild.CACHE_ENV, raising=False)
    monkeypatch.delenv("TPUREC_NATIVE_CACHE", raising=False)
    assert pbuild.CACHE_ENV != "TPUREC_NATIVE_CACHE"
    lib = pbuild._lib_path()
    assert lib.parent == REPO / "tpurec_torch" / "_build"
    assert lib.name.startswith("libtpurec_torch_native-")
    assert lib.name != os.path.basename(jbuild._lib_path())
    assert pbuild.load_library() is not None and lib.exists()
    assert pbuild._SRC == REPO / "tpurec_torch" / "native" / "csv_loader.cpp"
    # the flags of the JAX package's build
    assert pbuild.CXX_FLAGS == ("-O3", "-march=native", "-std=c++17",
                                "-shared", "-fPIC", "-pthread")


def test_build_is_keyed_by_source_and_cache(tmp_path, monkeypatch):
    monkeypatch.setenv(pbuild.CACHE_ENV, str(tmp_path))
    a = pbuild._lib_path()
    assert a.parent == tmp_path
    src = tmp_path / "loader.cpp"
    src.write_bytes(pbuild._SRC.read_bytes() + b"// edited\n")
    monkeypatch.setattr(pbuild, "_SRC", src)
    b = pbuild._lib_path()
    assert a != b and b.parent == tmp_path
    pbuild._build(b)                                # builds where it says
    assert b.exists()


def test_no_toolchain_gives_none(monkeypatch, tmp_path):
    monkeypatch.setattr(pbuild, "_lib", None)
    monkeypatch.setattr(pbuild, "_build_failed", False)
    monkeypatch.setenv(pbuild.CACHE_ENV, str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))       # no g++ on it
    assert pbuild.load_library() is None
    assert pbuild.native_available() is False
