"""The port's offline preprocessing (``tpurec_torch.data.preprocess``)
against the JAX package's, on the same small inputs made with numpy from a
seed: the helpers, the Amazon pipeline, the raw Ali-CCP conversion and
``AliCCPPreprocessor.main`` (in-memory and streaming, every sample_mode,
every KBins strategy) give equal frames and byte-identical files; the
numpy KBins copy gives scikit-learn 1.9.0's edges and bins bit for bit
(``"kmeans"``: up to 256 rows, or with scikit-learn on one OpenMP thread;
on several, within the rounding of its threads' summation order)."""

import json
import warnings

import numpy as np
import pandas as pd
import pytest
from sklearn.preprocessing import KBinsDiscretizer
from threadpoolctl import threadpool_limits

import tpurec.data.preprocess as J
import tpurec_torch.data.preprocess as P

MODES = ["nlargest", "random", "interval", "weighted", "interval_random",
         "mix_interval_random"]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


# ---------------------------------------------------------------------------
# helpers and constants
# ---------------------------------------------------------------------------


def test_constants_are_tpurecs():
    assert P.AMAZON_DOMAIN2ENCODER == J.AMAZON_DOMAIN2ENCODER
    assert P.ALICCP_CATEGORICAL == J.ALICCP_CATEGORICAL
    assert P.ALICCP_DENSE == J.ALICCP_DENSE
    assert P.AmazonPreprocessor.FEATURES == J.AmazonPreprocessor.FEATURES
    assert P.AliCCPPreprocessor._ID_COLS == J.AliCCPPreprocessor._ID_COLS


PRICES = ["$12.49", "$10.00 - $20.00", "", None, "call for price", "$0.01",
          "$1,299.99", "- $5", "$3 - $4 - $8", 7.5]
RANKS = ["#1,234 in Books (See Top 100)", "12 in Toys & Games",
         "#1 in Books (See Top 100 in Books)", None, "garbage", "#x in Y",
         "#3 in Home & Kitchen (See"]


def test_process_price_and_rank_are_tpurecs():
    assert [P.process_price(p) for p in PRICES] == [
        J.process_price(p) for p in PRICES]
    assert [P.process_rank(r) for r in RANKS] == [
        J.process_rank(r) for r in RANKS]


def test_reduce_mem_label_encode_k_core_are_tpurecs():
    rng = np.random.default_rng(0)
    df = pd.DataFrame({
        "i8": rng.integers(-100, 100, 500), "i16": rng.integers(0, 30000, 500),
        "i32": rng.integers(0, 2**31 - 1, 500),
        "i64": rng.integers(-2**40, 2**40, 500),
        "f32": rng.random(500) * 1e3, "f64": rng.random(500) * 1e300,
        "s": rng.choice(["a", "b", "c"], 500),
        "userid": rng.choice([f"u{i}" for i in range(40)], 500),
        "itemid": rng.choice([f"i{i}" for i in range(60)], 500),
    })
    got, want = P.reduce_mem(df.copy()), J.reduce_mem(df.copy())
    pd.testing.assert_frame_equal(got, want)
    assert [str(t) for t in got.dtypes[:6]] == [
        "int8", "int16", "int32", "int64", "float32", "float64"]
    enc_p, map_p = P._label_encode(df["userid"])
    enc_j, map_j = J._label_encode(df["userid"])
    pd.testing.assert_series_equal(enc_p, enc_j)
    assert map_p == map_j
    for k in (0, 3, 9, 14):
        pd.testing.assert_frame_equal(P.k_core_filter(df, k),
                                      J.k_core_filter(df, k))


# ---------------------------------------------------------------------------
# Amazon and the raw Ali-CCP conversion
# ---------------------------------------------------------------------------


def _amazon_inputs(root, seed):
    rng = np.random.default_rng(seed)
    n = 900
    items = [f"A{i:03d}" for i in range(50)]
    users = [f"U{i:03d}" for i in range(60)]
    end = 1534291200  # 2018-08-15
    pd.DataFrame({
        "itemid": rng.choice(items, n),
        "userid": rng.choice(users, n),
        "rating": rng.integers(1, 6, n).astype(float),
        "timestamp": end - rng.integers(0, 400 * 86400, n),
    }).to_csv(root / "ratings.csv", index=False, header=False)
    domains = ["Books", "Electronics", "Home & Kitchen", "Pet Supplies",
               "Not A Domain"]
    lines = []
    for i, it in enumerate(items):
        rec = {"asin": it,
               "price": f"${rng.integers(1, 500)}.99" if i % 7 else "",
               "rank": f"#{rng.integers(1, 99999):,} in {rng.choice(domains)}",
               "brand": f"Brand{rng.integers(0, 4)}" if i % 5 else None,
               "category": ([str(rng.choice(domains)), "Sub"] if i % 9
                            else str([str(rng.choice(domains))]))}
        lines.append(json.dumps(rec))
    (root / "meta.json").write_text("\n".join(lines))
    return str(root / "ratings.csv"), str(root / "meta.json")


@pytest.mark.parametrize("k_cores,months", [(2, 12), (3, 6)])
def test_amazon_main_is_tpurecs(tmp_path, k_cores, months):
    ratings, meta = _amazon_inputs(tmp_path, k_cores)
    outs = {}
    for name, mod in (("j", J), ("p", P)):
        d = tmp_path / name
        d.mkdir()
        pre = mod.AmazonPreprocessor(str(d), months, k_cores=k_cores)
        outs[name] = (pre.main(ratings, meta), pre.preprocess_path)
    pd.testing.assert_frame_equal(outs["p"][0], outs["j"][0])
    assert len(outs["p"][0]) > 50
    assert _read(outs["p"][1]) == _read(outs["j"][1])


def _raw_aliccp(root, seed):
    rng = np.random.default_rng(seed)
    common = []
    for i in range(25):
        feats = [f"101:{rng.integers(1, 30)}:1.0",
                 f"121:{rng.integers(1, 5)}:1.0",
                 f"109_14:{rng.integers(1, 9)}:{rng.random():.3f}"]
        if i % 3:
            feats.append(f"150_14:{rng.integers(1, 9)}:{rng.random():.3f}")
        common.append(f"c{i},{len(feats)}," + "\x01".join(feats))
    (root / "common.csv").write_text("\n".join(common) + "\n")
    skel = []
    for s in range(400):
        feats = [f"205:{rng.integers(1, 60)}:1.0",
                 f"206:{rng.integers(1, 8)}:1.0",
                 f"508:{rng.integers(1, 9)}:{rng.random():.3f}"]
        if s % 4 == 0:
            feats.append(f"121:{rng.integers(5, 9)}:1.0")
        click = int(rng.random() < 0.3)
        skel.append(f"{s},{click},{int(click and rng.random() < 0.2)},"
                    f"c{rng.integers(0, 27)},{len(feats)},"
                    + "\x01".join(feats))
    (root / "skeleton.csv").write_text("\n".join(skel) + "\n")
    return str(root / "skeleton.csv"), str(root / "common.csv")


@pytest.mark.parametrize("val_fraction", [0.0, 0.3])
def test_convert_raw_aliccp_is_tpurecs(tmp_path, val_fraction):
    skel, common = _raw_aliccp(tmp_path, 1)
    files = {}
    for name, mod in (("j", J), ("p", P)):
        out, val = str(tmp_path / f"{name}_train.csv"), str(
            tmp_path / f"{name}_val.csv")
        mod.convert_raw_aliccp(skel, common, out, val_fraction=val_fraction,
                               val_out_csv=val)
        files[name] = (_read(out), _read(val))
    assert files["p"] == files["j"]
    for a, b in zip(files["p"], files["j"]):
        assert a == b
    assert files["p"][0].count(b"\n") > 200


# ---------------------------------------------------------------------------
# AliCCPPreprocessor.main
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def aliccp_splits(tmp_path_factory):
    """Raw-format split CSVs (convert_raw_aliccp's schema): skewed domains,
    float dense columns, one integer-valued dense column (reduce_mem makes
    it int8) and one constant column."""
    rng = np.random.default_rng(7)
    root = tmp_path_factory.mktemp("aliccp")
    n_dom = 30
    w = 1.0 / np.arange(1, n_dom + 1)
    w /= w.sum()

    def mk(rows):
        df = pd.DataFrame({"click": rng.integers(0, 2, rows),
                           "purchase": rng.integers(0, 2, rows)})
        for c in J.ALICCP_CATEGORICAL:
            df[c] = {"101": rng.integers(0, 300, rows),
                     "205": rng.integers(0, 600, rows),
                     "206": rng.choice(n_dom, rows, p=w)}.get(
                         c, rng.integers(0, 20, rows))
        for i, d in enumerate(J.ALICCP_DENSE):
            df[d] = np.round(rng.random(rows) * 7 ** (i % 3), 6)
        df["D702"] = rng.integers(0, 50, rows).astype(float)
        df["D853"] = 2.5
        return df

    paths = []
    for name, rows in (("train", 12000), ("val", 1500), ("test", 1500)):
        p = str(root / f"ali_ccp_{name}.csv")
        mk(rows).to_csv(p, index=False)
        paths.append(p)
    return paths


def _aliccp_main(mod, root, paths, mode, method, streaming, **kw):
    d = root / f"{mod.__name__.split('.')[0]}_{mode}_{method}_{streaming}"
    d.mkdir()
    pre = mod.AliCCPPreprocessor(str(d), downsample_freq_thresh=2,
                                 sample_n_domain=8, sample_mode=mode,
                                 discrete_method=method, seed=2000)
    out = pre.main(*paths, streaming=streaming, **kw)
    return out, pre


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("method,streaming", [
    ("uniform", False), ("quantile", False), ("uniform", True),
    ("kmeans", False)])
def test_aliccp_main_is_tpurecs(tmp_path, aliccp_splits, mode, method,
                                streaming):
    """Frames and files byte for byte.  ``"kmeans"``: scikit-learn on one
    OpenMP thread, which sums its rows in row order as the port does; on
    several it adds the threads' partial sums in the order they finish
    (test_kbins_copy_is_sklearns holds the port to that within rounding)."""
    kw = {"chunksize": 1777} if streaming else {}
    with warnings.catch_warnings(), threadpool_limits(
            1 if method == "kmeans" else None, "openmp"):
        warnings.simplefilter("ignore")      # scikit-learn's constant col
        want, jpre = _aliccp_main(J, tmp_path, aliccp_splits, mode, method,
                                  streaming, **kw)
    got, ppre = _aliccp_main(P, tmp_path, aliccp_splits, mode, method,
                             streaming, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert _read(ppre.preprocess_path) == _read(jpre.preprocess_path)
    assert ppre.domain2encoder_dict == jpre.domain2encoder_dict
    assert 1 <= got["domain"].nunique() <= 8
    assert got["D853"].eq(0).all() and got["D702"].between(0, 9).all()


def test_aliccp_in_memory_frames_are_tpurecs(tmp_path, aliccp_splits):
    """discretize then filter_and_sample on frames, as a caller of the two
    stages drives them: equal frames at every step."""
    frames = [J.reduce_mem(pd.read_csv(p)) for p in aliccp_splits]
    jpre = J.AliCCPPreprocessor(str(tmp_path), downsample_freq_thresh=2,
                                sample_n_domain=8, discrete_method="quantile")
    ppre = P.AliCCPPreprocessor(str(tmp_path), downsample_freq_thresh=2,
                                sample_n_domain=8, discrete_method="quantile")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jpre.discretize([f.copy() for f in frames])
    got = ppre.discretize([f.copy() for f in frames])
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)
    pd.testing.assert_frame_equal(ppre.filter_and_sample(got),
                                  jpre.filter_and_sample(want))


def test_aliccp_streaming_refuses_quantile(tmp_path):
    pre = P.AliCCPPreprocessor(str(tmp_path), discrete_method="quantile")
    with pytest.raises(ValueError, match="uniform"):
        pre.main("a.csv", "b.csv", "c.csv", streaming=True)
    with pytest.raises(ValueError, match="Invalid sample_mode"):
        P.AliCCPPreprocessor(str(tmp_path), sample_mode="nope"
                             )._select_domains(pd.Series(dtype=int), None)


# ---------------------------------------------------------------------------
# the KBins copy against scikit-learn 1.9.0
# ---------------------------------------------------------------------------


def _columns():
    rng = np.random.default_rng(11)
    f = rng.random(3000) * 7
    return {
        "float32": f.astype(np.float32),
        "float64": f,
        "int8": rng.integers(-5, 100, 3000).astype(np.int8),
        "int16": rng.integers(-500, 3000, 3000).astype(np.int16),
        "constant_f32": np.full(500, 3.5, np.float32),
        "constant_i8": np.full(500, 4, np.int8),
        # tied quantiles: 70% zeros drop bins
        "tied_f32": np.r_[np.zeros(2100), rng.random(900)].astype(np.float32),
        "tied_i16": np.r_[np.full(1500, 7), rng.integers(0, 3, 1500)
                          ].astype(np.int16),
        # few distinct values, edges on values
        "steps_f64": rng.integers(0, 11, 3000).astype(np.float64) / 4,
    }


def _sklearn(strategy, subsample):
    return KBinsDiscretizer(n_bins=10, encode="ordinal", strategy=strategy,
                            subsample=subsample)


def _check_same(col, strategy, subsample=None, others=()):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = _sklearn(strategy, subsample).fit(pd.DataFrame({"c": col}))
    ours = P._KBinsDiscretizer(10, strategy, subsample).fit(
        pd.Series(col, name="c"))
    edges = sk.bin_edges_[0]
    assert ours.bin_edges_.dtype == edges.dtype
    np.testing.assert_array_equal(ours.bin_edges_, edges)
    assert ours.n_bins_ == sk.n_bins_[0]
    finite = edges[np.isfinite(edges)]
    on_edges = (finite.astype(col.dtype),) if len(finite) else ()
    for x in (col, *on_edges, *others):
        want = sk.transform(pd.DataFrame({"c": x})).astype(int)[:, 0]
        got = ours.transform(pd.Series(x, name="c"))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    return ours


def _check_close(col, others, rtol):
    """The kmeans copy against scikit-learn on its default threads: the
    edges within ``rtol`` of the column's range, and every row's bin equal
    but for values within that distance of an edge."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sk = _sklearn("kmeans", None).fit(pd.DataFrame({"c": col}))
    ours = P._KBinsDiscretizer(10, "kmeans").fit(col)
    edges, atol = sk.bin_edges_[0], rtol * (float(col.max())
                                             - float(col.min()))
    assert ours.bin_edges_.shape == edges.shape
    finite = np.isfinite(edges)
    assert np.array_equal(ours.bin_edges_[~finite], edges[~finite])
    np.testing.assert_allclose(ours.bin_edges_[finite], edges[finite],
                               rtol=0, atol=atol)
    for x in (col, *others):
        want = sk.transform(pd.DataFrame({"c": x})).astype(int)[:, 0]
        near = (np.abs(x.astype(np.float64)[:, None]
                       - edges[finite][None, :]) <= atol).any(axis=1)
        np.testing.assert_array_equal(ours.transform(x)[~near], want[~near])


# scikit-learn on several threads adds the threads' partial sums in the
# order they finish; a float32 column's k-means runs in float32, where
# that order parts the edges by a few of its ulps (1.9e-7 of the range
# measured at 3,000 rows), and a float64 one's by about 1e-15
KMEANS_THREADS_RTOL = {np.dtype(np.float32): 2.0 ** -20}


@pytest.mark.parametrize("strategy", ["uniform", "quantile", "kmeans"])
@pytest.mark.parametrize("name", list(_columns()))
def test_kbins_copy_is_sklearns(name, strategy):
    """``"kmeans"``: bitwise up to 256 rows and on one OpenMP thread; on
    scikit-learn's default threads, within rounding (:func:`_check_close`,
    1e-9 of the range, float32 columns KMEANS_THREADS_RTOL)."""
    col = _columns()[name]
    # a split of another dtype, as reduce_mem may give val/test
    other = (col.astype(np.float64) if col.dtype != np.float64
             else col.astype(np.float32))
    others = (other, other[::-1] * 1.5)
    if strategy == "kmeans":
        _check_same(col[:256], strategy, others=others)
        _check_close(col, others, KMEANS_THREADS_RTOL.get(col.dtype, 1e-9))
        with threadpool_limits(1, "openmp"):
            ours = _check_same(col, strategy, others=others)
    else:
        ours = _check_same(col, strategy, others=others)
    if name.startswith("constant"):
        assert ours.n_bins_ == 1 and not ours.transform(col).any()
    if name == "float32" and strategy == "uniform":
        assert ours.bin_edges_.dtype == np.float32
    if name.startswith("tied") and strategy == "quantile":
        assert ours.n_bins_ < 10


@pytest.mark.parametrize("strategy,subsample", [("quantile", 200_000),
                                                ("uniform", None)])
def test_kbins_copy_subsamples_as_sklearn(strategy, subsample):
    """250,000 rows: the quantile fit draws its 200,000-row subsample from
    numpy's global state, as scikit-learn does; one np.random.seed, the
    same edges, bins and following draw."""
    col = (np.random.default_rng(3).gamma(2.0, 2.0, 250_000)
           ).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        np.random.seed(5)
        sk = _sklearn(strategy, subsample).fit(pd.DataFrame({"c": col}))
        sk_next = np.random.random()
    np.random.seed(5)
    ours = P._KBinsDiscretizer(10, strategy, subsample).fit(col)
    assert np.random.random() == sk_next
    np.testing.assert_array_equal(ours.bin_edges_, sk.bin_edges_[0])
    np.testing.assert_array_equal(
        ours.transform(col),
        sk.transform(pd.DataFrame({"c": col})).astype(int)[:, 0])
    if strategy == "quantile":      # the subsample moved the edges
        full = P._KBinsDiscretizer(10, strategy, None).fit(col)
        assert not np.array_equal(full.bin_edges_, ours.bin_edges_)


def test_kbins_copy_refuses_what_sklearn_refuses():
    bad = np.array([1.0, np.nan, 3.0])
    with pytest.raises(ValueError, match="NaN"):
        _sklearn("uniform", None).fit(pd.DataFrame({"c": bad}))
    with pytest.raises(ValueError, match="NaN"):
        P._KBinsDiscretizer(10, "uniform").fit(bad)
    fitted = P._KBinsDiscretizer(10, "uniform").fit(np.arange(5.0))
    with pytest.raises(ValueError, match="NaN"):
        fitted.transform(np.array([np.inf]))
    for fn in (_sklearn("uniform", None).fit, fitted.transform):
        with pytest.raises(ValueError, match="0 sample"):
            fn(pd.DataFrame({"c": np.zeros(0)}))
    with pytest.raises(ValueError, match="0 sample"):
        P._KBinsDiscretizer(10, "uniform").fit(np.zeros(0))
    few = np.arange(5.0)
    for fn in (_sklearn("kmeans", None).fit, P._KBinsDiscretizer(
            10, "kmeans").fit):
        with pytest.raises(ValueError, match="n_samples=5 should be >= "
                                             "n_clusters=10"):
            fn(pd.DataFrame({"c": few}))
    with pytest.raises(ValueError, match="strategy"):
        P._KBinsDiscretizer(10, "kmedoids")
