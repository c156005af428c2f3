"""The port's data layer (tpurec_torch.data) against the JAX package's
(tpurec.data) for the same seeds.  All of it is numpy, so every array,
batch and statistic must be identical (tolerance: none)."""

import numpy as np
import pytest

import tpurec.data as jd
import tpurec.data.loader as jl
import tpurec.data.stats as js
import tpurec_torch.data as pd
import tpurec_torch.data.loader as pl
import tpurec_torch.data.stats as ps


def _eq_batch(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


_MODES = [dict(), dict(domain_cluster_k=3),
          dict(domain_cluster_k=4, domain_cluster_conflict=True)]


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("mode", range(len(_MODES)))
def test_make_synthetic_bit_identical(seed, mode):
    kw = dict(n_rows=3000, n_fields=7, n_domain=6, domain_idx=2, seed=seed,
              **_MODES[mode])
    a, b = pd.make_synthetic(**kw), jd.make_synthetic(**kw)
    for name in ("X", "y", "split"):
        x, w = getattr(a, name), getattr(b, name)
        assert x.dtype == w.dtype and x.shape == w.shape
        np.testing.assert_array_equal(x, w, err_msg=name)
    if b.domain_cluster is None:
        assert a.domain_cluster is None
    else:
        np.testing.assert_array_equal(a.domain_cluster, b.domain_cluster)
    assert a.field_dims == b.field_dims
    np.testing.assert_array_equal(a.domain_cnt_weight(),
                                  b.domain_cnt_weight())
    for split in ("train", "valid", "test"):
        for x, w in zip(getattr(a, split), getattr(b, split)):
            np.testing.assert_array_equal(x, w)


def test_make_synthetic_given_field_dims():
    kw = dict(n_rows=2000, n_fields=5, n_domain=4, domain_idx=1,
              field_dims=(30, 4, 9, 1000, 7), seed=3)
    np.testing.assert_array_equal(pd.make_synthetic(**kw).X,
                                  jd.make_synthetic(**kw).X)
    with pytest.raises(ValueError):
        pd.make_synthetic(n_rows=100, domain_cluster_conflict=True)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("with_group", [False, True])
def test_array_batcher_identical(drop, with_group):
    data = jd.make_synthetic(1000, 5, 4, domain_idx=3, seed=2)
    X, y = data.train
    g = X[:, 3] % 2 if with_group else None
    a = pl.ArrayBatcher(X, y, 128, group=g, rng=np.random.default_rng(5),
                        drop_remainder=drop)
    b = jl.ArrayBatcher(X, y, 128, group=g, rng=np.random.default_rng(5),
                        drop_remainder=drop)
    assert len(a) == len(b)
    for _ in range(2):                       # the rng carries across epochs
        for x, w in zip(a, b):
            _eq_batch(x, w)


def test_pad_batch_repeats_row_0():
    rng = np.random.default_rng(0)
    X = rng.integers(0, 9, (5, 3)).astype(np.int64)
    y = rng.random(5).astype(np.float64)
    for group in (None, np.arange(5)):
        a = pl.pad_batch(X, y, group, 8)
        _eq_batch(a, jl.pad_batch(X, y, group, 8))
        np.testing.assert_array_equal(a["x"][5:], np.repeat(X[:1], 3, 0))
        np.testing.assert_array_equal(a["mask"], [1] * 5 + [0] * 3)


def test_domain_batcher_identical():
    data = jd.make_synthetic(3000, 6, 5, domain_idx=4, seed=3)
    X, y = data.train
    a = pl.DomainBatcher(X, y, 4, 5, 64, rng=np.random.default_rng(1))
    b = jl.DomainBatcher(X, y, 4, 5, 64, rng=np.random.default_rng(1))
    np.testing.assert_array_equal(a.domain_batch_seq, b.domain_batch_seq)
    np.testing.assert_array_equal(a.domain_cnt_weight, b.domain_cnt_weight)
    np.testing.assert_array_equal(a.epoch_seq(), b.epoch_seq())
    group_of = np.array([0, 1, 0, 1, 2], np.int32)
    for i in range(40):                        # past each domain's end
        d = i % 5
        for x, w in zip(a.next_batch(d), b.next_batch(d)):
            np.testing.assert_array_equal(x, w)
        _eq_batch(a.next_padded(d, group_of), b.next_padded(d, group_of))
        np.testing.assert_array_equal(a.next_idx(d), b.next_idx(d))
        _eq_batch(a.next_multi([0, 2, 3], 2, group_of),
                  b.next_multi([0, 2, 3], 2, group_of))


def test_prefetch_iter_order_and_errors():
    assert list(pl.prefetch_iter(iter(range(50)), depth=3)) == list(range(50))

    def bad():
        yield 1
        raise KeyError("boom")

    it = pl.prefetch_iter(bad())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


def test_apply_hash_trick_identical():
    rng = np.random.default_rng(9)
    X = rng.integers(0, 10**9, (500, 4))
    spec = {0: 1000, 2: 17}
    for salts in (None, {0: 12345}):
        a = pd.apply_hash_trick(X, (10**9, 5, 10**9, 3), spec, salts)
        b = jd.apply_hash_trick(X, (10**9, 5, 10**9, 3), spec, salts)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[0].dtype == b[0].dtype and a[1] == b[1]
    np.testing.assert_array_equal(pd.hash_ids(X[:, 1], 77, salt=3),
                                  jd.hash_ids(X[:, 1], 77, salt=3))
    for bad in ({7: 10}, {1: 0}):
        with pytest.raises(ValueError):
            pd.apply_hash_trick(X, (1, 2, 3, 4), bad)


def test_summarize_splits_identical():
    data = jd.make_synthetic(4000, 6, 4, domain_idx=3, seed=1)
    a = ps.summarize_splits(data.train, data.valid, data.test, 3)
    b = js.summarize_splits(data.train, data.valid, data.test, 3)
    assert a == b
