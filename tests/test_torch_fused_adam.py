"""The port's table update (tpurec_torch.ops.fused_adam, plain versions on
the CPU: kernel 7's sweep, kernel 6's row step and write-back) against the
JAX package's oracles and Pallas kernels (interpret mode), at the shapes of
tests/test_fused_adam_pallas.py, and its EmbeddingUpdater against the JAX
one with float32 and bfloat16 moment storage.

Tolerances are those of tests/test_fused_adam_pallas.py: atol 2e-6 on
p, m, v and rel 1e-6 on sum(p**2) (float32 sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.ops.fused_adam_pallas import fused_decay_adam as jax_decay
from tpurec.ops.fused_adam_pallas import \
    fused_decay_adam_reference as jax_decay_ref
from tpurec.ops.fused_adam_pallas import \
    fused_sparse_adam_reference as jax_sparse_ref
from tpurec.train.hybrid import EmbeddingUpdater as JaxUpdater
from tpurec.train.sparse import SparseEmbedState as JaxEmbState
from tpurec.train.sparse import combine_duplicate_rows as jax_combine
from tpurec_torch.config import TrainConfig
from tpurec_torch.ops.fused_adam import (adam_rows, fused_decay_adam,
                                         fused_sparse_adam, write_rows)
from tpurec_torch.train.hybrid import EmbeddingUpdater
from tpurec_torch.train.sparse import SparseEmbedState, combine_duplicate_rows

KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, coef=2e-5)


def _state(rng, V, D):
    p = rng.normal(size=(V, D)).astype(np.float32)
    m = (rng.normal(size=(V, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(V, D))) * 0.01).astype(np.float32)
    return p, m, v


def _t(*arrays):
    return [torch.from_numpy(np.array(a, copy=True)) for a in arrays]


def _assert_matches(got, want, atol=2e-6):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-6)


@pytest.mark.parametrize(
    "V,D,S,T",
    [(4096, 16, 900, 64), (4096, 16, 0, 64), (1000, 16, 1000, 32),
     (528, 8, 37, 8)])
def test_decay_sweep_matches_oracle_and_pallas(rng, V, D, S, T):
    p, m, v = _state(rng, V, D)
    g = rng.normal(size=(S, D)).astype(np.float32)
    got = fused_decay_adam(*_t(p, m, v, g), 3, **KW)
    jargs = [jnp.asarray(a) for a in (p, m, v, g)]
    _assert_matches(got, jax_decay_ref(*jargs, 3, **KW))
    _assert_matches(got, jax_decay(*jargs, 3, tile=T, interpret=True, **KW))


@pytest.mark.parametrize(
    "V,D,N",
    [(5000, 16, 700), (4096, 16, 1), (300, 8, 50), (2000, 16, 900)])
def test_sparse_adam_matches_oracle(rng, V, D, N):
    p, m, v = _state(rng, V, D)
    ids = rng.integers(0, V, N)
    g = rng.normal(size=(N, D)).astype(np.float32)
    got = fused_sparse_adam(*_t(p, m, v, ids, g), 3, **KW)
    want = jax_sparse_ref(*[jnp.asarray(a) for a in (p, m, v)],
                          jnp.asarray(ids, jnp.int32), jnp.asarray(g), 3,
                          **KW)
    _assert_matches(got, want)


@pytest.mark.parametrize("V,D,S,N", [(4096, 16, 900, 700), (300, 8, 37, 50)])
def test_sparse_adam_with_prefix_gradient(rng, V, D, S, N):
    """g_small [S, D] on rows [0, S) beside sparse rows past S (as the
    hybrid step calls it) equals the oracle given both as sparse rows."""
    p, m, v = _state(rng, V, D)
    ids = rng.integers(S, V, N)
    g = rng.normal(size=(N, D)).astype(np.float32)
    gs = rng.normal(size=(S, D)).astype(np.float32)
    got = fused_sparse_adam(*_t(p, m, v, ids, g), 3, g_small=_t(gs)[0], **KW)
    want = jax_sparse_ref(*[jnp.asarray(a) for a in (p, m, v)],
                          jnp.asarray(np.concatenate([np.arange(S), ids]),
                                      jnp.int32),
                          jnp.asarray(np.concatenate([gs, g])), 3, **KW)
    _assert_matches(got, want)


def test_sparse_adam_duplicate_ids(rng):
    """Duplicate touched rows are summed, as the dense scatter-add does."""
    V, D, N = 512, 16, 300
    p = rng.normal(size=(V, D)).astype(np.float32)
    m = np.zeros((V, D), np.float32)
    ids = rng.integers(0, 10, N)
    g = rng.normal(size=(N, D)).astype(np.float32)
    got = fused_sparse_adam(*_t(p, m, m, ids, g), 1, lr=1e-2, coef=0.0)
    want = jax_sparse_ref(jnp.asarray(p), jnp.asarray(m), jnp.asarray(m),
                          jnp.asarray(ids, jnp.int32), jnp.asarray(g), 1,
                          lr=1e-2, coef=0.0)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=2e-5)


def test_row_step_skips_sentinels_and_reads_the_old_rows(rng):
    """adam_rows reads the table before the sweep and write_rows puts its
    rows over the swept ones; ids outside [0, V) touch nothing."""
    V, D = 64, 8
    p, m, v = _state(rng, V, D)
    ids = torch.tensor([3, 9, 40, V, V + 7, -1])
    g = torch.from_numpy(rng.normal(size=(6, D)).astype(np.float32))
    tp, tm, tv = _t(p, m, v)
    rows = adam_rows(tp, tm, tv, ids, g, 2, **KW)
    fused_decay_adam(tp, tm, tv, None, 2, **KW)
    write_rows(tp, tm, tv, ids, *rows)
    gd = np.zeros((V, D), np.float32)
    gd[[3, 9, 40]] = g[:3].numpy()
    want = jax_sparse_ref(*[jnp.asarray(a) for a in (p, m, v)],
                          jnp.asarray([3, 9, 40], jnp.int32),
                          jnp.asarray(g[:3].numpy()), 2, **KW)
    for a, b in zip((tp, tm, tv), want[:3]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)


def test_combine_duplicate_rows_matches_jax(rng):
    N, D, V = 200, 4, 50
    ids = rng.integers(0, V, N)
    g = rng.normal(size=(N, D)).astype(np.float32)
    id_u, g_u, valid = combine_duplicate_rows(*_t(ids, g), V)
    jid, jg, jvalid = jax_combine(jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(g), V)
    np.testing.assert_array_equal(id_u.numpy(), np.asarray(jid))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(g_u.numpy(), np.asarray(jg), atol=1e-6)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("threshold", [500, 0, 10**9])
def test_embedding_updater_matches_jax(rng, moments, threshold):
    """EmbeddingUpdater.update against the JAX one: big fields on the row
    path, small ones in the sweep, with duplicate ids; bfloat16 moments
    stored rounded in both."""
    field_dims = (50000, 10, 7, 9000, 12, 300, 70000)
    B, D = 64, 8
    jupd = JaxUpdater(field_dims, JaxTrainConfig(
        bs=B, embedding_moments_dtype=moments), 1e-5, threshold)
    upd = EmbeddingUpdater(field_dims, TrainConfig(
        bs=B, embedding_moments_dtype=moments), 1e-5, threshold)
    V = upd.vocab
    assert V == jupd.vocab and upd.big == jupd.big
    p, m, v = _state(rng, V, D)
    x = np.stack([rng.integers(0, d, B) for d in field_dims],
                 1).astype(np.int32)
    x[: B // 2, 0] = x[B // 2:, 0]           # duplicate big-field ids
    x[: B // 2, 2] = x[B // 2:, 2]
    g = rng.normal(size=(B * len(field_dims), D)).astype(np.float32)
    dt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    jp, jst, jsq = jupd.update(
        jnp.asarray(p), JaxEmbState(m=jnp.asarray(m).astype(dt),
                                    v=jnp.asarray(v).astype(dt)),
        jnp.asarray(x), jnp.asarray(g), 7)
    tp, tm, tv, tx, tg = _t(p, m, v, x, g)
    tdt = getattr(torch, moments)
    st = SparseEmbedState(m=tm.to(tdt), v=tv.to(tdt))
    sq = upd.update(tp, st, tx, tg, 7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6, rtol=0)
    # bfloat16: one ulp (2**-8 relative) where the float32 values, equal
    # to rounding, fall on either side of a bfloat16 rounding boundary
    for got, want in ((st.m, jst.m), (st.v, jst.v)):
        assert got.dtype == tdt
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=2e-6, rtol=1e-2 if moments == "bfloat16" else 0)
    assert float(sq) == pytest.approx(float(jsq), rel=1e-6)
