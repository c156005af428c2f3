"""Kernel 6 as one pass with the sweep: tpurec_torch's fused_sparse_adam
(its plain version, fused_sparse_adam_reference, and the wrapper, which
runs that plain version for CPU tensors) against the JAX package's
fused_sparse_adam_reference and its Pallas fused_sparse_adam in interpret
mode, at D = 8 and 16; the replace rule on a touched row inside the
small-field prefix against tpurec's sweep-then-set composition; and the
tiles' entry ranges the kernel reads, built on the host.

Inputs come from numpy with a seed.  Tolerances are those of
tests/test_fused_adam_pallas.py: atol 2e-6 on p, m, v and rel 1e-6 on
sum(p**2) (float32 sums in another order).  Ids outside [0, V) touch
nothing in the port and in the Pallas kernel; the JAX oracle wraps
negative ids, so it is given only the ids in range.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.ops.fused_adam_pallas import fused_decay_adam as jax_decay
from tpurec.ops.fused_adam_pallas import \
    fused_decay_adam_reference as jax_decay_ref
from tpurec.ops.fused_adam_pallas import fused_sparse_adam as jax_sparse
from tpurec.ops.fused_adam_pallas import \
    fused_sparse_adam_reference as jax_sparse_ref
from tpurec.train.hybrid import EmbeddingUpdater as JaxUpdater
from tpurec.train.sparse import SparseEmbedState as JaxEmbState
from tpurec_torch.config import TrainConfig
from tpurec_torch.ops.fused_adam import (TILE, fused_sparse_adam,
                                         fused_sparse_adam_reference,
                                         tile_row_bounds)
from tpurec_torch.train.hybrid import EmbeddingUpdater
from tpurec_torch.train.sparse import SparseEmbedState

KW = dict(lr=1e-3, b1=0.9, b2=0.99, eps=1e-8, coef=2e-5)
V = 624                 # 5 Pallas tiles of 128 rows (the last ragged)
PALLAS_TILE = 128


def _state(rng, D):
    p = rng.normal(size=(V, D)).astype(np.float32)
    m = (rng.normal(size=(V, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(V, D))) * 0.01).astype(np.float32)
    return p, m, v


def _ids(case, rng, D):
    """The ids of each case (int64, batch order)."""
    per_tile = TILE // D                        # rows of one port tile
    if case == "duplicates":
        return rng.integers(0, 40, 300)
    if case == "out_of_range":
        ids = rng.integers(0, V, 60)
        ids[::7] = -1
        ids[3::7] = V + rng.integers(0, 5, len(ids[3::7]))
        ids[5] = -(10**6)
        ids[6] = 10**9
        return ids
    if case == "one_tile":
        # every id in the rows of one tile, duplicates among them
        return 3 * per_tile + rng.integers(0, per_tile, 200)
    if case == "tile_boundary":
        # the last row of a tile and the first of the next, of the port's
        # tiles and the Pallas kernel's
        edges = [per_tile - 1, per_tile, 5 * per_tile - 1, 5 * per_tile,
                 PALLAS_TILE - 1, PALLAS_TILE, V - 1]
        return rng.permutation(np.repeat(edges, 3))
    if case == "all_equal":
        return np.full(256, per_tile + 1)
    if case == "empty":
        return np.zeros(0, np.int64)
    raise ValueError(case)


def _oracle(oracle, p, m, v, ids, g, t):
    args = [jnp.asarray(a) for a in (p, m, v)]
    if oracle == "pallas" and not len(ids):
        # the Pallas row kernel takes N >= 1; with no rows it is the sweep
        return jax_decay(*args, jnp.zeros((0, p.shape[1])), t, tile=8,
                         interpret=True, **KW)
    if oracle == "pallas":
        return jax_sparse(*args, jnp.asarray(ids, jnp.int32),
                          jnp.asarray(g), t, tile_rows=PALLAS_TILE,
                          interpret=True, **KW)
    ok = (ids >= 0) & (ids < V)
    return jax_sparse_ref(*args, jnp.asarray(ids[ok], jnp.int32),
                          jnp.asarray(g[ok]), t, **KW)


def _port(fn, p, m, v, ids, g, t, g_small=None):
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    return fn(tp, tm, tv, torch.from_numpy(ids.astype(np.int64)),
              torch.from_numpy(g), t, g_small=g_small, **KW)


def _assert_matches(got, want, atol=2e-6):
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b),
                                   atol=atol, rtol=0)
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-6)


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("D", [8, 16])
@pytest.mark.parametrize("case", ["duplicates", "out_of_range", "one_tile",
                                  "tile_boundary", "all_equal", "empty"])
def test_sparse_sweep_matches_jax(rng, case, D, oracle):
    """Both the plain version and the wrapper on the CPU equal tpurec's
    oracle and its Pallas kernel for each case of the ids."""
    p, m, v = _state(rng, D)
    ids = _ids(case, rng, D)
    g = rng.normal(size=(len(ids), D)).astype(np.float32)
    want = _oracle(oracle, p, m, v, ids, g, 3)
    for fn in (fused_sparse_adam_reference, fused_sparse_adam):
        _assert_matches(_port(fn, p, m, v, ids, g, 3), want)


@pytest.mark.parametrize("oracle", ["reference", "pallas"])
@pytest.mark.parametrize("D", [8, 16])
def test_touched_row_in_the_prefix_replaces_its_gradient(rng, D, oracle):
    """A touched row inside g_small's prefix takes coef * p + its rows'
    gradient, not g_small's: tpurec's hybrid update sweeps with the
    prefix gradient and then sets the touched rows to their step from the
    table before the sweep (tpurec/train/hybrid.py:117-129)."""
    p, m, v = _state(rng, D)
    S = 150
    ids = np.concatenate([rng.integers(0, S, 40), rng.integers(S, V, 40),
                          [7, 7, S - 1, S]])
    g = rng.normal(size=(len(ids), D)).astype(np.float32)
    gs = rng.normal(size=(S, D)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (p, m, v)]
    if oracle == "pallas":
        swept = jax_decay(*jargs, jnp.asarray(gs), 3, tile=8, interpret=True,
                          **KW)
        rows = jax_sparse(*jargs, jnp.asarray(ids, jnp.int32),
                          jnp.asarray(g), 3, tile_rows=PALLAS_TILE,
                          interpret=True, **KW)
    else:
        swept = jax_decay_ref(*jargs, jnp.asarray(gs), 3, **KW)
        rows = jax_sparse_ref(*jargs, jnp.asarray(ids, jnp.int32),
                              jnp.asarray(g), 3, **KW)
    touched = np.unique(ids)
    want = [np.array(a) for a in swept[:3]] + [swept[3]]
    for a, b in zip(want[:3], rows[:3]):
        a[touched] = np.asarray(b)[touched]
    for fn in (fused_sparse_adam_reference, fused_sparse_adam):
        got = _port(fn, p, m, v, ids, g, 3, torch.from_numpy(gs))
        _assert_matches(got, want)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_updater_with_a_demoted_field_inside_the_prefix(rng, moments):
    """EmbeddingUpdater against the JAX one where big_vocab_threshold
    demotes a layout-small field that lies inside the small-field prefix:
    its touched rows take the row step in the sweep's pass."""
    field_dims = (50000, 10, 7, 9000, 12, 300, 70000)
    B, D, threshold = 64, 8, 8
    jupd = JaxUpdater(field_dims, JaxTrainConfig(
        bs=B, embedding_moments_dtype=moments), 1e-5, threshold)
    upd = EmbeddingUpdater(field_dims, TrainConfig(
        bs=B, embedding_moments_dtype=moments), 1e-5, threshold)
    assert upd.big == jupd.big and 1 in upd.big
    assert upd.layout.offsets[1] + field_dims[1] <= upd.S
    Vt = upd.vocab
    p = rng.normal(size=(Vt, D)).astype(np.float32)
    m = (rng.normal(size=(Vt, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(Vt, D))) * 0.01).astype(np.float32)
    x = np.stack([rng.integers(0, d, B) for d in field_dims],
                 1).astype(np.int32)
    x[: B // 2, 1] = x[B // 2:, 1]           # duplicates in the demoted field
    g = rng.normal(size=(B * len(field_dims), D)).astype(np.float32)
    dt = jnp.bfloat16 if moments == "bfloat16" else jnp.float32
    jp, jst, jsq = jupd.update(
        jnp.asarray(p), JaxEmbState(m=jnp.asarray(m).astype(dt),
                                    v=jnp.asarray(v).astype(dt)),
        jnp.asarray(x), jnp.asarray(g), 7)
    tdt = getattr(torch, moments)
    tp = torch.from_numpy(p.copy())
    st = SparseEmbedState(m=torch.from_numpy(m).to(tdt),
                          v=torch.from_numpy(v).to(tdt))
    sq = upd.update(tp, st, torch.from_numpy(x), torch.from_numpy(g), 7)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=2e-6, rtol=0)
    # bfloat16: one ulp where the float32 values, equal to rounding, fall
    # on either side of a bfloat16 rounding boundary
    for got, want in ((st.m, jst.m), (st.v, jst.v)):
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            atol=2e-6, rtol=1e-2 if moments == "bfloat16" else 0)
    assert float(sq) == pytest.approx(float(jsq), rel=1e-6)


def test_non_finite_gradients_sum_in_order(rng):
    """inf summed with finite values stays inf, inf - inf gives NaN, as the
    dense scatter-add of tpurec's oracle gives (the port keeps the true
    sum where tpurec's small-N hybrid path poisons the row with NaN)."""
    D = 16
    p, m, v = _state(rng, D)
    ids = np.array([5, 5, 9, 9, 30])
    g = rng.normal(size=(5, D)).astype(np.float32)
    g[0, 2] = np.inf
    g[2, 4], g[3, 4] = np.inf, -np.inf
    g[4, 0] = np.nan
    want = _oracle("reference", p, m, v, ids, g, 2)
    got = _port(fused_sparse_adam_reference, p, m, v, ids, g, 2)
    for a, b in zip(got[:3], want[:3]):
        a, b = a.numpy(), np.asarray(b)
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b))
        ok = np.isfinite(b)
        np.testing.assert_allclose(a[ok], b[ok], atol=2e-6, rtol=0)
    assert torch.isinf(got[2][5, 2]) and torch.isnan(got[0][9, 4])


@pytest.mark.parametrize("Vt,D", [(1000, 16), (333, 24), (100, 13),
                                  (10, 300), (64, 8), (7, 1)])
def test_tile_ranges_hold_exactly_the_rows_that_meet_each_tile(rng, Vt, D):
    """searchsorted of tile_row_bounds in the stably sorted ids gives, for
    each 256-value tile of the flat [Vt, D] table, the entries whose rows
    have a value in it; ids outside [0, Vt) fall in none."""
    ids = np.concatenate([rng.integers(-5, Vt + 5, 300), [0, Vt - 1]])
    sid, _ = torch.sort(torch.from_numpy(ids), stable=True)
    q = tile_row_bounds(Vt, D, "cpu")
    T = -(-Vt * D // TILE)
    assert tuple(q.shape) == (2, T)
    lo, hi = torch.searchsorted(sid, q, out_int32=True)
    assert lo.dtype == torch.int32
    s = sid.numpy()
    for t in range(T):
        want = [k for k in range(len(s)) if 0 <= s[k] < Vt
                and s[k] * D < TILE * (t + 1) and (s[k] + 1) * D > TILE * t]
        assert list(range(int(lo[t]), int(hi[t]))) == want, t


def test_wrapper_refuses_bad_rows():
    t = torch.zeros(64, 8)
    with pytest.raises(ValueError, match="ids must be"):
        fused_sparse_adam(t, t.clone(), t.clone(), torch.zeros(3),
                          torch.zeros(3, 8), 1, lr=1e-3)
    with pytest.raises(ValueError, match="g_rows must be"):
        fused_sparse_adam(t, t.clone(), t.clone(),
                          torch.zeros(3, dtype=torch.int64),
                          torch.zeros(3, 4), 1, lr=1e-3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        m = torch.zeros(64, 8, device="meta")
        fused_sparse_adam(m, m, torch.zeros_like(m),
                          torch.zeros(3, dtype=torch.int64, device="meta"),
                          torch.zeros(3, 8, device="meta"), 1, lr=1e-3)
