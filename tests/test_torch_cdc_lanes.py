"""CDC's row lanes in the port (``cdc.parallel_rows > 0``; plain versions on
the CPU) against the JAX package's (tpurec's ``populate_rows_parallel``
and ``EmbeddingUpdater.update_stacked``), and against the port's own
serial rows and per-lane updates.

- ``EmbeddingUpdater.update_stacked`` on lane-flat [N*V, D] operands
  against N of the port's ``update`` calls (bitwise) and against tpurec's
  ``update_stacked`` (atol 2e-6 on p, m, v; sum(p**2) rel 1e-6, as
  tests/test_torch_fused_adam.py), at tpurec's field dims
  (tests/test_hybrid_embed.py:201) with ``big_vocab_threshold=500``, B =
  16 and 300 with duplicates, steps (3, 7, 11); ids past the table touch
  nothing; lanes left out of ``active`` keep their blocks.
- One CDC epoch with ``parallel_rows=4`` against tpurec's, in the shape of
  tests/test_torch_cdc_engine.py (its data, schedule, helpers and
  limits: losses 1e-4 relative, the update's raw matrices 1e-4 of
  max(1, |x|), the same clustering), on MMoE and on STAR, at wd = 1e-3.
- The port against itself: lane 0 of the first chunk against serial row
  0 (1e-6; bitwise here), the trainer's state bitwise unchanged, two
  lane updates equal, rows independent of the chunk size, "resident"
  against "stream" bitwise, and bf16 compute.

The lanes on a (2, 2) mesh are in tests/test_torch_cdc_mesh.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cdc_engine import (CDC, MODEL, ROW_TOL, TRAIN,
                                   check_epoch_pair, run_epoch_pair)
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.train.hybrid import EmbeddingUpdater as JaxUpdater
from tpurec.train.sparse import SparseEmbedState as JaxEmbState
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic
from tpurec_torch.train.hybrid import EmbeddingUpdater
from tpurec_torch.train.sparse import SparseEmbedState

LANE_DIMS = (50000, 10, 7, 9000, 12, 300, 70000, 40000, 30000, 25000,
             21000, 22000, 23000)
STEPS = (3, 7, 11)
ROW0_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ update_stacked

def _lane_inputs(B, D=8, oob=False):
    """(updater, jax updater, p, m, v [N, V, D], x [N, B, F], g [N, B*F, D])
    with duplicate ids in field 0; ``oob`` puts lane 1's last field past
    the table."""
    tcfg = dict(bs=B)
    upd = EmbeddingUpdater(LANE_DIMS, TrainConfig(**tcfg), 1e-5, 500)
    jupd = JaxUpdater(LANE_DIMS, JaxTrainConfig(**tcfg), 1e-5, 500)
    rng = np.random.default_rng(0)
    N, V = len(STEPS), upd.vocab
    p = rng.normal(size=(N, V, D)).astype(np.float32)
    m = (rng.normal(size=(N, V, D)) * 0.01).astype(np.float32)
    v = (np.abs(rng.normal(size=(N, V, D))) * 0.01).astype(np.float32)
    x = np.stack([rng.integers(0, d, (N, B)) for d in LANE_DIMS],
                 axis=2).astype(np.int32)
    x[:, : B // 2, 0] = x[:, B // 2: 2 * (B // 2), 0]
    if oob:
        x[1, ::3, -1] = LANE_DIMS[-1] + 10 ** 6      # past lane 1's rows
    g = rng.normal(size=(N, B * len(LANE_DIMS), D)).astype(np.float32)
    return upd, jupd, p, m, v, x, g


def _flat(a):
    return torch.from_numpy(a.reshape(-1, a.shape[-1]).copy())


@pytest.mark.parametrize("B,oob", [(16, False), (300, False), (300, True)])
def test_update_stacked_matches_updates_and_tpurec(B, oob):
    upd, jupd, p, m, v, x, g = _lane_inputs(B, oob=oob)
    N, V, D = p.shape
    tp, tm, tv = _flat(p), _flat(m), _flat(v)
    sq = upd.update_stacked(tp, SparseEmbedState(m=tm, v=tv),
                            torch.from_numpy(x), torch.from_numpy(g),
                            list(STEPS), lanes=N)
    assert sq.shape == (N,)
    for l in range(N):
        lp, lm, lv = (torch.from_numpy(a[l].copy()) for a in (p, m, v))
        lsq = upd.update(lp, SparseEmbedState(m=lm, v=lv),
                         torch.from_numpy(x[l]), torch.from_numpy(g[l]),
                         STEPS[l])
        rows = slice(l * V, (l + 1) * V)
        for got, want in ((tp, lp), (tm, lm), (tv, lv)):
            assert torch.equal(got[rows], want), l
        assert torch.equal(sq[l], lsq)
    jp, jst, jsq = jax.jit(lambda *a: jupd.update_stacked(*a, lanes=N))(
        jnp.asarray(p.reshape(N * V, D)),
        JaxEmbState(m=jnp.asarray(m.reshape(N * V, D)),
                    v=jnp.asarray(v.reshape(N * V, D))),
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(STEPS, jnp.int32))
    for got, want in ((tp, jp), (tm, jst.m), (tv, jst.v)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                                   rtol=0)
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), rtol=1e-6)


def test_update_stacked_leaves_lanes_out_of_active_alone():
    upd, _, p, m, v, x, g = _lane_inputs(16, oob=True)
    N, V, _ = p.shape
    tp, tm, tv = _flat(p), _flat(m), _flat(v)
    on = [0, 2]
    sq = upd.update_stacked(tp, SparseEmbedState(m=tm, v=tv),
                            torch.from_numpy(x[on]), torch.from_numpy(g[on]),
                            [STEPS[l] for l in on], lanes=N, active=on)
    assert sq.shape == (2,)
    rows = slice(V, 2 * V)
    for got, want in ((tp, p), (tm, m), (tv, v)):
        assert torch.equal(got[rows], torch.from_numpy(want[1]))
    for i, l in enumerate(on):
        lp, lm, lv = (torch.from_numpy(a[l].copy()) for a in (p, m, v))
        lsq = upd.update(lp, SparseEmbedState(m=lm, v=lv),
                         torch.from_numpy(x[l]), torch.from_numpy(g[l]),
                         STEPS[l])
        assert torch.equal(tp[l * V:(l + 1) * V], lp)
        assert torch.equal(sq[i], lsq)


def test_update_stacked_refuses_what_it_cannot_step():
    upd = EmbeddingUpdater((6, 5), TrainConfig(), 0.0)       # V = 11
    x = torch.zeros((2, 1, 2), dtype=torch.int32)
    st = SparseEmbedState(m=torch.zeros(22, 4), v=torch.zeros(22, 4))
    with pytest.raises(ValueError, match="multiple of 8"):
        upd.update_stacked(torch.zeros(22, 4), st, x, torch.zeros(2, 2, 4),
                           [1, 1], lanes=2)
    st = SparseEmbedState(m=torch.zeros(22, 8), v=torch.zeros(22, 8))
    with pytest.raises(ValueError, match="does not split"):
        upd.update_stacked(torch.zeros(22, 8), st, x, torch.zeros(2, 2, 8),
                           [1, 1], lanes=3)
    with pytest.raises(ValueError, match="distinct lanes"):
        upd.update_stacked(torch.zeros(22, 8), st, x, torch.zeros(2, 2, 8),
                           [1, 1], lanes=2, active=[1, 0])
    with pytest.raises(ValueError, match="one entry per active lane"):
        upd.update_stacked(torch.zeros(22, 8), st, x, torch.zeros(2, 2, 8),
                           [1], lanes=2)


# ------------------------------------------------------------- the engine

@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1, domain_cluster_k=2)


@pytest.mark.parametrize("base", ["mmoe", "star"])
def test_lanes_epoch_matches_tpurec(data, monkeypatch, base):
    """A CDC epoch whose matrix update runs in 4 lanes in both packages
    (4 mask rows: one chunk; 4 A rows: one; 6 B rows: two, the second
    padded)."""
    check_epoch_pair(data, *run_epoch_pair(
        data, monkeypatch, 1e-3, base_model=base, parallel_rows=4),
        tol=ROW_TOL)


def _trainer(data, model=None, train=None, **cdc):
    cfg = Config(model=ModelConfig(**{**MODEL, **(model or {})}),
                 cdc=CDCConfig(**{**CDC, **cdc}),
                 train=TrainConfig(**{**TRAIN, "wd": 1e-3, **(train or {})}))
    tr = CDCTrainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                    device="cpu")
    tr.setup_data(data.train, data.valid)
    tr._run_steps("warmup", *tr._warmup_sched())
    return tr


def _state(tr):
    """Every tensor of the trainer's state, cloned, by name."""
    out = {f"model/{k}": t.clone() for k, t in tr.model.state_dict().items()}
    out["emb/m"], out["emb/v"] = (tr.state.emb_opt.m.clone(),
                                  tr.state.emb_opt.v.clone())
    for i, (p, st) in enumerate(tr.state.optimizer.state.items()):
        out.update({f"adam/{i}/{k}": v.clone() for k, v in st.items()})
    return out, tr.state.step


def _matrices(tr):
    st = tr.cluster
    return {"mask": st.matrix_mask.copy(), "A": st.matrix_A.copy(),
            "B": st.matrix_B.copy(), "d2g": list(st.domain2group_list)}


def _update(tr, lanes):
    """One update_matrix_cdc(1) of ``tr`` with ``lanes`` row lanes (0:
    serial), from its state; the schedules' generators and batcher and the
    clustering are restored after."""
    kept = copy.deepcopy((tr.np_rng, tr.train_batcher, tr.cluster))
    tr.cfg = dataclasses.replace(
        tr.cfg, cdc=dataclasses.replace(tr.cfg.cdc, parallel_rows=lanes))
    tr.update_matrix_cdc(1)
    out = _matrices(tr)
    tr.np_rng, tr.train_batcher, tr.cluster = kept
    return out


@pytest.mark.parametrize("train", [{}, {"compute_dtype": "bfloat16"}],
                         ids=["float32", "bf16"])
def test_lanes_keep_the_state_and_start_as_serial_row_0(data, train):
    """From one state after the warmup: two 4-lane updates equal and
    leave the state bitwise as it was; a 3-lane update gives the same
    rows (each row bursts from the entry state, whatever its chunk);
    lane 0 of the first chunk is serial row 0."""
    tr = _trainer(data, train=train)
    before, step = _state(tr)
    lanes = _update(tr, 4)
    after, step2 = _state(tr)
    assert step2 == step and before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
    again = _update(tr, 4)
    three = _update(tr, 3)
    for name in ("mask", "A", "B"):
        assert np.all(np.isfinite(lanes[name]))
        np.testing.assert_array_equal(again[name], lanes[name])
        np.testing.assert_array_equal(three[name], lanes[name])
    serial = _update(tr, 0)
    gap = np.abs(lanes["mask"][0] - serial["mask"][0]).max()
    print(f"{train or 'float32'}: lane row 0 vs serial row 0: {gap}")
    assert gap <= ROW0_TOL
    # rows after the first carry the serial path's moments, not the lanes'
    assert not np.array_equal(lanes["mask"][1:], serial["mask"][1:])


def test_lanes_resident_and_stream_are_bitwise_equal(data):
    got = {}
    for placement in ("resident", "stream"):
        tr = _trainer(data, parallel_rows=4, data_placement=placement)
        assert tr._resident == (placement == "resident")
        tr.update_matrix_cdc(1)
        got[placement] = _matrices(tr)
    for name in ("mask", "A", "B"):
        np.testing.assert_array_equal(got["resident"][name],
                                      got["stream"][name])
    assert got["resident"]["d2g"] == got["stream"]["d2g"]
