"""The "dense" and "sparse" embedding updates of the port
(tpurec_torch.train.step.make_train_step, tpurec_torch.train.hybrid.
make_sparse_train_step; plain versions on the CPU) against the JAX
package's make_train_step and make_sparse_train_step, on DeepFM (the
CLI's default model) and on a small MMoE with the attention head.

States cross with tpurec_torch.convert: the "dense" layout (optax's chain
over every parameter, the table's mu/nu included) and the "sparse" one
(the chain over the rest beside SparseEmbedState).  Dropout 0.

Tolerances.  The loss 1e-6 relative after one step, 1e-5 over 4.  The
state after one step at 2e-6 absolute (as tests/test_torch_train.py), and
after 4 carried steps too (measured: at most 1.2e-7 on the CPU), but for
the entries whose gradient is rounding alone: a bias feeding a training
BatchNorm, the BatchNorm's running mean it feeds, the key third of the
attention's ``in_proj_bias`` (ROADMAP.md queue 3), held at 2 lr a step
(measured: 1.1e-3 after one step from zero moments, about lr).
Table moments rel 1e-5 (bfloat16 ones to one bf16 rounding).  The Trainer
epoch: per-step losses 1e-4 relative, the state 1e-4 of max(1, |x|)
(those entries at 2 lr a step), eval AUC 1e-3, LogLoss 1e-4, as
tests/test_torch_trainer.py.  Predictions of one state in both packages
4e-6 (P_ATOL; measured 1.1e-6).
"""

import dataclasses

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_bases import DOMAIN_IDX, FIELD_DIMS, ids
from test_torch_train import MODEL as MMOE_MODEL
from test_torch_zoo import zoo_kw
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.models import build_model as jax_build_model
from tpurec.train import Trainer as JaxTrainer
from tpurec.train.reg import reg_coef_tree as jax_reg_coef_tree
from tpurec.train.sparse import combine_duplicate_rows as jax_combine
from tpurec.train.sparse import init_sparse_opt_state as jax_init_opt
from tpurec.train.sparse import make_sparse_train_step as jax_sparse_step
from tpurec.train.step import TrainState as JaxTrainState
from tpurec.train.step import make_optimizer as jax_make_optimizer
from tpurec.train.step import make_train_step as jax_dense_step
from tpurec_torch.config import Config, ModelConfig, TrainConfig
from tpurec_torch.convert import train_state_from_flax, train_state_to_flax
from tpurec_torch.data import make_synthetic
from tpurec_torch.models import MULTI_TOWER_OUTPUT, build_model
from tpurec_torch.train import Trainer
from tpurec_torch.train.hybrid import make_sparse_train_step
from tpurec_torch.train.reg import reg_coef_tree
from tpurec_torch.train.sparse import (SORT_DEDUP_VOCAB, LazyAdamRows,
                                       combine_duplicate_rows)
from tpurec_torch.train.step import init_dense_train_state, make_train_step

BS, L2, N_TOWER = 32, 1e-5, 2
STATE_TOL = 2e-6
P_ATOL = 4e-6           # probabilities of one state in both packages
MODELS = {"deepfm": zoo_kw("deepfm"), "mmoe": MMOE_MODEL}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch(rng, masked=0):
    x = ids(rng, BS)
    x[:, 1] = rng.integers(0, 3, BS)          # duplicate big-field rows
    mask = np.ones(BS, np.float32)
    mask[BS - masked:] = 0.0
    return {"x": x, "y": rng.integers(0, 2, BS).astype(np.float32),
            "group": (x[:, DOMAIN_IDX] % N_TOWER).astype(np.int32),
            "mask": mask}


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _f64(a):
    return (a.double().numpy() if torch.is_tensor(a)
            else np.asarray(a).astype(np.float64))


def rounding_grad(key, shape):
    """Entries of a state-tree leaf whose gradient is rounding alone (a
    bias feeding a training BatchNorm, that BatchNorm's running mean, the
    keys' third of ``in_proj_bias``), or that such an entry feeds."""
    parts = key.split(".")
    loose = np.zeros(shape, bool)
    if parts[0] == "params" and parts[-1] == "bias" and \
            parts[-2].startswith("linear_") and parts[-2] != "linear_out":
        loose[:] = True
    elif parts[0] == "model_state" and parts[-1] == "mean":
        loose[:] = True
    elif parts[-1] == "in_proj_bias" and parts[0] == "params":
        A = shape[-1] // 3
        loose[..., A:2 * A] = True
    return loose


def assert_close_tree(got, want, what, drift, tol=STATE_TOL, rel=False):
    """Two flax state trees leaf by leaf: at ``tol`` (of max(1, |x|) when
    ``rel``), the rounding-gradient entries at ``drift``; bfloat16 moments
    to one bf16 rounding."""
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert set(got) == set(want), what
    for k, w in want.items():
        g, w64 = _f64(got[k]), _f64(w)
        assert g.shape == w64.shape, (what, k)
        if k.startswith("opt_state.1.") and str(getattr(w, "dtype", "")) \
                == "bfloat16":
            np.testing.assert_allclose(g, w64, rtol=2 ** -7, atol=1e-9,
                                       err_msg=f"{what} {k}")
            continue
        loose = rounding_grad(k, w64.shape)
        err = np.abs(g - w64)
        if rel:
            err = err / np.maximum(1.0, np.abs(w64))
        assert np.max(err[~loose], initial=0) <= tol, (what, k,
                                                       err.max())
        assert np.max(np.abs(g - w64)[loose], initial=0) <= drift, (what, k)


def jax_model(name):
    return jax_build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                           JaxModelConfig(**MODELS[name]))


def cfgs(moments="float32"):
    kw = dict(bs=BS, wd=1e-8, embedding_moments_dtype=moments)
    return JaxTrainConfig(**kw), TrainConfig(**kw)


def carried(opt_adam, r):
    """optax ScaleByAdamState part-way through training (count 5)."""
    def rnd(a, scale, pos=False):
        z = r.normal(size=a.shape).astype(np.float32) * scale
        return jnp.asarray(np.abs(z) if pos else z, a.dtype)
    return opt_adam._replace(
        count=jnp.asarray(5, jnp.int32),
        mu=jax.tree.map(lambda a: rnd(a, 1e-2), opt_adam.mu),
        nu=jax.tree.map(lambda a: rnd(a, 1e-4, True), opt_adam.nu))


def jax_state(name, tcfg, update, b, moments_rng=None):
    """(tpurec TrainState of ``update``'s layout, the model, reg coefs)."""
    jm = jax_model(name)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(b["x"]))
    params = v["params"]
    ms = {k: x for k, x in v.items() if k != "params"}
    tx = jax_make_optimizer(tcfg)
    reg = jax_reg_coef_tree(params, name, L2, L2, L2)
    step = jnp.zeros((), jnp.int32)
    if update == "dense":
        opt = tx.init(params)
        if moments_rng is not None:
            opt = (opt[0], carried(opt[1], moments_rng), opt[2])
    else:
        opt_rest, emb = jax_init_opt(params, tx,
                                     tcfg.embedding_moments_dtype)
        if moments_rng is not None:
            r = moments_rng
            opt_rest = (opt_rest[0], carried(opt_rest[1], r), opt_rest[2])
            emb = emb.replace(
                m=jnp.asarray(r.normal(size=emb.m.shape) * 1e-2,
                              emb.m.dtype),
                v=jnp.asarray(np.abs(r.normal(size=emb.v.shape)) * 1e-4,
                              emb.v.dtype))
        opt = (opt_rest, emb)
    if moments_rng is not None:
        step = jnp.asarray(5, jnp.int32)
    return JaxTrainState(params=params, opt_state=opt, model_state=ms,
                         step=step), jm, reg, tx


def jax_step(name, jm, tcfg, reg, tx, update, dedup=None):
    multi = name in MULTI_TOWER_OUTPUT
    if update == "dense":
        fn, _ = jax_dense_step(jm, tcfg, reg, multi, ("batch_stats",),
                               optimizer=tx)
    else:
        fn, _ = jax_sparse_step(jm, tcfg, reg, multi, ("batch_stats",),
                                l2_reg_embedding=L2, optimizer=tx,
                                dedup=dedup)
    return fn


def port_state(name, jst, tcfg, update, dedup=None):
    """The port's state from tpurec's, and its step."""
    pm = build_model(name, FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**MODELS[name]), device="cpu")
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    if update == "dense":
        adam, emb_m, emb_v = jst.opt_state[1], None, None
    else:
        adam = jst.opt_state[0][1]
        emb_m, emb_v = (np.asarray(jst.opt_state[1].m),
                        np.asarray(jst.opt_state[1].v))
    ts = train_state_from_flax(
        pm, tcfg, np_(jst.params), np_(jst.model_state), np_(adam.mu),
        np_(adam.nu), np.asarray(adam.count), emb_m, emb_v,
        np.asarray(jst.step), device="cpu")
    reg = reg_coef_tree([n for n, _ in pm.named_parameters()], name, L2,
                        L2, L2)
    multi = name in MULTI_TOWER_OUTPUT
    step = (make_train_step(pm, tcfg, reg, multi) if update == "dense"
            else make_sparse_train_step(pm, tcfg, reg, multi, L2,
                                        dedup=dedup))
    return ts, step


CASES = [("dense", None), ("sparse", "scatter"), ("sparse", "sort")]


@pytest.mark.parametrize("update,dedup", CASES)
@pytest.mark.parametrize("name", list(MODELS))
def test_one_step_matches_tpurec(name, update, dedup):
    """One step from a fresh state with padded rows: the loss (the whole
    loss under "dense", the loss before the table's L2 under "sparse", as
    tpurec's) and every leaf of the state after it, the table's moments
    and optax's ``count`` included."""
    jcfg, tcfg = cfgs()
    b = batch(np.random.default_rng(0), masked=3)
    jst, jm, reg, tx = jax_state(name, jcfg, update, b)
    ts, step = port_state(name, jst, tcfg, update, dedup)
    fn = jax.jit(jax_step(name, jm, jcfg, reg, tx, update, dedup))
    jst, loss_j = fn(jst, _jb(b), jax.random.PRNGKey(0))
    loss_t = step(ts, _tb(b), None)
    assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-6)
    assert ts.step == int(jst.step) == 1
    assert (ts.emb_opt is None) == (update == "dense")
    assert_close_tree(train_state_to_flax(ts), fser.to_state_dict(jst),
                      f"{name} {update} step 1", 2 * jcfg.lr)


@pytest.mark.parametrize("update,dedup", CASES)
@pytest.mark.parametrize("name", list(MODELS))
def test_four_steps_from_a_carried_state(name, update, dedup):
    """4 steps from a state part-way through training (non-zero moments,
    step 5; bf16 table moments under "sparse"), the last two batches
    padded."""
    jcfg, tcfg = cfgs("bfloat16" if update == "sparse" else "float32")
    rng = np.random.default_rng(1)
    jst, jm, reg, tx = jax_state(name, jcfg, update, batch(rng), rng)
    ts, step = port_state(name, jst, tcfg, update, dedup)
    fn = jax.jit(jax_step(name, jm, jcfg, reg, tx, update, dedup))
    for i in range(4):
        bi = batch(rng, masked=3 * (i // 2))
        jst, loss_j = fn(jst, _jb(bi), jax.random.PRNGKey(i))
        loss_t = step(ts, _tb(bi), None)
        assert float(loss_t) == pytest.approx(float(loss_j), rel=1e-5), i
    assert ts.step == int(jst.step) == 9
    assert_close_tree(train_state_to_flax(ts), fser.to_state_dict(jst),
                      f"{name} {update} step 9", 2 * 4 * jcfg.lr)


def test_combine_duplicate_rows_matches_tpurec():
    """Segment ids, summed gradients and the valid prefix as tpurec's,
    with the sentinel past the last segment; sums in sorted order."""
    rng = np.random.default_rng(2)
    ids_ = rng.integers(0, 9, 40).astype(np.int64)
    g = rng.normal(size=(40, 3)).astype(np.float32)
    want = [np.asarray(a) for a in jax_combine(
        jnp.asarray(ids_, jnp.int32), jnp.asarray(g), 11)]
    got = [a.numpy() for a in combine_duplicate_rows(
        torch.from_numpy(ids_), torch.from_numpy(g), 11)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(got[2], want[2])
    n = len(np.unique(ids_))
    assert got[2].sum() == n and np.all(got[0][n:] == 11)


@pytest.mark.parametrize("dedup", ["scatter", "sort"])
def test_sparse_leaves_untouched_rows_bitwise(dedup):
    """Rows the batch does not touch, and their bf16 moments, keep every
    bit through 3 sparse steps; every touched row moves."""
    _, tcfg = cfgs("bfloat16")
    rng = np.random.default_rng(3)
    pm = build_model("deepfm", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**MODELS["deepfm"]), device="cpu")
    from tpurec_torch.train.hybrid import init_train_state

    ts = init_train_state(pm, tcfg, device="cpu")
    with torch.no_grad():
        ts.emb_opt.m.copy_(torch.randn(ts.emb_opt.m.shape) * 1e-2)
        ts.emb_opt.v.copy_(torch.rand(ts.emb_opt.v.shape) * 1e-4)
    step = make_sparse_train_step(pm, tcfg, {}, False, L2, dedup=dedup)
    table0 = pm.embedding.table.detach().clone()
    m0, v0 = ts.emb_opt.m.clone(), ts.emb_opt.v.clone()
    touched = torch.zeros(table0.shape[0], dtype=torch.bool)
    off = torch.from_numpy(pm.embedding.layout.offsets.astype(np.int64))
    for _ in range(3):
        b = batch(rng)
        step(ts, _tb(b), None)
        touched[(torch.from_numpy(b["x"]).long() + off).reshape(-1)] = True
    table = pm.embedding.table.detach()
    for new, old in ((table, table0), (ts.emb_opt.m, m0),
                     (ts.emb_opt.v, v0)):
        assert torch.equal(new[~touched], old[~touched])
    assert bool((table[touched] != table0[touched]).all(dim=1).all())
    assert ts.emb_opt.m.dtype == torch.bfloat16
    assert LazyAdamRows(FIELD_DIMS, tcfg, L2).dedup == "scatter"
    assert LazyAdamRows((SORT_DEDUP_VOCAB + 1,), tcfg, L2).dedup == "sort"
    with pytest.raises(ValueError, match="dedup"):
        LazyAdamRows(FIELD_DIMS, tcfg, L2, dedup="nope")


def test_dense_ignores_moments_dtype():
    """The "dense" update's Adam keeps float32 moments over every
    parameter, the table's included, whatever embedding_moments_dtype
    says (tpurec's ``tx.init(params)``); the step's table gradient is the
    rows' gradients index_add-ed plus the table's L2."""
    _, tcfg = cfgs("bfloat16")
    pm = build_model("deepfm", FIELD_DIMS, N_TOWER, DOMAIN_IDX,
                     ModelConfig(**MODELS["deepfm"]), device="cpu")
    ts = init_dense_train_state(pm, tcfg, device="cpu")
    assert ts.emb_opt is None
    stepped = [p for g in ts.optimizer.param_groups for p in g["params"]]
    assert len(stepped) == len(list(pm.parameters()))
    assert any(p is pm.embedding.table for p in stepped)
    reg = reg_coef_tree([n for n, _ in pm.named_parameters()], "deepfm",
                        L2, L2, L2)
    step = make_train_step(pm, tcfg, reg, False)
    b = batch(np.random.default_rng(4))
    step(ts, _tb(b), None)
    st = ts.optimizer.state[pm.embedding.table]
    assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32
    tree = train_state_to_flax(ts)
    assert tree["opt_state"]["1"]["mu"]["embedding"]["table"].dtype \
        == np.float32
    # the table's gradient: the rows' through the lookup, plus 2 l2 p
    step.loss_and_grads(ts, _tb(b), None)
    table = pm.embedding.table
    rows = table.detach()[(torch.from_numpy(b["x"]).long() + torch.from_numpy(
        pm.embedding.layout.offsets.astype(np.int64))).reshape(-1)]
    rows.requires_grad_(True)
    pm.train()
    from tpurec_torch.train.step import bce_with_logits
    loss = bce_with_logits(pm(torch.from_numpy(b["x"]), train=True,
                              row_mask=torch.from_numpy(b["mask"]),
                              embed_rows=rows), torch.from_numpy(b["y"]),
                           torch.from_numpy(b["mask"]))
    g_rows, = torch.autograd.grad(loss, rows)
    want = 2 * L2 * table.detach().clone()
    flat_ids = (torch.from_numpy(b["x"]).long() + torch.from_numpy(
        pm.embedding.layout.offsets.astype(np.int64))).reshape(-1)
    want.index_add_(0, flat_ids, g_rows)
    torch.testing.assert_close(table.grad, want, rtol=1e-5, atol=1e-9)


# -- the Trainer under each update ------------------------------------------

TRAIN = dict(bs=256, epoch=1, seed=0, steps_per_dispatch=4)
SMALL = dict(model="deepfm", embed_dim=8, mlp_dims=(32, 16), dropout=0.0)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=4000, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1)


def _trainer_cfgs(update, **train):
    t = {**TRAIN, "embedding_update": update, **train}
    return (JaxConfig(model=JaxModelConfig(**SMALL),
                      train=JaxTrainConfig(**t)),
            Config(model=ModelConfig(**SMALL), train=TrainConfig(**t)))


@pytest.mark.parametrize("update", ["hybrid", "sparse", "dense"])
def test_trainer_epoch_matches_tpurec(data, update):
    """One epoch of DeepFM from tpurec's initial state under each update
    (15 steps, the last padded; "sparse" and "dense" through the
    host-batching path, as tpurec's, K=4 stacked steps a call): per-step
    losses, the final state and the eval of both states."""
    jcfg, cfg = _trainer_cfgs(update)
    args = (data.field_dims, data.n_domain, data.domain_idx)
    jtr = JaxTrainer(jcfg, *args)
    tr = Trainer(cfg, *args, device="cpu")
    assert (tr.scan_steps_idx is None) == (jtr.scan_steps_idx is None) \
        == (update != "hybrid")
    tr.restore(fser.to_bytes(jtr.state))
    losses = {"jax": [], "port": []}
    for t, tag in ((jtr, "jax"), (tr, "port")):
        for attr in ("scan_steps_idx", "scan_steps", "train_step"):
            orig = getattr(t, attr)
            if orig is None:
                continue

            def wrapped(*a, _o=orig, _out=losses[tag], _j=tag == "jax"):
                r = _o(*a)
                _out.append(np.asarray(r[1] if _j else r).reshape(-1))
                return r
            setattr(t, attr, wrapped)
    X, y = data.train
    jtr.train_epoch(X, y, 0)
    tr.train_epoch(X, y, 0)
    lj, lp = (np.concatenate(losses[k]) for k in ("jax", "port"))
    assert lj.shape == lp.shape == (-(-len(X) // TRAIN["bs"]),)
    np.testing.assert_allclose(lp, lj, rtol=1e-4, atol=0)
    assert_close_tree(train_state_to_flax(tr.state),
                      fser.to_state_dict(jtr.state), update,
                      2 * jcfg.train.lr * len(lp), tol=1e-4, rel=True)
    Xv, yv = data.valid
    w = data.domain_cnt_weight()
    ev_j, ev_p = jtr.evaluate(Xv, yv, w), tr.evaluate(Xv, yv, w)
    assert abs(ev_p["total_auc"] - ev_j["total_auc"]) <= 1e-3
    assert abs(ev_p["total_loss"] - ev_j["total_loss"]) <= 1e-4


def test_dense_checkpoint_both_ways_and_layout_errors(tmp_path, data):
    """A "dense" Trainer's checkpoint loads into tpurec's "dense" Trainer
    bit for bit and back; a checkpoint of the other layout raises in
    either direction, before it changes anything."""
    args = (data.field_dims, data.n_domain, data.domain_idx)
    jcfg, cfg = _trainer_cfgs("dense")
    tr = Trainer(cfg, *args, device="cpu")
    tr.train_epoch(*data.train, 0)
    path = str(tmp_path / "port.pkl")
    tr.save_checkpoint(path)
    jtr = JaxTrainer(jcfg, *args)
    jtr.load_checkpoint(path)
    want = dict(_leaves(train_state_to_flax(tr.state)))
    got = dict(_leaves(fser.to_state_dict(jtr.state)))
    assert set(got) == set(want) and "opt_state.1.mu.embedding.table" in got
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(v),
                                      err_msg=k)
    jtr.train_epoch(*data.train, 1)
    jpath = str(tmp_path / "jax.pkl")
    jtr.save_checkpoint(jpath)
    back = Trainer(cfg, *args, device="cpu")
    back.load_checkpoint(jpath)
    tree = dict(_leaves(train_state_to_flax(back.state)))
    for k, v in _leaves(fser.to_state_dict(jtr.state)):
        np.testing.assert_array_equal(np.asarray(tree[k]), np.asarray(v),
                                      err_msg=k)
    # one state, two packages' forwards: measured 1.1e-6 apart (DeepFM's
    # logits reach +-12 at the N(0, 1) table init)
    np.testing.assert_allclose(back.predict(data.valid[0]),
                               jtr.predict(data.valid[0]), rtol=0,
                               atol=P_ATOL)
    hybrid = Trainer(_trainer_cfgs("hybrid")[1], *args, device="cpu")
    before = hybrid.snapshot()
    with pytest.raises(ValueError, match="layout"):
        hybrid.load_checkpoint(jpath)
    assert hybrid.snapshot() == before
    hpath = str(tmp_path / "hybrid.pkl")
    hybrid.save_checkpoint(hpath)
    with pytest.raises(ValueError, match="layout"):
        back.load_checkpoint(hpath)
    sparse = Trainer(_trainer_cfgs("sparse")[1], *args, device="cpu")
    sparse.load_checkpoint(hpath)             # sparse shares hybrid's
    assert sparse.snapshot() == hybrid.snapshot()
    with pytest.raises(ValueError, match="embedding_update"):
        Trainer(dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, embedding_update="nope")), *args, device="cpu")
