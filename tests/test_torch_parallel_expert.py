"""Expert parallelism in the port (``Shardings(expert_parallel=True)``,
tpurec_torch.parallel.experts, over gloo on the CPU) against the port's
one-device model and steps, and against the JAX package's
``Shardings(expert_parallel=True)`` on its virtual (2, 2) mesh.

One spawn per world (tests/test_torch_mesh_worker.py's ``expert`` task):
2 ranks run (1, 2) forwards of MMoE, PLE and HiNet with their banks
split; 4 ranks run EP_STEPS steps of MMoE on (2, 2) under each update,
the BatchNorm scale's gradient with an L2 term, and PLE on (1, 4), where
its 2 shared experts do not divide the model axis.

Limits: a split bank's forward is one device's bit for bit.  The steps
are held at the JAX package's limits for its mesh (tests/test_sharding.py:
57-82): losses rtol 2e-5, the table, its moments and the expert banks
(weights, biases, BatchNorm statistics, Adam moments) atol 2e-5.  The
parameters are held at wd = 1e-3 (``EP_WD``): a bias feeding a training
BatchNorm has a gradient that is zero but for rounding, and the summation
order of the bank's input gradient (each model rank sums its stacks, the
model group sums the ranks) changes that rounding, which Adam turns into
a step of up to lr either way at the default wd (ROADMAP.md queue 3); at
wd = 1e-3 the decay term decides the step.  The losses are held at the
default wd too.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec.parallel import Shardings as JShardings
from tpurec.parallel import make_mesh as jmake_mesh
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.parallel.mesh import Mesh, Shardings

LOSS_RTOL, STATE_ATOL = 2e-5, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("expert")
    mw.spawn("expert", 2, str(out))
    mw.spawn("expert", 4, str(out))
    res = {"dir": out}
    for w in (2, 4):
        with np.load(out / f"expert_{w}.npz") as z:
            res.update({k: z[k] for k in z.files})
    return res


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_mesh(n_model, m=0):
    """Rank ``m`` of a (1, n_model) mesh with no process group (its
    collectives are never called)."""
    return Mesh(1, n_model, m, torch.device("cpu"), "none")


def _one_device(update="hybrid", model=None, wd=mw.EP_WD, n=mw.EP_STEPS):
    tr = mw.ep_trainer(mw.config(update, model=model, wd=wd))
    losses = mw.run_steps(tr, mw.global_batches(mw.EP_STEPS)[:n])
    return tr, np.asarray(losses), mw.flat(train_state_to_flax(tr.state))


def _held(state):
    """The leaves held at STATE_ATOL: the table and its moments, and
    every leaf of an expert bank."""
    return [k for k in state if k.endswith(("embedding.table", ".1.m",
                                            ".1.v"))
            or any(b in k.split(".") for b in ("experts", "experts_specific",
                                               "experts_shared",
                                               "specific_experts",
                                               "shared_experts"))]


# ------------------------------------------------------------- forwards

@pytest.mark.parametrize("which", ["eval", "train"])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("name", sorted(mw.EP_MODELS))
def test_forward_is_one_devices_bit_for_bit(runs, name, rate, which):
    """(1, 2), every bank split: the eval forward and the training
    forward (batch statistics; at dropout 0.2 each bank draws its whole
    mask and keeps its stacks' part) equal one device's bit for bit."""
    kw = dict(mw.EP_MODELS[name], dropout=rate)
    one = mw.ep_trainer(mw.config(model=kw))
    want = mw.ep_forwards(one, mw.global_batches(mw.EP_STEPS)[0],
                          slice(None), None)
    i = ["eval", "train"].index(which)
    got = runs[f"{name}_{rate}/fwd{i}"]
    assert got.shape == want[i].shape
    np.testing.assert_array_equal(got, want[i])


@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("name", sorted(mw.EP_MODELS))
def test_each_rank_holds_its_stacks(runs, name, rank):
    """A split leaf (two axes or more, in a bank) holds half the stacks
    on each of 2 model ranks; every other leaf is whole."""
    one = mw.ep_trainer(mw.config(model=mw.EP_MODELS[name]))
    sh = Shardings(_fake_mesh(2), expert_parallel=True)
    got = json.loads(str(runs[f"{name}_0.0/shapes_{rank}"]))
    full = {k: list(t.shape) for k, t in one.model.state_dict().items()}
    assert set(got) == set(full)
    n_split = 0
    for k, shape in full.items():
        if k == "embedding.table":
            continue
        if sh.spec(k, one.model.state_dict()[k]):
            n_split += 1
            assert got[k] == [shape[0] // 2] + shape[1:], k
        else:
            assert got[k] == shape, k
    assert n_split > 0


# ------------------------------------------------------------ the rules

def _jax_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _jax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("name", sorted(mw.EP_MODELS))
def test_specs_are_tpurecs(name, n_model):
    """Every leaf of the state tree (parameters, Adam moments, BatchNorm
    statistics) takes tpurec's spec under expert_parallel=True."""
    one = mw.ep_trainer(mw.config(model=mw.EP_MODELS[name]))
    tree = train_state_to_flax(one.state)
    jsh = JShardings(jmake_mesh(1, n_model, devices=jax.devices()[:n_model]),
                     expert_parallel=True)
    sh = Shardings(_fake_mesh(n_model), expert_parallel=True)
    n_split = 0
    for path, leaf in _jax_leaves(tree):
        want = tuple(jsh._spec_for_path(path, leaf))
        assert sh.spec(path, leaf) == want == sh.spec(".".join(path), leaf), \
            path
        n_split += want[:1] == ("model",) and "embedding" not in path
    assert n_split > 0
    if name == "ple" and n_model == 4:
        # 2 shared experts do not divide 4 model ranks: whole
        leaf = tree["params"]["cgc_0"]["experts_shared"]["linear_0"][
            "weight"]
        assert sh.spec("params.cgc_0.experts_shared.linear_0.weight",
                       leaf) == ()


def test_shard_model_prints_the_split(capsys):
    """Shardings.shard_model says which banks it split and which stayed
    whole (rank 0 of a (1, 4) mesh, no collective needed)."""
    one = mw.ep_trainer(mw.config(model=mw.EP_MODELS["ple"]))
    Shardings(_fake_mesh(4), expert_parallel=True).shard_model(one.model)
    out = capsys.readouterr().out
    assert "cgc_0.experts_specific (4 -> 1 a rank)" in out
    assert "cgc_0.experts_shared whole (2 stacks on a model axis of 4)" \
        in out
    assert one.model.cgc_0.experts_specific.linear_0.weight.shape[0] == 1
    assert one.model.cgc_0.experts_shared.linear_0.weight.shape[0] == 2


# ---------------------------------------------------------------- steps

@pytest.mark.parametrize("update", mw.UPDATES)
def test_steps_on_2x2_match_one_device(runs, update):
    _, losses, state = _one_device(update)
    key = f"{update}_{mw.EP_WD:g}"
    np.testing.assert_allclose(runs[f"{key}/losses"], losses,
                               rtol=LOSS_RTOL)
    held = _held(state)
    assert len([k for k in held if "experts" in k]) >= 8, held
    for k in held:
        assert runs[f"{key}/{k}"].shape == state[k].shape, k
        np.testing.assert_allclose(runs[f"{key}/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=f"{key} {k}")
    # every leaf crossed: the gathered tree is the one-device tree's
    saved = {"reloaded_equal"} if update != "sparse" else set()
    assert {k[len(key) + 1:] for k in runs if k.startswith(key + "/")} \
        == set(state) | {"losses"} | saved


def test_default_wd_losses_match_one_device(runs):
    _, losses, _ = _one_device(wd=1e-8)
    np.testing.assert_allclose(runs["hybrid_1e-08/losses"], losses,
                               rtol=LOSS_RTOL)


def test_bn_scale_gradient_counts_its_l2_once(runs):
    """The experts' BatchNorm scale ([H], whole on every rank) with an L2
    coefficient: each model rank's gradient is its stacks' part, summed
    over the model group, and the L2 term is counted once; the loss is
    the one-device loss."""
    one = mw.ep_trainer(mw.config(wd=mw.EP_WD))
    loss, g_scale, g_w = mw.bn_scale_grads(
        one, mw.global_batches(mw.EP_STEPS)[0], slice(None))
    np.testing.assert_allclose(runs["bn/loss"], loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(runs["bn/scale"], g_scale, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(runs["bn/w"], g_w, rtol=1e-5, atol=1e-7)
    # the L2 term is a visible share of the scale's gradient: counted
    # twice (once a model rank) it would not match
    l2 = 2 * mw.BN_SCALE_L2 * one.model.experts.bn_0.scale.detach().numpy()
    assert np.abs(l2).max() > 100 * 1e-7


def test_bank_that_does_not_divide_stays_whole(runs):
    """PLE on (1, 4): the 4 specific experts of each level split one a
    rank, the 2 shared ones stay whole; 3 steps match one device."""
    assert json.loads(str(runs["ple14/split"])) == [
        "cgc_0.experts_specific", "cgc_1.experts_specific"]
    _, losses, state = _one_device(model=mw.EP_MODELS["ple"])
    np.testing.assert_allclose(runs["ple14/losses"], losses, rtol=LOSS_RTOL)
    for k in _held(state):
        np.testing.assert_allclose(runs[f"ple14/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


def test_hybrid_2x2_matches_tpurec_expert_parallel_mesh(runs):
    """tpurec's make_hybrid_train_step on its virtual (2, 2) mesh with
    Shardings(expert_parallel=True), from the port's initial state."""
    import flax.serialization as fser

    from tpurec.config import ModelConfig as JModelConfig
    from tpurec.config import TrainConfig as JTrainConfig
    from tpurec.models import build_model as jbuild
    from tpurec.train.hybrid import make_hybrid_train_step
    from tpurec.train.reg import reg_coef_tree
    from tpurec.train.sparse import init_sparse_opt_state
    from tpurec.train.step import TrainState, make_optimizer

    port = mw.ep_trainer(mw.config("hybrid", wd=mw.EP_WD))
    tree = train_state_to_flax(port.state)
    mcfg = JModelConfig(**mw.MODEL)
    tcfg = JTrainConfig(bs=mw.BS, wd=mw.EP_WD)
    jm = jbuild("mmoe", mw.FIELD_DIMS, mw.N_TOWER, mw.DOMAIN_IDX, mcfg)
    v = jm.init(jax.random.PRNGKey(0), jnp.zeros((2, len(mw.FIELD_DIMS)),
                                                 jnp.int32))
    params = v["params"]
    ms = {k: x for k, x in v.items() if k != "params"}
    tx = make_optimizer(tcfg)
    tmpl = TrainState(params=params,
                      opt_state=init_sparse_opt_state(params, tx),
                      model_state=ms, step=jnp.zeros((), jnp.int32))
    st = fser.from_state_dict(tmpl, jax.tree.map(np.asarray, tree))
    mesh = jmake_mesh(2, 2, devices=jax.devices()[:4])
    sh = JShardings(mesh, expert_parallel=True)
    st = jax.device_put(st, sh.state_sharding(st))
    assert "model" in str(st.params["experts"]["linear_0"]["weight"]
                          .sharding.spec)
    reg = reg_coef_tree(params, "mmoe", mcfg.l2_reg_embedding,
                        mcfg.l2_reg_linear, mcfg.l2_reg_dnn)
    step, _ = make_hybrid_train_step(
        jm, tcfg, reg, True, tuple(ms), l2_reg_embedding=mcfg.l2_reg_embedding,
        optimizer=tx)
    losses = []
    with mesh:
        for i, b in enumerate(mw.global_batches(mw.EP_STEPS)):
            gb = jax.device_put({k: jnp.asarray(x) for k, x in b.items()},
                                sh.batch_sharding(b))
            st, loss = step(st, gb, jax.random.PRNGKey(i))
            losses.append(float(loss))
    key = f"hybrid_{mw.EP_WD:g}"
    np.testing.assert_allclose(runs[f"{key}/losses"], losses,
                               rtol=LOSS_RTOL)
    jt = mw.flat(jax.tree.map(np.asarray,
                              fser.to_state_dict(jax.device_get(st))))
    held = _held(jt)
    assert any("experts" in k for k in held)
    for k in held:
        np.testing.assert_allclose(runs[f"{key}/{k}"],
                                   np.asarray(jt[k], np.float32), rtol=0,
                                   atol=STATE_ATOL, err_msg=k)


@pytest.mark.parametrize("how", ["pickle", "async"])
@pytest.mark.parametrize("update", ["hybrid", "dense"])
def test_checkpoint_holds_one_device_shapes(runs, update, how):
    """A (2, 2) trainer's checkpoint (the experts and their Adam moments
    gathered; rank 0 writes) loads into a one-device trainer as the
    gathered state, and the pickle back onto a fresh (2, 2) trainer
    gives the same state."""
    key = f"{update}_{mw.EP_WD:g}"
    one = mw.ep_trainer(mw.config(update, wd=mw.EP_WD))
    if how == "pickle":
        one.load_checkpoint(str(runs["dir"] / f"{key}.pkl"))
    else:
        one.load_versioned(one.make_checkpointer(
            str(runs["dir"] / f"{key}_ck")))
    got = mw.flat(train_state_to_flax(one.state))
    for k, v in got.items():
        np.testing.assert_array_equal(v, runs[f"{key}/{k}"], err_msg=k)
    assert bool(runs[f"{key}/reloaded_equal"])
