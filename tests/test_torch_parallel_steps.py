"""The port's mesh steps (tpurec_torch.parallel, over gloo on the CPU)
against the port's one-device step on the global batch, and against the
JAX package's hybrid step on its virtual (2, 2) mesh.

One spawn per world (tests/test_torch_mesh_worker.py's ``steps`` task):
2 ranks run (2, 1) and (1, 2), 4 ranks (2, 2); each mesh takes 4 steps
under each of "hybrid", "dense" and "sparse", dropout 0, on
tests/test_sharding.py's MMoE with a big field added; the 2-rank world
also takes one step of STAR and ADL on (2, 1), the models with the
other batch-coupled reductions (PartitionedNorm, ADL's centres).

Limits: the JAX package's own for its mesh (tests/test_sharding.py:
57-82): losses rtol 2e-5, the table and its moments atol 2e-5.  The
data axis sums partial gradients and statistics in another order than
one device; the measured gaps are about 1e-7 (the model axis alone is
bit for bit).  STAR's and ADL's running statistics and centres are held
at the same 2e-5: without the all-reduce they are a half-batch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec_torch.convert import train_state_to_flax

LOSS_RTOL, STATE_ATOL = 2e-5, 2e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps")
    mw.spawn("steps", 2, str(out))
    mw.spawn("steps", 4, str(out))
    res = {}
    for w in (2, 4):
        with np.load(out / f"steps_{w}.npz") as z:
            res.update({k: z[k] for k in z.files})
    return res


def _one_device(update="hybrid", model=None, n=mw.STEPS):
    torch.manual_seed(0)
    tr = mw.trainer(mw.config(update, model=model))
    losses = mw.run_steps(tr, mw.global_batches(n))
    return tr, np.asarray(losses), mw.flat(train_state_to_flax(tr.state))


def _table_like(state):
    return [k for k in state if k.endswith("embedding.table")
            or k.endswith(".1.m") or k.endswith(".1.v")]


@pytest.mark.parametrize("shape", ["2x1", "1x2", "2x2"])
@pytest.mark.parametrize("update", mw.UPDATES)
def test_mesh_steps_match_one_device(runs, update, shape):
    _, losses, state = _one_device(update)
    key = f"{update}_{shape}"
    np.testing.assert_allclose(runs[f"{key}/losses"], losses,
                               rtol=LOSS_RTOL)
    names = _table_like(state)
    assert len(names) == 3, names
    for k in names:
        assert runs[f"{key}/{k}"].shape == state[k].shape, k
        np.testing.assert_allclose(runs[f"{key}/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=f"{key} {k}")
    # every leaf crossed: the gathered tree is the one-device tree's
    assert {k[len(key) + 1:] for k in runs if k.startswith(key + "/")} \
        == set(state) | {"losses"}


@pytest.mark.parametrize("name", sorted(mw.OTHERS))
def test_other_batch_reductions_one_step(runs, name):
    _, losses, state = _one_device(model=mw.OTHERS[name], n=1)
    np.testing.assert_allclose(runs[f"{name}/losses"], losses,
                               rtol=LOSS_RTOL)
    held = _table_like(state) + [k for k in state
                                 if k.startswith("model_state.")]
    assert any(k.endswith(("pn.mean", "cluster_centers")) for k in held)
    for k in held:
        np.testing.assert_allclose(runs[f"{name}/{k}"], state[k], rtol=0,
                                   atol=STATE_ATOL, err_msg=f"{name} {k}")


def test_hybrid_2x2_matches_tpurec_mesh(runs):
    """tpurec's make_hybrid_train_step on its virtual (2, 2) mesh, from
    the port's initial state carried over by tpurec_torch.convert."""
    import flax.serialization as fser

    from tpurec.config import ModelConfig as JModelConfig
    from tpurec.config import TrainConfig as JTrainConfig
    from tpurec.models import build_model as jbuild
    from tpurec.parallel import Shardings, make_mesh
    from tpurec.train.hybrid import make_hybrid_train_step
    from tpurec.train.reg import reg_coef_tree
    from tpurec.train.sparse import init_sparse_opt_state
    from tpurec.train.step import TrainState, make_optimizer

    port = mw.trainer(mw.config("hybrid"))
    tree = train_state_to_flax(port.state)
    mcfg = JModelConfig(**mw.MODEL)
    tcfg = JTrainConfig(bs=mw.BS, wd=1e-8)
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
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    sh = Shardings(mesh)
    st = jax.device_put(st, sh.state_sharding(st))
    reg = reg_coef_tree(params, "mmoe", mcfg.l2_reg_embedding,
                        mcfg.l2_reg_linear, mcfg.l2_reg_dnn)
    step, _ = make_hybrid_train_step(
        jm, tcfg, reg, True, tuple(ms), l2_reg_embedding=mcfg.l2_reg_embedding,
        optimizer=tx)
    losses = []
    with mesh:
        for i, b in enumerate(mw.global_batches()):
            gb = jax.device_put({k: jnp.asarray(x) for k, x in b.items()},
                                sh.batch_sharding(b))
            st, loss = step(st, gb, jax.random.PRNGKey(i))
            losses.append(float(loss))
    np.testing.assert_allclose(runs["hybrid_2x2/losses"], losses,
                               rtol=LOSS_RTOL)
    jt = fser.to_state_dict(jax.device_get(st))
    for k, want in (("params.embedding.table", jt["params"]["embedding"]
                     ["table"]),
                    ("opt_state.1.m", jt["opt_state"]["1"]["m"]),
                    ("opt_state.1.v", jt["opt_state"]["1"]["v"])):
        np.testing.assert_allclose(runs[f"hybrid_2x2/{k}"],
                                   np.asarray(want, np.float32), rtol=0,
                                   atol=STATE_ATOL, err_msg=k)
