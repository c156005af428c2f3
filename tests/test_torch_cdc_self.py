"""The port's CDC engine against itself (plain versions on the CPU): the
rollback's asymmetry, stream placement against resident, streaming eval
against exact, reproducible fits, the cdc-plus knobs, the checkpoints'
round trips and artifacts, and the options that are not ported.

The counterparts of tests/test_cdc_e2e.py and tests/test_cdc_plus.py, at
the data and widths of tests/test_torch_cdc_engine.py; streaming eval is
held to test_cdc_e2e.py:56-69's limits."""

import os

import numpy as np
import pytest
import torch

from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.cdc.algorithm import CDCClusterState, update_group
from tpurec_torch.config import CDCConfig, Config, ModelConfig, TrainConfig
from tpurec_torch.data import make_synthetic
from tpurec_torch.utils import read_matrix_xlsx

MODEL = dict(model="cdc", embed_dim=8, mlp_dims=(32, 16), atten_embed_dim=8,
             att_layer_num=1, dropout=0.2)
CDC = dict(base_model="mmoe", n_cluster=2, n_causal_mask=4, warmup_step=1,
           update_matrix_step=1, update_interval=2, cdc_tower_dims=(16,))
TRAIN = dict(bs=256, epoch=1, seed=0)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return make_synthetic(n_rows=3500, n_fields=6, n_domain=4, domain_idx=3,
                          seed=1, domain_cluster_k=2)


def _cfg(model=None, train=None, **cdc):
    return Config(model=ModelConfig(**{**MODEL, **(model or {})}),
                  cdc=CDCConfig(**{**CDC, **cdc}),
                  train=TrainConfig(**{**TRAIN, **(train or {})}))


def _trainer(data, cfg=None, **kw):
    return CDCTrainer(cfg or _cfg(), data.field_dims, data.n_domain,
                      data.domain_idx, device="cpu", **kw)


def _tensors(tr):
    return {k: t.detach().clone() for k, t in tr.model.state_dict().items()}


def _moments(tr):
    out = {"emb.m": tr.state.emb_opt.m.clone(),
           "emb.v": tr.state.emb_opt.v.clone()}
    for i, p in enumerate(tr.state.optimizer.state):
        st = tr.state.optimizer.state[p]
        out[f"{i}.exp_avg"] = st["exp_avg"].clone()
        out[f"{i}.exp_avg_sq"] = st["exp_avg_sq"].clone()
        out[f"{i}.step"] = st["step"].clone()
    return out


def test_rollback_restores_params_not_moments(data):
    tr = _trainer(data)
    tr.setup_data(data.train, data.valid)
    tr._train_burst(1, 2)                    # moments exist before the burst
    p0, table, gather = _tensors(tr), tr.model.embedding.table, \
        tr.emb_upd._gather
    step0 = tr.state.step
    tr.save_model_state()
    tr._train_burst([0, 1, 2, 3], 2)         # perturb: 8 batches, 2 steps
    assert tr.state.step == step0 + 2
    p1 = _tensors(tr)
    assert not torch.equal(p0["embedding.table"], p1["embedding.table"])
    after_burst = _moments(tr)
    tr.load_model_state()
    p2 = _tensors(tr)
    assert set(p2) == set(p0)
    for k in p0:                             # parameters and BN buffers
        assert torch.equal(p2[k], p0[k]), k
    # in place: the table is the tensor the prepared gather serves
    assert tr.model.embedding.table is table
    assert tr.emb_upd._gather is gather
    # the optimizers' moments and the step are NOT rolled back
    # (cdc.py:344-350 snapshots the base model only)
    now = _moments(tr)
    for k in after_burst:
        assert torch.equal(now[k], after_burst[k]), k
    assert tr.state.step == step0 + 2


def test_populate_rolls_back_every_row_and_skips_gated_steps(data):
    tr = _trainer(data)
    tr.setup_data(data.train, data.valid)
    k = tr._scaled_update_matrix_step()
    K = tr._burst_k_max(k)
    p0, step0 = _tensors(tr), tr.state.step
    bidx, bmask, bvalid = tr._multi_burst_sched([0, 1], k, K)
    assert 0 < bvalid.sum() < K              # gated steps at the tail
    eidx, emask = tr._eval_sched()
    rows = tr._run_populate_async(bidx[None].repeat(2, 0),
                                  bmask[None].repeat(2, 0),
                                  bvalid[None].repeat(2, 0),
                                  eidx[None].repeat(2, 0),
                                  emask[None].repeat(2, 0))
    assert rows.shape == (2, data.n_domain)
    assert torch.isfinite(rows).all()
    for key, t in _tensors(tr).items():
        assert torch.equal(t, p0[key]), key
    assert tr.state.step == step0 + 2 * int(bvalid.sum())
    # the second row starts from the rolled-back parameters with the
    # first row's moments: another burst, another row
    assert not torch.equal(rows[0], rows[1])
    empty = tr._run_populate_async(bidx[:0], bmask[:0], bvalid[:0],
                                   eidx[None][:0], emask[None][:0])
    assert empty.shape == (0, data.n_domain)


def test_stream_placement_matches_resident_bitwise(data):
    res = _trainer(data, _cfg(data_placement="resident"))
    res.setup_data(data.train, data.valid)
    assert res._resident and res.Xhost is None
    srm = _trainer(data, _cfg(data_placement="stream"))
    srm.setup_data(data.train, data.valid)
    assert not srm._resident and srm.Xdev is None
    for t in (res, srm):
        t.update_matrix_cdc(1)
        t.train_cdc_epoch(1)
    for name in ("matrix_mask", "matrix_A", "matrix_B", "matrix_causal"):
        np.testing.assert_array_equal(getattr(res.cluster, name),
                                      getattr(srm.cluster, name))
    assert res.cluster.domain2group_list == srm.cluster.domain2group_list
    assert res.snapshot_bytes() == srm.snapshot_bytes()


def test_placement_rules(data):
    tr = _trainer(data)
    assert tr._decide_placement(1 << 20)
    assert not tr._decide_placement(tr.RESIDENT_BUDGET + 1)
    assert tr.RESIDENT_BUDGET == 4 << 30
    bad = _trainer(data, _cfg(data_placement="nowhere"))
    with pytest.raises(ValueError, match="data_placement"):
        bad.setup_data(data.train)


def test_streaming_eval_matches_exact(data):
    tr = _trainer(data)
    tr.fit(data.train, data.valid)
    exact = tr.evaluate(tr.valid_batcher)
    stream = tr.evaluate_streaming(tr.valid_batcher)
    assert abs(stream["total_auc"] - exact["total_auc"]) < 5e-4
    assert abs(stream["total_loss"] - exact["total_loss"]) < 1e-5
    assert abs(stream["mean_auc"] - exact["mean_auc"]) < 1e-3
    assert set(stream["domain_auc"]) == set(exact["domain_auc"])
    for d in exact["domain_auc"]:
        assert abs(stream["domain_auc"][d] - exact["domain_auc"][d]) < 2e-3
    streaming = _trainer(data, _cfg(train={"eval_streaming": True}))
    assert streaming._use_streaming_eval and not tr._use_streaming_eval


def test_fit_is_reproducible(data):
    outs = []
    for _ in range(2):
        tr = _trainer(data, _cfg(train={"epoch": 2}))
        logs = []
        out = tr.fit(data.train, data.valid, test=data.test,
                     log_fn=logs.append)
        for r in (out["valid"], out["test"]):
            r.pop("epoch_seconds", None)
        outs.append((out, tr.snapshot_bytes(),
                     [l.get("train_loss", l.get("domain2group"))
                      for l in logs], tr._cluster_payload()))
    (o1, s1, l1, c1), (o2, s2, l2, c2) = outs
    assert repr(o1) == repr(o2)              # NaN-tolerant
    assert s1 == s2
    assert l1 == l2
    assert repr(c1) == repr(c2)
    labels = o1["domain2group_list"]
    assert len(labels) == data.n_domain and set(labels) <= {0, 1}
    assert len(o1["s_group2domain_list"]) == 2
    assert 0.0 < o1["valid"]["total_auc"] <= 1.0
    assert np.isfinite(o1["valid"]["mean_auc"])


def test_fit_runs_the_scaled_update_and_warms_nothing(data):
    """fit passes warm_compile and every update the batch-size-scaled
    burst length (run.py:601-604); warm_compile itself does nothing."""
    tr = _trainer(data)
    seen = []
    orig = tr.update_matrix_cdc
    tr.warm_compile(1)                       # no-op, public
    tr.warm_compile = lambda k: seen.append(("warm", k))
    tr.update_matrix_cdc = lambda k: (seen.append(("update", k)), orig(k))
    tr.fit(data.train, data.valid)
    assert tr._scaled_update_matrix_step() == 4       # 1 * 1024 // 256
    assert seen == [("warm", 4), ("update", 4), ("update", 4)]
    zero = _trainer(data, _cfg(update_matrix_step=0))
    assert zero._scaled_update_matrix_step() == 0


def test_probe_eval_batches_widens_eval_sched(data):
    tr = _trainer(data, _cfg(probe_eval_batches=3))
    tr.setup_data(data.train, data.valid)
    idx, mask = tr._eval_sched()
    assert idx.shape == mask.shape == (data.n_domain, 3 * 256)
    Xtr = data.train[0]
    assert (idx[mask > 0] < len(Xtr)).all()
    for d in range(data.n_domain):
        rows = idx[d][mask[d] > 0]
        assert (Xtr[rows, data.domain_idx] == d).all()
        assert mask[d].sum() > 256
    default = _trainer(data)
    default.setup_data(data.train, data.valid)
    assert default._eval_sched()[0].shape == (data.n_domain, 256)


def test_freeze_after_updates_stops_reclustering(data):
    tr = _trainer(data, _cfg(freeze_after_updates=1))
    out = tr.fit(data.train, data.valid)
    assert tr.cluster.call_update_group == 1    # the boundary at 7 skipped
    assert np.isfinite(out["valid"]["total_auc"])
    both = _trainer(data, _cfg(probe_eval_batches=2, mask_ema=0.5,
                               freeze_after_updates=1))
    out = both.fit(data.train, data.valid)
    assert both.cluster.call_update_group == 1
    assert np.isfinite(out["valid"]["total_auc"])
    assert np.isfinite(both.cluster.matrix_mask).all()


def _mini_state(n_domain=4, n_cluster=2, n_mask=5, seed=0, **cfg_kw):
    cfg = CDCConfig(base_model="mmoe", n_cluster=n_cluster,
                    n_causal_mask=n_mask, **cfg_kw)
    st = CDCClusterState.create(n_domain, n_cluster, cfg)
    rng = np.random.default_rng(seed)
    st.matrix_A = rng.random((n_domain + 1, n_domain))
    st.matrix_B = rng.random((n_domain + n_cluster, n_domain))
    st.matrix_mask = rng.random((n_mask, n_domain))
    return cfg, st, rng


@pytest.mark.parametrize("ema", [0.0, 0.5])
def test_mask_ema(ema):
    """mask_ema blends the raw mask across updates; 0 uses each update's
    raw mask untouched (the reference rebuilds it, cdc.py:131-134)."""
    cfg, st, rng = _mini_state(mask_ema=ema)
    w = np.ones(st.n_domain) / st.n_domain
    first = st.matrix_mask.copy()
    update_group(st, cfg, w, kmeans_seed=0)
    np.testing.assert_allclose(st.old_matrix_mask, first)
    second = rng.random(first.shape)
    st.matrix_mask = second.copy()
    st.matrix_A = rng.random(st.matrix_A.shape)
    st.matrix_B = rng.random(st.matrix_B.shape)
    update_group(st, cfg, w, kmeans_seed=0)
    np.testing.assert_allclose(st.old_matrix_mask,
                               ema * first + (1 - ema) * second)


def test_checkpoint_roundtrip(tmp_path, data):
    tr = _trainer(data)
    tr.setup_data(data.train, data.valid)
    tr._train_burst(0, 2)
    tr.cluster.domain2group = np.array([0, 1, 0, 1])
    tr.cluster.t_group2domain_list = [[0, 2], [1, 3]]
    tr.cluster.s_group2domain_list = [[0, 2], [1, 3, 0]]
    tr.cluster.call_update_group = 3
    path = str(tmp_path / "cdc.pkl")
    tr.save_checkpoint(path, extra={"note": 1})
    tr2 = _trainer(data)
    payload = tr2.load_checkpoint(path)
    assert payload["extra"] == {"note": 1}
    assert payload["config"]["model"]["model"] == "cdc"
    assert tr2.cluster.domain2group_list == [0, 1, 0, 1]
    assert tr2.cluster.s_group2domain_list == [[0, 2], [1, 3, 0]]
    assert tr2.cluster.call_update_group == 3
    assert tr2.snapshot_bytes() == tr.snapshot_bytes()
    # setup_data after the restore must NOT clobber the restored cluster
    tr2.setup_data(data.train, data.valid)
    assert tr2.cluster.call_update_group == 3

    be = tr.make_checkpointer(str(tmp_path / "v"), max_to_keep=2)
    for step in (1, 2, 3):
        tr.save_versioned(be, step, extra={"s": step})
    assert sorted(be.all_steps()) == [2, 3]
    tr3 = _trainer(data)
    meta = tr3.load_versioned(be)
    assert meta["extra"] == {"s": 3}
    assert tr3.cluster.s_group2domain_list == [[0, 2], [1, 3, 0]]
    assert tr3.snapshot_bytes() == tr.snapshot_bytes()
    orbax = _trainer(data, _cfg(train={"checkpoint_backend": "orbax"}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        orbax.make_checkpointer(str(tmp_path / "o"))


def test_matrix_artifacts(tmp_path, data):
    cfg = _cfg(train={"save_path": str(tmp_path)},
               save_matrix_artifacts=True)
    tr = _trainer(data, cfg)
    tr.setup_data(data.train, data.valid)
    tr.update_matrix_cdc(1)
    out = tmp_path / "cdc_matrices"
    for name, m in (("matrix_A", tr.cluster.matrix_A),
                    ("matrix_mask", tr.cluster.matrix_mask),
                    ("causal_matrix", tr.cluster.matrix_causal)):
        np.testing.assert_array_equal(
            np.loadtxt(out / f"{name}_step1.csv", delimiter=",",
                       ndmin=2), m)
        np.testing.assert_array_equal(
            read_matrix_xlsx(str(out / f"{name}_step1.xlsx")), m)
    assert os.path.exists(out / "matrix_B_step1.xlsx")


def test_unported_and_invalid_options_raise(data):
    args = (data.field_dims, data.n_domain, data.domain_idx)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CDCTrainer(_cfg(), *args, mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CDCTrainer(_cfg(parallel_rows=4), *args, device="cpu")
    # bf16 compute is ported; a dtype that names nothing raises
    bf = CDCTrainer(_cfg(train={"compute_dtype": "bfloat16"}), *args,
                    device="cpu")
    assert bf.train_step.tcfg.compute_dtype == "bfloat16"
    with pytest.raises(ValueError, match="compute_dtype"):
        CDCTrainer(_cfg(train={"compute_dtype": "float16"}), *args,
                   device="cpu")
    for base in ("ple", "pepnet", "epnet", "star"):    # CDC's other bases
        other = CDCTrainer(_cfg(base_model=base), *args, device="cpu")
        assert type(other.model).__name__ == {
            "ple": "PLE", "pepnet": "PEPNet", "epnet": "PEPNet",
            "star": "STAR"}[base]
        assert other.model.n_tower == 2
    with pytest.raises(AssertionError):
        CDCTrainer(_cfg(base_model="dcn"), *args, device="cpu")
    with pytest.raises(ValueError, match="sparse"):
        CDCTrainer(_cfg(train={"embedding_update": "sparse"}), *args,
                   device="cpu")
    dense = CDCTrainer(_cfg(train={"embedding_update": "dense"}), *args,
                       device="cpu")             # runs the hybrid update
    dense.setup_data(data.train)
    dense._train_burst(0, 1)
    assert dense.state.step == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CDCTrainer(_cfg(), *args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CDCTrainer(_cfg(), *args, device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        dense.emb_upd.update_stacked()
