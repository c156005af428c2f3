"""``python -m tpurec_torch.cli --model cdc`` against ``python -m
tpurec.cli --model cdc`` on the CPU: at a tiny schedule and tiny widths,
from one initial state, the same clustering (the rest of the CLI's tests
are in tests/test_torch_cli.py)."""

import functools
import pickle

import numpy as np
import pytest
import torch

import tpurec.cdc
import tpurec.cli as jcli
import tpurec.data
import tpurec_torch.cli as pcli
import tpurec_torch.data
from test_torch_cli import AUC_TOL, LOSS_TOL, P_ATOL, _patch_config
from tpurec.serve import predictor_from_checkpoint as jax_predictor_from_ckpt
from tpurec_torch.serve import predictor_from_checkpoint


CDC = ["--model", "cdc", "--dataset_name", "synthetic", "--n_rows", "3500",
       "--n_domain", "4", "--epoch", "1", "--bs", "256", "--is_set_seed",
       "1", "--seed", "1", "--embed_dim", "8", "--n_cluster", "2",
       "--n_causal_mask", "4", "--warmup_step", "1", "--update_matrix_step",
       "1", "--update_interval", "2", "--mesh_data", "-1"]
CDC_MODEL = dict(mlp_dims=(32, 16), atten_embed_dim=8, att_layer_num=1,
                 mmoe_expert_dims=(32, 16), mmoe_tower_dims=(16,),
                 dropout=0.0)


@pytest.fixture(scope="module")
def cdc_runs(tmp_path_factory):
    """Both CLIs resume one initial CDC state (tpurec's, after setup_data)
    at tiny widths, on synthetic data with 2 domain clusters as
    tests/test_torch_cdc_fit.py (CDC's probe rows differ across packages
    by up to 1.7e-4 at the default wd, which decides a clustering of
    domains without structure).  -> (tpurec's output, the port's)."""
    return run_cdc_clis(tmp_path_factory.mktemp("cdc"))


def run_cdc_clis(tmp, extra=()):
    """:func:`cdc_runs`'s two CLI runs in ``tmp``, ``extra`` appended to
    the argv of both."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _patch_config(mp, model=CDC_MODEL, cdc={"cdc_tower_dims": (16,)})
        for mod in (tpurec.data, tpurec_torch.data):
            mp.setattr(mod, "make_synthetic", functools.partial(
                mod.make_synthetic, domain_cluster_k=2))
        cfg = jcli.build_config(jcli.parse_args(CDC))
        np.random.seed(cfg.train.seed)
        train, valid, test, fd, nd, di = jcli.load_dataset(cfg)
        jtr = tpurec.cdc.CDCTrainer(cfg, fd, nd, di)
        jtr.setup_data(train, valid, test)
        start = str(tmp / "start.pkl")
        jtr.save_checkpoint(start)
        argv = CDC + list(extra) + ["--resume", start]
        oj = jcli.main(argv + ["--save_path", str(tmp / "j")])
        op = pcli.main(argv + ["--save_path", str(tmp / "p"),
                               "--device", "cpu"])
    torch.set_num_threads(n)
    return oj, op


def test_cdc_gives_tpurecs_clustering(cdc_runs):
    oj, op = cdc_runs
    assert op["domain2group_list"] == oj["domain2group_list"]
    assert op["s_group2domain_list"] == oj["s_group2domain_list"]
    assert len(set(op["domain2group_list"])) == 2


def test_cdc_result_matches_tpurec(cdc_runs):
    oj, op = cdc_runs
    for split in ("valid", "test"):
        assert abs(op[split]["total_auc"] - oj[split]["total_auc"]) <= AUC_TOL
        assert abs(op[split]["total_loss"]
                   - oj[split]["total_loss"]) <= LOSS_TOL
        assert set(op[split]["domain_auc"]) == set(oj[split]["domain_auc"])


def test_cdc_checkpoint_serves_in_tpurec(cdc_runs):
    """The port's CLI checkpoint carries its clustering and serves in
    tpurec's Predictor within 1e-5 of the port's."""
    _, op = cdc_runs
    path = op["checkpoint"]
    assert path.endswith("cdc_synthetic_seed1.pkl")
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert payload["domain2group_list"] == op["domain2group_list"]
    rng = np.random.default_rng(3)
    X = np.stack([rng.integers(0, d, 200) for d in payload["field_dims"]],
                 1).astype(np.int32)
    want = predictor_from_checkpoint(path, batch_sizes=(128,),
                                     device="cpu")(X)
    got = jax_predictor_from_ckpt(path, batch_sizes=(128,))(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)
