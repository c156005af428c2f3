"""The port's CLI with ``--model cdc`` on a mesh and with
``--mesh_expert_parallel``: ``python -m torch.distributed.run
--nproc_per_node 2`` runs ``tpurec_torch.cli.main`` on 2 ranks over gloo
on the CPU (tests/test_torch_mesh_worker.py's ``cli`` task, dropout 0),
as ``tpurec/cli.py:317-335`` passes its mesh and
``Shardings(expert_parallel=...)`` to ``CDCTrainer``.

Two runs, each one epoch of CDC with one matrix update at tiny widths:
``cdc_2x1`` on the MMoE base with ``--mesh_data 2`` and the update in
two row lanes (``--parallel_rows 2``), and ``cdc_ple_1x2``
on the PLE base with ``--mesh_model 2 --mesh_expert_parallel`` (its
specific and shared experts split one and two a rank).  Each exits 0,
rank 0 alone prints the result and writes the checkpoint, and the
checkpoint holds the one-device shapes and loads into a one-device
CDCTrainer.
"""

import glob
import json
import pickle

import numpy as np
import pytest

import test_torch_mesh_worker as mw

ARGV = ["--device", "cpu", "--model", "cdc", "--dataset_name", "synthetic",
        "--n_rows", "2000", "--n_domain", "4", "--epoch", "1", "--bs", "256",
        "--embed_dim", "4", "--n_cluster", "2", "--n_causal_mask", "4",
        "--warmup_step", "1", "--update_matrix_step", "1",
        "--update_interval", "100", "--seed", "1", "--is_set_seed", "1"]
RUNS = {"cdc_2x1": ["--base_model", "mmoe", "--mesh_data", "2",
                    "--parallel_rows", "2"],
        "cdc_ple_1x2": ["--base_model", "ple", "--mesh_model", "2",
                        "--mesh_expert_parallel"]}
MESH = {"cdc_2x1": [2, 1], "cdc_ple_1x2": [1, 2]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, extra in RUNS.items():
        d = tmp_path_factory.mktemp(name)
        mw.spawn("cli", 2, str(d), *ARGV, *extra, "--save_path",
                 str(d / "save"), "--log_path", str(d / "log.jsonl"),
                 torchrun=True)
        with open(d / "cli_0.log") as f:
            text = f.read()
        results = [json.loads(x) for x in text.splitlines()
                   if x.startswith("{") and '"valid"' in x]
        seeds = [json.load(open(d / f"seed_{r}.json")) for r in (0, 1)]
        out[name] = dict(dir=d, text=text, results=results, seeds=seeds)
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rank0_alone_prints_the_result(runs, name):
    r = runs[name]
    assert len(r["results"]) == 1
    res = r["results"][0]
    assert 0.0 < res["valid"]["total_auc"] < 1.0
    assert len(res["domain2group_list"]) == 4
    assert set(res["domain2group_list"]) <= {0, 1}
    assert r["seeds"][0] == r["seeds"][1] == 1


@pytest.mark.parametrize("name", sorted(RUNS))
def test_mesh_record_and_one_update(runs, name):
    recs = [json.loads(x) for x in open(runs[name]["dir"] / "log.jsonl")]
    mesh = [r for r in recs if "mesh" in r]
    assert len(mesh) == 1 and mesh[0]["mesh"] == MESH[name]
    assert mesh[0]["backend"] == "gloo"
    assert sum("cdc_update_seconds" in r for r in recs) == 1


@pytest.mark.parametrize("name", sorted(RUNS))
def test_rank0_checkpoint_loads_onto_one_device(runs, name):
    from tpurec_torch.cdc import CDCTrainer
    from tpurec_torch.config import config_from_dict

    d = runs[name]["dir"]
    ckpts = glob.glob(str(d / "save" / "*"))
    assert ckpts == [str(d / "save" / "cdc_synthetic_seed1.pkl")]
    assert runs[name]["results"][0]["checkpoint"] == ckpts[0]
    with open(ckpts[0], "rb") as f:
        payload = pickle.load(f)
    cfg = config_from_dict(payload["config"])
    tr = CDCTrainer(cfg, payload["field_dims"], payload["n_domain"],
                    payload["domain_idx"], device="cpu")
    tr.load_checkpoint(ckpts[0])
    assert tr.cluster.domain2group_list == \
        runs[name]["results"][0]["domain2group_list"]
    assert np.isfinite(tr.model.get_parameter("embedding.table")
                       .detach().numpy()).all()


def test_expert_parallel_splits_ples_banks(runs):
    text = runs["cdc_ple_1x2"]["text"]
    assert ("expert parallelism over the model axis of 2: "
            "cgc_0.experts_specific (4 -> 2 a rank); cgc_0.experts_shared "
            "(2 -> 1 a rank)") in text
    assert "expert parallelism" not in runs["cdc_2x1"]["text"]
