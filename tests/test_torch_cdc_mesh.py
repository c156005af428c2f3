"""The port's CDC engine on a (data, model) mesh (CDCTrainer(mesh=,
shardings=), over gloo on the CPU) against its one-device run, as
tests/test_cdc_e2e.py:213-244 holds tpurec's mesh to tpurec's one
device.

One spawn per world (tests/test_torch_mesh_worker.py's ``cdc`` task): 4
ranks run one update_matrix_cdc on (2, 2), resident and "stream",
without and with expert parallelism, and one in 4 row lanes
(``cdc.parallel_rows``) without and with it; 2 ranks run CDCTrainer.fit on
(2, 1) (two matrix updates), its exact eval and both checkpoints.

Data: make_synthetic(3500 rows, 6 fields, 4 domains, 2 domain clusters)
at bs=256 with 8 causal-mask rows, and with 4 in one update with and
without expert parallelism: there the causal distances of the 4 domains
tie (domains 0 and 3 lie at one distance from each other and at 0 from
1 and 2), so matrices moved by 1e-7 already cluster {0} or {3} apart,
and the clustering is held only where matrices within the tolerance
cluster alike.  Limits: the matrices atol 5e-5 (tests/test_cdc_e2e.py's),
the same clustering; a checkpoint restored onto one device evaluates
within 1e-6 of the mesh.
It runs at wd = 1e-3: at the default wd a bias feeding a training
BatchNorm steps by up to lr on the rounding of its zero gradient, which
reaches the probe evals through the running mean (ROADMAP.md queue 3).
"""

import types

import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec.cdc import CDCTrainer as JaxCDCTrainer
from tpurec_torch.cdc import CDCTrainer
from tpurec_torch.parallel.mesh import Mesh

MATRIX_ATOL, EVAL_TOL = 5e-5, 1e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("cdc_mesh")
    mw.spawn("cdc", 4, str(out))
    mw.spawn("cdc", 2, str(out))
    res = {"dir": out}
    for w in (2, 4):
        with np.load(out / f"cdc_{w}.npz") as z:
            res.update({k: z[k] for k in z.files})
    return res


@pytest.fixture(scope="module")
def data():
    return mw.cdc_data()


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def one_update(data):
    torch.set_num_threads(1)
    tr = mw.cdc_trainer(mw.cdc_config(), data)
    tr.setup_data(data.train, data.valid)
    tr.update_matrix_cdc(1)
    return mw.cluster_of(tr)


@pytest.mark.parametrize("ep", ["dp", "ep"])
@pytest.mark.parametrize("placement", ["resident", "stream"])
def test_update_matrix_on_2x2_matches_one_device(runs, one_update,
                                                 placement, ep):
    """(2, 2), ``ep`` "ep" with the MMoE base's 4 experts split 2 a
    rank: the matrix rows and the clustering of one update."""
    key = f"{placement}_{ep}"
    assert bool(runs[f"{key}/resident"]) == (placement == "resident")
    for m in ("mask", "A", "B"):
        np.testing.assert_allclose(runs[f"{key}/{m}"], one_update[m],
                                   rtol=0, atol=MATRIX_ATOL,
                                   err_msg=f"{key} {m}")
    np.testing.assert_array_equal(runs[f"{key}/d2g"], one_update["d2g"])
    assert len(set(one_update["d2g"].tolist())) == 2


@pytest.fixture(scope="module")
def one_update_few(data):
    torch.set_num_threads(1)
    with mw.kmeans_seeds() as seeds:
        tr = mw.cdc_trainer(mw.cdc_config(mask_rows=mw.CDC_FEW_MASK_ROWS),
                            data)
        tr.setup_data(data.train, data.valid)
        tr.update_matrix_cdc(1)
    return {**mw.cluster_of(tr), "seeds": np.asarray(seeds)}


@pytest.mark.parametrize("ep", ["dp", "ep"])
def test_update_matrix_with_few_mask_rows_on_2x2(runs, one_update_few, ep):
    """(2, 2) with 4 causal-mask rows: the matrices as above; the
    clustering is held where matrices moved by the tolerance cluster
    alike, and else each side's must be its own matrices' (a tie)."""
    key, one = f"few_{ep}", one_update_few
    for m in ("mask", "A", "B"):
        np.testing.assert_allclose(runs[f"{key}/{m}"], one[m], rtol=0,
                                   atol=MATRIX_ATOL, err_msg=f"{key} {m}")
    np.testing.assert_array_equal(runs[f"{key}/seeds"], one["seeds"])
    seed = int(one["seeds"][0])
    own, moved = mw.clustering_tie(one["mask"], 2, seed, MATRIX_ATOL)
    mesh_own, _ = mw.clustering_tie(runs[f"{key}/mask"], 2, seed,
                                    MATRIX_ATOL, draws=0)
    assert own == tuple(one["d2g"].tolist())
    assert mesh_own == tuple(runs[f"{key}/d2g"].tolist())
    if len(moved) == 1:
        np.testing.assert_array_equal(runs[f"{key}/d2g"], one["d2g"])
    else:
        print(f"{key}: the clustering ties within {MATRIX_ATOL}: {moved}; "
              f"mesh {runs[f'{key}/d2g'].tolist()}, one device "
              f"{one['d2g'].tolist()}")


@pytest.fixture(scope="module")
def one_update_lanes(data):
    torch.set_num_threads(1)
    tr = mw.cdc_trainer(mw.cdc_config(lanes=mw.CDC_LANES), data)
    tr.setup_data(data.train, data.valid)
    tr.update_matrix_cdc(1)
    return mw.cluster_of(tr)


@pytest.mark.parametrize("ep", ["dp", "ep"])
def test_lanes_on_2x2_match_one_devices_lanes(runs, one_update_lanes, ep):
    """(2, 2), the update in row lanes (``parallel_rows`` 4; each lane's
    step rows split over the data ranks, its table its copy of the
    rank's shard): the matrix rows and the clustering of one device's
    lanes."""
    key = f"lanes_{ep}"
    for m in ("mask", "A", "B"):
        np.testing.assert_allclose(runs[f"{key}/{m}"], one_update_lanes[m],
                                   rtol=0, atol=MATRIX_ATOL,
                                   err_msg=f"{key} {m}")
    np.testing.assert_array_equal(runs[f"{key}/d2g"],
                                  one_update_lanes["d2g"])


@pytest.fixture(scope="module")
def one_fit(data):
    torch.set_num_threads(1)
    tr = mw.cdc_trainer(mw.cdc_config(), data)
    out = tr.fit(data.train, data.valid)
    return tr, out


def test_fit_on_2x1_gives_one_devices_clustering(runs, one_fit):
    _, out = one_fit
    assert out["domain2group_list"] == runs["fit/d2g"].tolist()
    assert out["s_group2domain_list"] == eval(str(runs["fit/s_groups"]))
    assert abs(float(runs["fit/valid_total_auc"])
               - out["valid"]["total_auc"]) < 1e-3


@pytest.mark.parametrize("how", ["pickle", "async"])
def test_mesh_checkpoint_restores_onto_one_device(runs, data, how):
    """The (2, 1) fit's checkpoint (gathered, rank 0 writes) into a
    one-device CDCTrainer: its exact valid eval is the mesh's, and the
    clustering rides along."""
    tr = mw.cdc_trainer(mw.cdc_config(), data)
    tr.setup_data(data.train, data.valid)
    if how == "pickle":
        tr.load_checkpoint(str(runs["dir"] / "cdc_mesh.pkl"))
    else:
        meta = tr.load_versioned(tr.make_checkpointer(
            str(runs["dir"] / "cdc_ck")))
        assert meta["extra"] == {"s": 1}
    ev = tr.evaluate(tr.valid_batcher)
    for k in ("total_auc", "total_loss"):
        assert abs(ev[k] - float(runs[f"fit/exact_{k}"])) <= EVAL_TOL, k
    assert tr.cluster.domain2group_list == runs["fit/d2g"].tolist()


@pytest.mark.parametrize("n_data,bs", [(2, 255), (3, 256), (4, 258)])
def test_width_that_does_not_divide_the_data_axis_raises(data, n_data, bs):
    mesh = Mesh(n_data, 1, 0, torch.device("cpu"), "none")
    with pytest.raises(ValueError, match=f"bs = {bs} does not split"):
        CDCTrainer(mw.cdc_config(bs=bs), data.field_dims, data.n_domain,
                   data.domain_idx, mesh=mesh)


@pytest.mark.parametrize("on_mesh", [False, True])
@pytest.mark.parametrize("mode", ["auto", "resident", "stream"])
@pytest.mark.parametrize("nbytes", [1 << 20, 256 << 20, (256 << 20) + 1,
                                    4 << 30, (4 << 30) + 1])
def test_placement_follows_tpurecs_budgets(mode, on_mesh, nbytes):
    assert CDCTrainer.MESH_RESIDENT_BUDGET == \
        JaxCDCTrainer.MESH_RESIDENT_BUDGET
    assert CDCTrainer.RESIDENT_BUDGET == JaxCDCTrainer.RESIDENT_BUDGET
    cfg = mw.cdc_config(mode)

    def on(cls):
        return types.SimpleNamespace(
            cfg=cfg, mesh=object() if on_mesh else None,
            RESIDENT_BUDGET=cls.RESIDENT_BUDGET,
            MESH_RESIDENT_BUDGET=cls.MESH_RESIDENT_BUDGET)

    assert CDCTrainer._decide_placement(on(CDCTrainer), nbytes) == \
        JaxCDCTrainer._decide_placement(on(JaxCDCTrainer), nbytes)
