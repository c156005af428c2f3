"""CDC's cadence on the (data, model) mesh as its users run it, over gloo
on the CPU (tests/test_torch_mesh_worker.py's ``cadence`` task, one spawn
per world): on (2, 2), CDCTrainer.fit with three matrix updates a fit,
"resident" and "stream", serially and in 2 row lanes, from tpurec's
initial state, each held update by update against tpurec's
CDCTrainer(mesh=) fit on its virtual (2, 2) mesh; the placement "auto"
chooses with the mesh budget lowered below the split; and on (2, 1) and
(1, 2) one update against one device.  The experts stay whole here
(tests/test_torch_cdc_mesh.py splits them for one update; chip_smoke.py
phase 26 runs these fits with them split).

Data and model: tests/test_torch_cdc_mesh.py's (3,500 rows, 4 domains,
the MMoE base at tiny widths, wd 1e-3, dropout 0) with 4 causal-mask
rows, bs 512 and an update every 2 steps for the fits (bs 256 for the
one update).  "stream" must equal
"resident" bitwise: the same rows reach the same steps in the same
order, whether each rank holds the split on its device or gathers a
window of it from its host copy.  Against tpurec: the same clustering
after every update, the matrices within TPUREC_ATOL (1e-5; over the
three updates, serially and in lanes, the port's mesh fits part from
tpurec's by up to 1.73e-6, and tpurec's own mesh from its one device by
up to 1.67e-6).
"""

import concurrent.futures
import dataclasses

import flax.serialization as fser
import jax
import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec.cdc import CDCTrainer as JaxCDCTrainer
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.parallel import Shardings, make_mesh

FITS = [f"{p}_{n}" for n in (0, mw.CADENCE_LANES)
        for p in ("resident", "stream")]
# One update from the initial state against one device (tolerances are
# the spreads measured on the CPU, 1 thread a rank): on (1, 2) the table's
# row shards and their exchange give one device's matrices bitwise; on
# (2, 1) the data split parts by 1.19e-7, 1.19e-7, 5.96e-8 (mask, A, B),
# as one device parts from itself with its rows in another order
# (1.19e-7, 0 to 5.96e-8, 5.96e-8 over 4 seeded orders): a float32
# rounding at 1.
PARTING_ATOL = {"1x2": 0.0, "2x1": 1.2e-7}
TPUREC_ATOL = 1e-5


def _tpurec_trainer(data, lanes):
    """tpurec's CDCTrainer at :func:`mw.cadence_config`'s settings on a
    (2, 2) mesh of the virtual CPU devices, the experts whole."""
    cfg = mw.cadence_config("resident", lanes)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    jcfg = JaxConfig(
        model=JaxModelConfig(**mw.CDC_MODEL),
        cdc=JaxCDCConfig(**dataclasses.asdict(cfg.cdc)),
        train=JaxTrainConfig(bs=cfg.train.bs, epoch=cfg.train.epoch,
                             seed=cfg.train.seed, wd=cfg.train.wd))
    return JaxCDCTrainer(jcfg, data.field_dims, data.n_domain,
                         data.domain_idx, mesh=mesh,
                         shardings=Shardings(mesh))


def _tpurec_fit(tr, data):
    """``tr.fit``, recording each update's matrices and clustering."""
    rec = {"mask": [], "A": [], "B": [], "d2g": []}
    update = tr.update_matrix_cdc

    def update_(k):
        update(k)
        st = tr.cluster
        for m, v in (("mask", st.matrix_mask), ("A", st.matrix_A),
                     ("B", st.matrix_B)):
            rec[m].append(np.array(v))
        rec["d2g"].append(list(st.domain2group_list))

    tr.update_matrix_cdc = update_
    tr.fit(data.train, data.valid)
    return {k: np.asarray(v) for k, v in rec.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' records, the (2, 1) / (1, 2) partings and tpurec's mesh
    fits by lanes.  tpurec fits while the ranks run."""
    out = tmp_path_factory.mktemp("cdc_cadence")
    data = mw.cdc_data()
    jtrs = {n: _tpurec_trainer(data, n) for n in (0, mw.CADENCE_LANES)}
    init = fser.to_bytes(jtrs[0].state)
    assert fser.to_bytes(jtrs[mw.CADENCE_LANES].state) == init
    (out / mw.CADENCE_INIT).write_bytes(init)

    def spawn():
        mw.spawn("cadence", 4, str(out))
        mw.spawn("cadence", 2, str(out))

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks_done = pool.submit(spawn)
        tpurec = {n: _tpurec_fit(tr, data) for n, tr in jtrs.items()}
        ranks_done.result()
    ranks = []
    for r in range(4):
        with np.load(out / f"cadence_{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    with np.load(out / "parting.npz") as z:
        parting = {k: z[k] for k in z.files}
    return ranks, parting, tpurec


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("lanes", [0, mw.CADENCE_LANES],
                         ids=["serial", "lanes"])
def test_stream_is_bitwise_resident_over_every_update(runs, lanes):
    """Every hybrid step's loss, each update's matrices, k-means seed
    and clustering, and the gathered final state, on every rank."""
    ranks = runs[0]
    res, st = f"resident_{lanes}", f"stream_{lanes}"
    for r, rec in enumerate(ranks):
        assert rec[f"{res}/resident"] and not rec[f"{st}/resident"]
        assert len(rec[f"{res}/d2g"]) == mw.CADENCE_UPDATES
        for k in ("losses", "mask", "A", "B", "d2g", "seeds", "state"):
            np.testing.assert_array_equal(rec[f"{st}/{k}"], rec[f"{res}/{k}"],
                                          err_msg=f"rank {r} {k}")


@pytest.mark.parametrize("fit", FITS)
def test_every_rank_holds_rank_0s_clustering(runs, fit):
    """After each update every rank holds rank 0's clustering, from the
    same matrices and k-means seed."""
    ranks = runs[0]
    for r, rec in enumerate(ranks[1:], 1):
        for k in ("d2g", "seeds", "mask", "A", "B"):
            np.testing.assert_array_equal(rec[f"{fit}/{k}"],
                                          ranks[0][f"{fit}/{k}"],
                                          err_msg=f"rank {r} {k}")


def test_lanes_start_as_the_serial_rows(runs):
    """The first update starts both fits from one state: lane row 0 is
    serial row 0 bitwise; later updates start from states that differ
    (the serial rows carry their moments on), so their clusterings may
    too."""
    rec = runs[0][0]
    lane, serial = (rec[f"resident_{n}/mask"] for n in (mw.CADENCE_LANES, 0))
    np.testing.assert_array_equal(lane[0][0], serial[0][0])


@pytest.mark.parametrize("fit", FITS)
def test_fit_matches_tpurecs_mesh_fit(runs, fit):
    """Each fit against tpurec's CDCTrainer(mesh=) fit from the same
    initial state, serial or in as many lanes: every update's clustering,
    and its matrices within TPUREC_ATOL."""
    ranks, _, tpurec = runs
    want = tpurec[int(fit.split("_")[1])]
    rec = ranks[0]
    print(f"{fit} vs tpurec's mesh, by update: " + str(  # pytest -s
        [[float(np.abs(rec[f"{fit}/{m}"][u] - want[m][u]).max())
          for m in ("mask", "A", "B")] for u in range(len(want["d2g"]))]))
    np.testing.assert_array_equal(rec[f"{fit}/d2g"], want["d2g"])
    for m in ("mask", "A", "B"):
        np.testing.assert_allclose(rec[f"{fit}/{m}"], want[m], rtol=0,
                                   atol=TPUREC_ATOL, err_msg=f"{fit} {m}")


@pytest.mark.parametrize("budget", ["lowered", "default"])
def test_auto_streams_a_split_over_the_mesh_budget(runs, budget):
    """``data_placement="auto"`` streams the 88 kB split once the
    instance's MESH_RESIDENT_BUDGET is below it, on every rank."""
    for rec in runs[0]:
        assert bool(rec[f"auto_{budget}/resident"]) == (budget == "default")


@pytest.fixture(scope="module")
def one_update():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    data = mw.cdc_data()
    tr = mw.cdc_trainer(mw.cdc_config(), data)
    tr.setup_data(data.train, data.valid)
    tr.update_matrix_cdc(1)
    torch.set_num_threads(n)
    return mw.cluster_of(tr)


@pytest.mark.parametrize("shape", ["2x1", "1x2"])
def test_one_update_parts_from_one_device_as_measured(runs, one_update,
                                                      shape):
    """The data split alone and the table's row shards alone: each
    matrix within the spread measured for that mesh (PARTING_ATOL), the
    same clustering."""
    parting = runs[1]
    for m in ("mask", "A", "B"):
        err = np.abs(parting[f"{shape}/{m}"] - one_update[m]).max()
        assert err <= PARTING_ATOL[shape], (shape, m, err)
    np.testing.assert_array_equal(parting[f"{shape}/d2g"], one_update["d2g"])
