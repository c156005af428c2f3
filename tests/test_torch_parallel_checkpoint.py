"""The port's asynchronous versioned checkpoint backend
(tpurec_torch.train.checkpoint.AsyncBackend, ``make_backend("orbax")``):
on one device here, and sharded over a (1, 2) mesh of 2 ranks (one spawn,
tests/test_torch_mesh_worker.py's ``ckpt`` task) restored onto (2, 1)
and onto one device.

- ``save`` returns before the write completes: the writer is held on an
  event, and the step is listed only once it is released and complete;
- ``max_to_keep`` holds; a half-written step (``<step>.partial/``, or a
  step directory without its ``meta.json``) is not listed;
- a save on (1, 2) restores bit for bit onto (2, 1) and onto one device;
  a save on (2, 1) leaves its step alone in its directory (data rank 1
  has no file to write);
- a wrong embedding-table layout tag raises.
"""

import json
import os
import threading

import numpy as np
import pytest

import test_torch_mesh_worker as mw
from tpurec_torch.convert import train_state_to_flax
from tpurec_torch.train import checkpoint as ckpt


def _trainer():
    return mw.fit_trainer(mw.fit_config(checkpoint_backend="orbax"))


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("ckpt")
    mw.spawn("ckpt", 2, str(out))
    with np.load(out / "ckpt.npz") as z:
        res = {k: z[k] for k in z.files}
    return out, res


def test_mesh_save_restores_on_other_meshes_and_one_device(mesh_run):
    out, res = mesh_run
    assert list(res["steps"]) == [2, 3]
    assert json.loads(str(res["extra"])) == {"s": 3}
    saved = {k[6:]: v for k, v in res.items() if k.startswith("saved/")}
    loaded = {k[7:]: v for k, v in res.items() if k.startswith("loaded/")}
    assert saved.keys() == loaded.keys() and "params.embedding.table" in saved
    tr = _trainer()
    be = tr.make_checkpointer(str(out / "ck"))
    assert isinstance(be, ckpt.AsyncBackend)
    meta = tr.load_versioned(be)                       # the newest: 3
    one = mw.flat(train_state_to_flax(tr.state))
    for k, v in saved.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
        np.testing.assert_array_equal(one[k], v, err_msg=k)
    assert meta["extra"] == {"s": 3}
    # the save on (2, 1): data rank 1 writes nothing, and leaves no
    # <step>.partial/ behind
    assert list(res["ck21"]) == ["4"]


def test_save_returns_before_the_write_and_lists_complete_steps(
        tmp_path, monkeypatch):
    tr = _trainer()
    be = ckpt.make_backend("orbax", str(tmp_path / "ck"), max_to_keep=2)
    release, started = threading.Event(), threading.Event()
    write = ckpt.AsyncBackend._write

    def held(self, *a):
        started.set()
        assert release.wait(60)
        write(self, *a)

    monkeypatch.setattr(ckpt.AsyncBackend, "_write", held)
    be.save(1, tr.state, {"s": 1})
    assert started.wait(60)
    assert be.all_steps() == [] and be.latest_step() is None
    release.set()
    be.wait_until_finished()
    assert be.all_steps() == [1]
    monkeypatch.setattr(ckpt.AsyncBackend, "_write", write)
    snaps = {}
    for step in (2, 3, 4):
        tr.state.step = step
        be.save(step, tr.state, {"s": step})
        be.wait_until_finished()
        snaps[step] = tr.snapshot()
    assert sorted(be.all_steps()) == [3, 4]
    # half-written steps are not listed
    os.makedirs(tmp_path / "ck" / "9.partial")
    os.makedirs(tmp_path / "ck" / "8")
    assert sorted(be.all_steps()) == [3, 4] and be.latest_step() == 4
    other = _trainer()
    other.load_versioned(be, step=3)
    assert other.snapshot() == snaps[3]
    be.close()


def test_restore_checks_the_table_layout(tmp_path):
    tr = _trainer()
    be = ckpt.make_backend("orbax", str(tmp_path / "ck"))
    be.save(1, tr.state)
    be.wait_until_finished()
    meta = tmp_path / "ck" / "1" / "meta.json"
    m = json.loads(meta.read_text())
    m["embed_layout"] = "v1"
    meta.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="layout"):
        be.restore(tr.state)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        ckpt.make_backend("orbax", str(tmp_path / "none")).restore(tr.state)
