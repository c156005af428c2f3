"""How a rank of the port's mesh joins, waits and leaves
(tpurec_torch.parallel.mesh), on the CPU.

- ``init_distributed(timeout=)`` bounds every collective's wait: over
  gloo, a rank whose peer stays away fails within the timeout instead of
  the backend's default; ``shutdown_distributed`` tears the group down.
- Under NCCL the group is bound to the rank's card (``device_id``) and
  ``barrier`` names it; the calls into ``torch.distributed`` are checked
  here with stand-ins (no NCCL on the CPU).
- ``chip_smoke.expected_placement``, which the card's mesh phases hold
  each rank to: 4 ranks on one card are gloo ranks on ``cuda:0``, 4 on
  four cards NCCL ranks on ``cuda:r``.
- The spawner of the mesh tests fails a rank whose log shows an exit
  fault ("terminate called ...") even when it exits 0, so a rank that
  leaves its group to interpreter exit cannot pass unseen.
"""

import datetime
import importlib.util
import json

import pytest
import torch
import torch.distributed as dist

import test_torch_mesh_worker as mw
from tpurec_torch.parallel import mesh as M


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", f"{mw.REPO}/chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n_cards,want", [
    (1, lambda r: ("gloo", "cuda:0")),
    (4, lambda r: ("nccl", f"cuda:{r}"))], ids=["one_card", "four_cards"])
@pytest.mark.parametrize("rank", range(4))
def test_rank_placement(chip_smoke, n_cards, want, rank):
    assert chip_smoke.expected_placement(rank, 4, n_cards) == want(rank)


def test_group_timeout_bounds_a_wait(tmp_path):
    """2 gloo ranks joined with a 1 s timeout: rank 0's all-reduce, whose
    peer stays away 4 s, fails after about 1 s; both tear down and exit 0
    with no exit fault."""
    mw.spawn("timeout", 2, tmp_path, 1, timeout=120)
    rec = json.loads((tmp_path / "timeout.json").read_text())
    assert rec["error"] is not None and "Timed out" in rec["error"]
    assert 0.5 <= rec["waited"] < 3.0, rec
    assert not rec["joined"] and not rec["initialized"]


def test_spawn_fails_on_an_exit_fault(tmp_path):
    with pytest.raises(AssertionError, match="exit fault in \\[0\\]"):
        mw.spawn("exit_fault", 1, tmp_path, timeout=120)


class _Calls:
    def __init__(self):
        self.calls = []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))


@pytest.mark.parametrize("n_cards,backend", [(4, "nccl"), (1, "gloo")])
def test_join_binds_nccl_to_the_card(monkeypatch, n_cards, backend):
    """Rank 2 of 4 local ranks: on four cards NCCL bound to cuda:2
    (``device_id``), on one card gloo without it; the timeout reaches
    the group either way."""
    init = _Calls()
    monkeypatch.setattr(M, "_JOINED", None)
    monkeypatch.setattr(M, "resolve_device", lambda d: torch.device(d))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    monkeypatch.setattr(dist, "init_process_group", init)
    for k, v in dict(RANK="2", WORLD_SIZE="4", LOCAL_RANK="2",
                     LOCAL_WORLD_SIZE="4", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    j = M.init_distributed(timeout=5)
    (args, kw), = init.calls
    dev = torch.device("cuda", 2 % n_cards)
    assert args == (backend,) and j.backend == backend and j.device == dev
    assert kw["timeout"] == datetime.timedelta(seconds=5)
    assert kw.get("device_id") == (dev if backend == "nccl" else None)


@pytest.mark.parametrize("backend,device,want", [
    ("nccl", torch.device("cuda", 3), {"device_ids": [3]}),
    ("gloo", torch.device("cuda", 3), {}),
    ("gloo", torch.device("cpu"), {})])
def test_barrier_names_the_card(monkeypatch, backend, device, want):
    barrier = _Calls()
    monkeypatch.setattr(dist, "get_backend", lambda *a: backend)
    monkeypatch.setattr(dist, "barrier", barrier)
    M.barrier(device)
    assert barrier.calls == [((), want)]
