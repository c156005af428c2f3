"""The port's host utilities against the JAX package's: ``JsonlLogger``
(file lines equal less ``ts``, the echo on stderr), ``StepTimer`` (equal
summaries under one patched clock) and ``trace`` on ``torch.profiler``
(writes a Chrome trace of the CPU activity here)."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import tpurec.utils.profiling as jprof
import tpurec_torch.utils.profiling as pprof
from tpurec.utils.logging import JsonlLogger as JaxJsonlLogger
from tpurec_torch.utils import JsonlLogger

RECORDS = [
    {"train_loss": np.float32(0.5123), "epoch": 0, "it": np.int64(11)},
    {"total_auc": 0.71, "domain_auc": {0: 0.7, 1: 0.72}, "note": "x",
     "arr": [1, 2], "none": None, "f64": np.float64(1e-9)},
    {},
]


@pytest.mark.parametrize("echo", [True, False])
def test_jsonl_logger_lines_are_tpurecs(tmp_path, capsys, echo):
    out = {}
    for name, cls in (("j", JaxJsonlLogger), ("p", JsonlLogger)):
        path = tmp_path / name / "sub" / "log.jsonl"      # dirs are made
        log = cls(str(path), echo=echo)
        for r in RECORDS:
            log(r)
        log.close()
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        assert all(isinstance(x.pop("ts"), float) for x in lines)
        out[name] = (lines, capsys.readouterr().err)
    assert out["p"] == out["j"]
    assert out["p"][0][0] == {"train_loss": float(np.float32(0.5123)),
                              "epoch": 0, "it": 11.0}
    assert bool(out["p"][1]) == echo


def test_jsonl_logger_without_a_path_only_echoes(capsys):
    log = JsonlLogger(None)
    log({"a": 1, "b": [2]})
    log.close()
    assert capsys.readouterr().err == '{"a": 1}\n'


def _clock(monkeypatch, module, ticks):
    it = iter(ticks)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))


@pytest.mark.parametrize("warmup,n", [(3, 12), (0, 1), (2, 2), (5, 40)])
def test_step_timer_summary_is_tpurecs(monkeypatch, warmup, n):
    rng = np.random.default_rng(warmup + n)
    ticks = np.cumsum(rng.random(2 * n) * 0.05).tolist()
    out = []
    for mod in (jprof, pprof):
        _clock(monkeypatch, mod, ticks)
        t = mod.StepTimer(warmup=warmup)
        for _ in range(n):
            with t:
                pass
        out.append(t.summary())
    assert out[0] == out[1]
    assert out[1].get("steps", 0) == max(n - warmup, 0)


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with pprof.trace(str(tmp_path / "tr")) as prof:
        for _ in range(3):
            y = torch.mm(x, x).relu()
    assert y.shape == (64, 64)
    files = glob.glob(str(tmp_path / "tr" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::mm" in names and "aten::relu" in names
    assert any(k.key == "aten::mm" and k.count == 3
               for k in prof.key_averages())
    stem = os.path.basename(files[0])[:-len(".pt.trace.json")]
    assert stem.rsplit(".", 2)[1] == str(os.getpid())
