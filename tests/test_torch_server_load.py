"""The port's HTTP serving host under concurrent clients, on the CPU (the
kernels' plain versions), against its own Predictor and against tpurec's
host on the same checkpoint: a tpurec Trainer checkpoint with hashed
fields, served raw ids.  Also Predictor.predict_async fetched out of
order and twice, and ``python -m tpurec_torch.server`` as a process ended
by SIGINT.  The clients are scripts/serve_load.py's."""

import dataclasses
import importlib.util
import json
import os
import queue
import re
import signal
import subprocess
import sys
import threading
import urllib.request

import numpy as np
import pytest

from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.data import make_synthetic
from tpurec.data.hashing import apply_hash_trick
from tpurec.serve import predictor_from_checkpoint as jax_from_checkpoint
from tpurec.server import make_server as jax_make_server
from tpurec_torch.serve import predictor_from_checkpoint
from tpurec_torch.server import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HASH_BUCKETS = ((0, 64), (4, 48))
BATCH_SIZES = (16, 64)
SIZES = (1, 5, 16, 70, 150)     # a request's rows: one chunk, padded, three
CLIENTS = 8


def _load_serve_load():
    spec = importlib.util.spec_from_file_location(
        "serve_load", os.path.join(REPO, "scripts", "serve_load.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


serve_load = _load_serve_load()


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(path, field dims before hashing): a tpurec Trainer fit on hashed
    fields 0 and 4, its config carrying the hash spec."""
    from tpurec.train import Trainer

    data = make_synthetic(n_rows=3000, n_fields=5, n_domain=4, domain_idx=3,
                          seed=5)
    buckets = dict(HASH_BUCKETS)
    (Xtr, ytr), (Xva, yva) = data.train, data.valid
    Xtr, dims = apply_hash_trick(Xtr, data.field_dims, buckets)
    Xva, _ = apply_hash_trick(Xva, data.field_dims, buckets)
    cfg = JaxConfig(
        model=JaxModelConfig(model="mmoe", embed_dim=8,
                             mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8,),
                             atten_embed_dim=8, att_layer_num=1),
        train=JaxTrainConfig(bs=256, epoch=1, seed=0))
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(
        cfg.data, hash_buckets=HASH_BUCKETS))
    tr = Trainer(cfg, dims, data.n_domain, data.domain_idx,
                 domain2group=np.arange(data.n_domain))
    tr.fit((Xtr, ytr), (Xva, yva), domain_cnt_weight=data.domain_cnt_weight())
    path = str(tmp_path_factory.mktemp("ckpt") / "hashed.pkl")
    tr.save_checkpoint(path)
    return path, data.field_dims


def _raw_rows(rng, field_dims, n):
    """Request ids: raw ids far past the buckets on the hashed fields."""
    X = np.stack([rng.integers(0, d, n) for d in field_dims], 1)
    for f, _ in HASH_BUCKETS:
        X[:, f] = rng.integers(0, 2**40, n)
    return X


class _Host:
    """A make_server host on a thread of this process."""

    def __init__(self, srv):
        self.srv = srv
        self.url = f"http://127.0.0.1:{srv.server_address[1]}"
        self.thread = threading.Thread(target=srv.serve_forever, daemon=True)
        self.thread.start()

    def get(self, path):
        with urllib.request.urlopen(self.url + path, timeout=60) as r:
            return r.read()

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def load(checkpoint):
    """8 clients, each on its own keep-alive connection, send requests of
    every size in SIZES to the port's host and to tpurec's on the same
    checkpoint.  -> the requests, each host's replies and counters, and
    the port's direct Predictor."""
    path, field_dims = checkpoint
    rng = np.random.default_rng(11)
    reqs = [[_raw_rows(rng, field_dims, n) for n in np.roll(SIZES, i)]
            for i in range(CLIENTS)]
    bodies = [[(serve_load.body_of(X), len(X)) for X in r] for r in reqs]
    direct = predictor_from_checkpoint(path, batch_sizes=BATCH_SIZES,
                                       device="cpu")
    port = predictor_from_checkpoint(path, batch_sizes=BATCH_SIZES,
                                     device="cpu").warm()
    jp = jax_from_checkpoint(path, batch_sizes=BATCH_SIZES)
    jp.warm()
    out = {"reqs": reqs, "direct": direct}
    for name, host in (("port", _Host(make_server(port, port=0))),
                       ("tpurec", _Host(jax_make_server(jp, port=0)))):
        replies = {}

        def on_reply(i, j, reply, replies=replies):
            replies[i, j] = np.asarray(reply["predictions"], np.float32)

        try:
            cell = serve_load.run_cell(host.url, bodies.__getitem__, CLIENTS,
                                       n_requests=CLIENTS * len(SIZES),
                                       on_reply=on_reply)
            health = json.loads(host.get("/healthz"))
            metrics = host.get("/metrics").decode()
        finally:
            host.close()
        out[name] = {"replies": replies, "cell": cell, "health": health,
                     "metrics": metrics}
    return out


def test_port_replies_equal_its_predictor(load):
    replies = load["port"]["replies"]
    assert len(replies) == CLIENTS * len(SIZES)
    for (i, j), got in replies.items():
        X = load["reqs"][i][j]
        np.testing.assert_array_equal(got, load["direct"](X))
        assert got.shape == (len(X),) and np.all(np.isfinite(got))


def test_port_replies_match_tpurec_host(load):
    port, jax_ = load["port"]["replies"], load["tpurec"]["replies"]
    assert port.keys() == jax_.keys()
    for key in port:
        np.testing.assert_allclose(port[key], jax_[key], atol=1e-6, rtol=0)


@pytest.mark.parametrize("host", ["port", "tpurec"])
def test_counters_count_the_load(load, host):
    n_req = CLIENTS * len(SIZES)
    n_rows = CLIENTS * sum(SIZES)
    r = load[host]
    assert r["cell"]["requests"] == n_req and r["cell"]["rows"] == n_rows
    assert r["health"]["status"] == "ok"
    assert r["health"]["hash_fields"] == [f for f, _ in HASH_BUCKETS]
    assert (r["health"]["n_requests"], r["health"]["n_rows"]) == (n_req,
                                                                  n_rows)
    assert f"tpurec_requests_total {n_req}\n" in r["metrics"]
    assert f"tpurec_rows_total {n_rows}\n" in r["metrics"]
    s = serve_load.summary(r["cell"])
    assert s["requests"] == n_req and 0 < s["p50_ms"] <= s["p99_ms"]


def test_predict_async_fetched_out_of_order(checkpoint):
    path, field_dims = checkpoint
    pred = predictor_from_checkpoint(path, batch_sizes=BATCH_SIZES,
                                     device="cpu")
    rng = np.random.default_rng(3)
    A, B, C = (_raw_rows(rng, field_dims, n) for n in (150, 1, 70))
    want = [pred(X) for X in (A, B, C)]
    fa, fb, fc = (pred.predict_async(X) for X in (A, B, C))
    got_c, got_a, got_b = fc(), fa(), fb()
    for g, w in zip((got_a, got_b, got_c), want):
        np.testing.assert_array_equal(g, w)


def test_predict_async_result_twice(checkpoint):
    path, field_dims = checkpoint
    pred = predictor_from_checkpoint(path, batch_sizes=BATCH_SIZES,
                                     device="cpu")
    X = _raw_rows(np.random.default_rng(4), field_dims, 100)
    fetch = pred.predict_async(X)
    first = fetch()
    first_copy = first.copy()
    second = fetch()
    np.testing.assert_array_equal(second, first_copy)
    assert second is not first and second.shape == (100,)


def test_server_module_answers_and_ends_on_sigint(checkpoint):
    path, field_dims = checkpoint
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpurec_torch.server", "--ckpt", path,
         "--device", "cpu", "--port", "0", "--bs", "64"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    lines = queue.Queue()
    reader = threading.Thread(
        target=lambda: [lines.put(line) for line in proc.stdout], daemon=True)
    reader.start()
    try:
        start = lines.get(timeout=120)
        m = re.search(r"on http://127\.0\.0\.1:(\d+) ", start)
        assert m and start.startswith(f"serving {path} "), start
        X = _raw_rows(np.random.default_rng(5), field_dims, 3)
        req = urllib.request.Request(
            f"http://127.0.0.1:{m.group(1)}/predict",
            data=serve_load.body_of(X))
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["predictions"], np.float32)
        want = predictor_from_checkpoint(path, batch_sizes=(64,),
                                         device="cpu")(X)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == -signal.SIGINT
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=30)
