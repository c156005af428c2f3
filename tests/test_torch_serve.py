"""tpurec_torch serving path on the CPU (plain versions) against the JAX
package's: the Predictor for every table dtype with routing, hashing,
chunking and the CDC remap; a real Trainer checkpoint read without JAX;
the serving CLI; and the HTTP host."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import DataConfig as JaxDataConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import TrainConfig as JaxTrainConfig
from tpurec.config import config_to_dict as jax_config_to_dict
from tpurec.data import make_synthetic
from tpurec.serve import Predictor as JaxPredictor
from tpurec.serve import predictor_from_checkpoint as jax_from_checkpoint
from tpurec_torch.config import config_from_dict
from tpurec_torch.serve import Predictor, main as serve_main
from tpurec_torch.serve import predictor_from_checkpoint
from tpurec_torch.server import make_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELD_DIMS = (9000, 7, 5, 6, 12000, 30)    # field 3 is the domain
DOMAIN_IDX, N_DOMAIN = 3, 6
BATCH_SIZES = (32, 128)


def _jax_cfg(kind):
    model = JaxModelConfig(model="mmoe", embed_dim=8, mmoe_expert_dims=(16, 8),
                           mmoe_tower_dims=(8,), atten_embed_dim=8,
                           att_layer_num=2)
    data = JaxDataConfig(hash_buckets=((0, 9000), (5, 30)))
    if kind == "cdc":
        return JaxConfig(
            model=dataclasses.replace(model, model="cdc", mlp_dims=(16, 8)),
            cdc=JaxCDCConfig(base_model="mmoe", n_cluster=3,
                             cdc_tower_dims=(8, 4)), data=data)
    return JaxConfig(model=model, data=data)


def _random_variables(model, rng):
    v = jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(1), np.zeros((8, len(FIELD_DIMS)), np.int32)))

    def stats(path, a):
        if a.dtype != np.float32:
            return a
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (0.3 * rng.normal(size=a.shape)).astype(np.float32)

    return v["params"], {"batch_stats": jax.tree_util.tree_map_with_path(
        stats, v["batch_stats"])}


def _requests(rng, n):
    X = np.stack([rng.integers(0, d, n) for d in FIELD_DIMS], 1)
    X[:, 0] = rng.integers(0, 2**40, n)          # raw ids on hashed fields
    X[:, 5] = rng.integers(-2**31, 2**31, n)
    X[0, DOMAIN_IDX] = N_DOMAIN + 3              # unknown domain -> NaN
    X[1, DOMAIN_IDX] = -1                        # wraps to the last domain
    X[2, 4] = 10**6                              # past the item vocabulary
    return X


@pytest.mark.parametrize("kind", ["mmoe", "cdc"])
@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_predictor_matches_jax_predictor(rng, kind, table_dtype):
    jcfg = _jax_cfg(kind)
    d2g = np.arange(N_DOMAIN) % 3
    jp = JaxPredictor(jcfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                      domain2group=d2g, batch_sizes=BATCH_SIZES,
                      table_dtype=table_dtype)
    params, model_state = _random_variables(jp.model, rng)
    jp.load_variables(params, model_state)
    tp = Predictor(config_from_dict(jax_config_to_dict(jcfg)), FIELD_DIMS,
                   N_DOMAIN, DOMAIN_IDX, domain2group=d2g,
                   batch_sizes=BATCH_SIZES, table_dtype=table_dtype,
                   device="cpu").load_variables(params, model_state)
    assert tp.model_name == jp.model_name == "mmoe"
    assert tp.model.n_tower == jp.model.n_tower == 3
    assert tp.table_bytes() == jp.table_bytes()
    # 300 rows = two full chunks of 128 + a tail padded to 128; 20 rows =
    # one chunk padded to 32
    for n in (300, 20):
        X = _requests(rng, n)
        got, want = tp(X), jp(X)
        assert got.shape == want.shape == (n,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
        assert np.isnan(got[0]) and np.all(np.isfinite(got[3:]))


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    data = make_synthetic(n_rows=3000, n_fields=5, n_domain=4, domain_idx=3,
                          seed=5)
    from tpurec.train import Trainer

    cfg = JaxConfig(
        model=JaxModelConfig(model="mmoe", embed_dim=8,
                             mmoe_expert_dims=(16, 8), mmoe_tower_dims=(8,),
                             atten_embed_dim=8, att_layer_num=1),
        train=JaxTrainConfig(bs=256, epoch=1, seed=0))
    tr = Trainer(cfg, data.field_dims, data.n_domain, data.domain_idx,
                 domain2group=np.arange(data.n_domain))
    tr.fit(data.train, data.valid, domain_cnt_weight=data.domain_cnt_weight())
    path = str(tmp_path_factory.mktemp("ckpt") / "mmoe.pkl")
    tr.save_checkpoint(path)
    return path, data.valid[0][:300]


def test_trainer_checkpoint_serves_like_jax(checkpoint):
    path, X = checkpoint
    want = jax_from_checkpoint(path, batch_sizes=(128,))(X)
    pred = predictor_from_checkpoint(path, batch_sizes=(128,), device="cpu")
    np.testing.assert_array_equal(pred.domain2group, np.arange(4))
    np.testing.assert_allclose(pred(X), want, atol=1e-6, rtol=0)


def test_checkpoint_loads_without_jax(checkpoint, tmp_path):
    """The port reads a checkpoint in a process where jax, flax, optax and
    msgpack cannot be imported."""
    path, X = checkpoint
    np.save(tmp_path / "X.npy", X)
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'tpurec'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from tpurec_torch.serve import predictor_from_checkpoint\n"
        f"p = predictor_from_checkpoint({path!r}, batch_sizes=(128,),"
        " device='cpu')\n"
        f"np.save({str(tmp_path / 'p.npy')!r},"
        f" p(np.load({str(tmp_path / 'X.npy')!r})))\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)
    want = predictor_from_checkpoint(path, batch_sizes=(128,),
                                     device="cpu")(X)
    np.testing.assert_array_equal(np.load(tmp_path / "p.npy"), want)


def test_checkpoint_layout_guard(checkpoint, tmp_path):
    path, _ = checkpoint
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["embed_layout"] = None
    old = str(tmp_path / "old.pkl")
    with open(old, "wb") as f:
        pickle.dump(payload, f)
    with pytest.raises(ValueError, match="embedding-table layout"):
        predictor_from_checkpoint(old, device="cpu")


def test_serve_cli(checkpoint, tmp_path):
    path, X = checkpoint
    np.save(tmp_path / "X.npy", X)
    out = str(tmp_path / "p.npy")
    serve_main(["--ckpt", path, "--input", str(tmp_path / "X.npy"),
                "--output", out, "--bs", "128", "--device", "cpu"])
    want = predictor_from_checkpoint(path, batch_sizes=(128,),
                                     device="cpu")(X)
    np.testing.assert_array_equal(np.load(out), want)


def test_http_server(checkpoint):
    import http.client

    path, X = checkpoint
    pred = predictor_from_checkpoint(path, batch_sizes=(64,), device="cpu")
    srv = make_server(pred, port=0)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        body = json.dumps({"instances": X[:10].tolist()}).encode()
        req = urllib.request.Request(base + "/predict", data=body)
        with urllib.request.urlopen(req, timeout=30) as r:
            out = json.loads(r.read())
        np.testing.assert_array_equal(
            np.asarray(out["predictions"], np.float32), pred(X[:10]))
        assert out["latency_ms"] > 0

        bad = urllib.request.Request(base + "/predict",
                                     data=b'{"instances": [[1, 2]]}')
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=30)
        assert e.value.code == 400

        # a 404 on a kept-alive connection drains its body first
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                          timeout=30)
        conn.request("POST", "/nope",
                     body=json.dumps({"junk": "x" * 5000}).encode())
        r1 = conn.getresponse()
        assert r1.status == 404
        r1.read()
        conn.request("POST", "/predict",
                     body=json.dumps({"instances": X[:4].tolist()}).encode())
        r2 = conn.getresponse()
        assert r2.status == 200
        assert len(json.loads(r2.read())["predictions"]) == 4
        conn.close()

        with urllib.request.urlopen(base + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["status"] == "ok" and h["model"] == "mmoe"
        assert h["n_requests"] == 2 and h["n_rows"] == 14
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            m = r.read().decode()
        assert "tpurec_requests_total 2" in m and "tpurec_rows_total 14" in m
        assert f"tpurec_table_bytes {pred.table_bytes()[0]}" in m
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)
    assert not t.is_alive()
