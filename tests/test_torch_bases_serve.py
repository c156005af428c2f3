"""Serving CDC's other base models: the port's Predictor (plain versions on
the CPU) against the JAX package's for ple, pepnet, epnet, pepnet-single,
epnet-single and star, with one set of random variables, at 37 rows and
at 1 (PLE's and PEPNet's tower BatchNorms skip a 1-row batch, STAR's do
not), an unknown domain and a negative one among them; a CDC Predictor
with each base; and a 1-row /predict through the HTTP host equal to the
direct prediction.  Tolerance 1e-6 absolute on probabilities, NaN where
tpurec gives NaN (an unknown domain's tower)."""

import dataclasses
import json
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from test_torch_bases import (BASES, DOMAIN_IDX, FIELD_DIMS, NAMES, ids,
                              random_stats, small_kw)
from tpurec.config import CDCConfig as JaxCDCConfig
from tpurec.config import Config as JaxConfig
from tpurec.config import ModelConfig as JaxModelConfig
from tpurec.config import config_to_dict as jax_config_to_dict
from tpurec.serve import Predictor as JaxPredictor
from tpurec_torch.config import config_from_dict
from tpurec_torch.serve import Predictor
from tpurec_torch.server import make_server

N_DOMAIN = FIELD_DIMS[DOMAIN_IDX]
D2G = np.arange(N_DOMAIN) % 3
P_ATOL = 1e-6


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(jcfg, rng):
    jp = JaxPredictor(jcfg, FIELD_DIMS, N_DOMAIN, DOMAIN_IDX,
                      domain2group=D2G, batch_sizes=(8, 32))
    v = jax.tree.map(np.asarray, jax.jit(jp.model.init)(
        jax.random.PRNGKey(1), np.asarray(ids(rng, 8))))
    params, stats = v["params"], {"batch_stats": random_stats(
        v["batch_stats"], rng)}
    jp.load_variables(params, stats)
    tp = Predictor(config_from_dict(jax_config_to_dict(jcfg)), FIELD_DIMS,
                   N_DOMAIN, DOMAIN_IDX, domain2group=D2G,
                   batch_sizes=(8, 32), device="cpu").load_variables(
        params, stats)
    return jp, tp


def _requests(rng, n):
    X = ids(rng, n)
    if n > 2:
        X[0, DOMAIN_IDX] = N_DOMAIN + 2          # unknown domain
        X[1, DOMAIN_IDX] = -1                    # wraps to the last one
    return X


def _check(tp, jp, rng):
    for n in (37, 1):
        X = _requests(rng, n)
        got, want = tp(X), jp(X)
        assert got.shape == want.shape == (n,)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, atol=P_ATOL, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_predictor_matches_tpurec(name):
    rng = np.random.default_rng(NAMES.index(name))
    jp, tp = _pair(JaxConfig(model=JaxModelConfig(**small_kw(name))), rng)
    assert tp.model_name == jp.model_name == name
    assert tp.multi_tower == (not name.endswith("-single"))
    _check(tp, jp, rng)
    # the HTTP host: a 1-row request equals the direct prediction
    srv = make_server(tp, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        X = ids(rng, 1)
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/predict",
            data=json.dumps({"instances": X.tolist()}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            got = np.asarray(json.loads(r.read())["predictions"],
                             np.float32)
        np.testing.assert_array_equal(got, tp(X))
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)


@pytest.mark.parametrize("base", BASES)
def test_cdc_predictor_matches_tpurec(base):
    """A CDC config serves its base with n_cluster towers and the remap
    (cdc_tower_dims into the towers, PLE's own expert dims)."""
    rng = np.random.default_rng(10 + BASES.index(base))
    model = dataclasses.replace(JaxModelConfig(**small_kw(base)),
                                model="cdc", mlp_dims=(16, 8))
    jcfg = JaxConfig(model=model, cdc=JaxCDCConfig(
        base_model=base, n_cluster=3, cdc_tower_dims=(8,)))
    jp, tp = _pair(jcfg, rng)
    assert tp.model_name == jp.model_name == base
    assert tp.model.n_tower == jp.model.n_tower == 3
    _check(tp, jp, rng)
