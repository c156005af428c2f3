"""Amazon as its users run it, on the CPU: raw ratings and metadata through
both packages' ``AmazonPreprocessor`` (25 domains), then ``python -m
tpurec_torch.cli --model cdc --dataset_name amazon --base_model ple``
against ``python -m tpurec.cli`` with the same argv at tiny widths, from
one initial state (as tests/test_torch_cli_cdc.py runs the synthetic
set): the same preprocessed file, ``field_dims``, ``n_domain``, domain at
field 3 and timestamp split; the matrix update's clustering (unless
``clustering_tie`` finds its matrices tie), the eval AUC within
``AUC_TOL`` and each package's Predictor on the other's checkpoint within
``P_ATOL``.  Then the attention stack at Amazon's 8 fields at the
flagship's widths (D=16, A=64, H=2, L=3), forward and backward, against
tpurec's ``field_attention_reference`` at tests/test_torch_attention.py's
1e-5."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

import tpurec.cdc
import tpurec.cdc.engine as jeng
import tpurec.cli as jcli
import tpurec.data.preprocess as J
import tpurec_torch.cdc.engine as peng
import tpurec_torch.cli as pcli
import tpurec_torch.data.preprocess as P
from test_torch_cli import AUC_TOL, P_ATOL, _patch_config
from test_torch_mesh_worker import clustering_tie
from tpurec.ops.attention_pallas import \
    field_attention_reference as jax_attention
from tpurec.serve import predictor_from_checkpoint as jax_predictor_from_ckpt
from tpurec_torch.ops.attention import field_attention
from tpurec_torch.serve import predictor_from_checkpoint

END = 1534291200                # 2018-08-15, the dataset's end (UTC)
N_RATINGS, N_ITEMS, N_USERS = 12000, 150, 200
FIELDS = ("userid", "itemid", "weekday", "domain", "sales_chart",
          "sales_rank", "brand", "price")
ARGV = ["--model", "cdc", "--dataset_name", "amazon", "--base_model", "ple",
        "--epoch", "1", "--bs", "512", "--is_set_seed", "1", "--seed", "3",
        "--embed_dim", "8", "--n_cluster", "2", "--n_causal_mask", "4",
        "--warmup_step", "1", "--update_matrix_step", "1",
        "--update_interval", "100", "--mesh_data", "-1"]
MODEL = dict(atten_embed_dim=8, att_layer_num=1,
             ple_expert_dims=((32, 16), (16,)), dropout=0.0)
TIE_ATOL = 5e-4                 # matrices a clustering must hold against
GEN_CHECK_ROWS = 100_000        # the card generator's ratings both
                                # packages preprocess


def _raw_pair(root, seed):
    """A raw ratings CSV (headerless itemid,userid,rating,timestamp, some
    rows before the 12-month window) and a metadata JSON-lines file over
    all 25 domains and one the map drops, prices and ranks in the
    reference's formats, some missing.  The domains fall in two clusters
    that conflict: a rating is high on the first days of the week in one
    and on the last in the other (flipped for 10% of rows), so CDC's
    matrices part the clusters and the models learn."""
    rng = np.random.default_rng(seed)
    domains = list(P.AMAZON_DOMAIN2ENCODER) + ["Not A Domain"]
    items = [f"A{i:04d}" for i in range(N_ITEMS)]
    item = rng.integers(0, N_ITEMS, N_RATINGS)
    ts = END - rng.integers(0, 400 * 86400, N_RATINGS)
    early = pd.to_datetime(ts, unit="s").dayofweek.values < 3
    cluster = (item % len(domains)) % 2 == 1
    high = (early ^ cluster) ^ (rng.random(N_RATINGS) < 0.1)
    pd.DataFrame({
        "itemid": np.asarray(items)[item],
        "userid": rng.choice([f"U{i:04d}" for i in range(N_USERS)],
                             N_RATINGS),
        "rating": np.where(high, 5.0, rng.choice([1.0, 2.0, 3.0, 4.0],
                                                 N_RATINGS)),
        "timestamp": ts,
    }).to_csv(root / "ratings.csv", index=False, header=False)
    lines = []
    for i, it in enumerate(items):
        rec = {"asin": it,
               "brand": f"Brand{rng.integers(0, 6)}" if i % 5 else "",
               "category": [domains[i % len(domains)], "sub", "subsub"]}
        if i % 4:
            rec["price"] = f"${rng.lognormal(2.5, 1.0):.2f}"
        if i % 5 != 1:
            rec["rank"] = (f"#{rng.integers(1, 3_000_000):,} in "
                           f"{rng.choice(domains)} (See Top 100)")
        lines.append(json.dumps(rec))
    (root / "meta.json").write_text("\n".join(lines) + "\n")
    return str(root / "ratings.csv"), str(root / "meta.json")


def _record_updates(mod, out):
    """Wrap ``mod``'s update_group: each call's mask matrix (after the
    update's transform), k-means seed and clustering go to ``out``."""
    orig = mod.update_group

    def update_group(st, cfg, w, kmeans_seed=None):
        res = orig(st, cfg, w, kmeans_seed=kmeans_seed)
        out.append({"mask": np.array(st.matrix_mask, np.float64),
                    "seed": kmeans_seed,
                    "d2g": [int(g) for g in st.domain2group]})
        return res

    return update_group


@pytest.fixture(scope="module")
def amazon_runs(tmp_path_factory):
    """Both packages preprocess one raw pair into their own directories;
    both CLIs then resume one initial CDC-on-PLE state (tpurec's, after
    setup_data) on the port's file.  -> dict of both sides' frames,
    datasets, CLI outputs and update records."""
    tmp = tmp_path_factory.mktemp("amazon")
    ratings, meta = _raw_pair(tmp, 5)
    res = {}
    for name, mod in (("j", J), ("p", P)):
        d = tmp / f"data_{name}"
        d.mkdir()
        pre = mod.AmazonPreprocessor(str(d))
        res[f"frame_{name}"] = pre.main(ratings, meta)
        res[f"csv_{name}"] = pre.preprocess_path
    data = str(tmp / "data_p")
    argv = ARGV + ["--data_path", data]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        _patch_config(mp, model=MODEL, cdc={"cdc_tower_dims": (16,)})
        cfg = jcli.build_config(jcli.parse_args(argv))
        res["data_j"] = jcli.load_dataset(cfg)
        res["data_p"] = pcli.load_dataset(pcli.build_config(
            pcli.parse_args(argv)))
        np.random.seed(cfg.train.seed)
        train, valid, test, fd, nd, di = res["data_j"]
        jtr = tpurec.cdc.CDCTrainer(cfg, fd, nd, di)
        jtr.setup_data(train, valid, test)
        start = str(tmp / "start.pkl")
        jtr.save_checkpoint(start)
        argv += ["--resume", start]
        res["updates_j"], res["updates_p"] = [], []
        mp.setattr(jeng, "update_group",
                   _record_updates(jeng, res["updates_j"]))
        mp.setattr(peng, "update_group",
                   _record_updates(peng, res["updates_p"]))
        res["out_j"] = jcli.main(argv + ["--save_path", str(tmp / "j")])
        res["out_p"] = pcli.main(argv + ["--save_path", str(tmp / "p"),
                                         "--device", "cpu"])
    torch.set_num_threads(n)
    return res


def test_preprocessing_is_tpurecs(amazon_runs):
    got, want = amazon_runs["frame_p"], amazon_runs["frame_j"]
    pd.testing.assert_frame_equal(got, want)
    with open(amazon_runs["csv_p"], "rb") as a, \
            open(amazon_runs["csv_j"], "rb") as b:
        assert a.read() == b.read()
    assert list(got.columns[:8]) == list(FIELDS)
    assert sorted(got["domain"].unique()) == list(range(25))


def test_dataset_is_tpurecs(amazon_runs):
    """The CLI's Amazon branch: the same splits bitwise, 8 fields, 25
    domains, domain at field 3, the timestamp split 0.9 / 0.95."""
    got, want = amazon_runs["data_p"], amazon_runs["data_j"]
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert got[3:] == want[3:]
    field_dims, n_domain, domain_idx = got[3:]
    assert len(field_dims) == 8 and n_domain == 25 and domain_idx == 3
    n = [len(s[1]) for s in got[:3]]
    ts = amazon_runs["frame_p"]["timestamp"].values
    q90, q95 = np.quantile(ts, 0.9), np.quantile(ts, 0.95)
    assert n == [int((ts < q90).sum()), int(((ts >= q90) & (ts < q95)).sum()),
                 int((ts >= q95).sum())]
    assert n[0] > 8 * n[1] > 0 and n[2] > 0


def test_clustering_is_tpurecs_or_a_tie(amazon_runs):
    """The update (one, before step 0: the epoch is shorter than the
    interval) clusters 25 domains by k-means as tpurec's does, unless its
    matrices tie: moved by TIE_ATOL, or by their parting if larger, they
    give more than one labelling."""
    uj, up = amazon_runs["updates_j"], amazon_runs["updates_p"]
    assert len(up) == len(uj) == 1
    assert amazon_runs["out_p"]["domain2group_list"] == up[-1]["d2g"]
    for u, (a, b) in enumerate(zip(up, uj)):
        assert a["seed"] == b["seed"] and len(a["d2g"]) == 25
        if a["d2g"] == b["d2g"]:
            continue
        atol = max(TIE_ATOL, float(np.abs(a["mask"] - b["mask"]).max()))
        own, moved = clustering_tie(a["mask"], 2, a["seed"], atol)
        assert own == tuple(a["d2g"]) and len(moved) > 1, (u, moved)
        break
    else:
        assert (amazon_runs["out_p"]["domain2group_list"]
                == amazon_runs["out_j"]["domain2group_list"])


def test_result_matches_tpurec(amazon_runs):
    op, oj = amazon_runs["out_p"], amazon_runs["out_j"]
    for split in ("valid", "test"):
        assert np.isfinite(op[split]["total_auc"])
        assert abs(op[split]["total_auc"] - oj[split]["total_auc"]) <= AUC_TOL
        assert set(op[split]["domain_auc"]) == set(oj[split]["domain_auc"])


@pytest.mark.parametrize("side", ["p", "j"])
def test_checkpoints_serve_in_both_packages(amazon_runs, side):
    """Each CLI's checkpoint carries 8 fields, domain 3 and its
    clustering, and both packages' Predictors score it within P_ATOL."""
    path = amazon_runs[f"out_{side}"]["checkpoint"]
    assert path.endswith("cdc_amazon_seed3.pkl")
    pred = predictor_from_checkpoint(path, batch_sizes=(128,), device="cpu")
    assert pred.field_dims == amazon_runs["data_p"][3]
    assert pred.domain_idx == 3 and pred.n_domain == 25
    X = amazon_runs["data_p"][2][0][:300]
    want = pred(X)
    got = jax_predictor_from_ckpt(path, batch_sizes=(128,))(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=P_ATOL)


def test_card_generator_gives_phase_30s_dims(tmp_path):
    """chip_smoke.py phase 30 (a) runs the kernels at AMAZON_DIMS, the
    dims its part (b) gets from AMAZON_ROWS raw ratings written by its own
    generator (scripts/bench_amazon_scale.py's distributions): the port's
    AmazonPreprocessor gives those dims from that raw pair, 25 domains,
    and both packages' give the same file from the generator's first
    GEN_CHECK_ROWS ratings."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    (tmp_path / "full").mkdir()
    ratings, meta, _ = cs.amazon_raw(str(tmp_path / "full"), cs.AMAZON_ROWS)
    with open(ratings, "rb") as f:
        assert f.readline() == b"A00021993,U00038604,2.0,1520433006\n"
    got = P.AmazonPreprocessor(str(tmp_path / "full")).main(ratings, meta)
    dims = tuple(int(v) + 1 for v in got[list(FIELDS)].values.max(0))
    assert dims == cs.AMAZON_DIMS and got["domain"].nunique() == 25
    ratings, meta, _ = cs.amazon_raw(str(tmp_path), GEN_CHECK_ROWS)
    outs = {}
    for name, mod in (("j", J), ("p", P)):
        d = tmp_path / name
        d.mkdir()
        pre = mod.AmazonPreprocessor(str(d))
        outs[name] = (pre.main(ratings, meta), pre.preprocess_path)
    assert len(outs["p"][0]) > GEN_CHECK_ROWS // 2
    pd.testing.assert_frame_equal(outs["p"][0], outs["j"][0])
    with open(outs["p"][1], "rb") as a, open(outs["j"][1], "rb") as b:
        assert a.read() == b.read()


F, D, A, H, L = len(FIELDS), 16, 64, 2, 3


def _attention_inputs(rng, B):
    mk = lambda *s: (rng.normal(size=s) * 0.1).astype(np.float32)  # noqa
    flat = [mk(D, A), mk(A), mk(D, A), mk(A)]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    return rng.normal(size=(B, F, D)).astype(np.float32), flat


@pytest.mark.parametrize("B", [1, 13, 97])
def test_attention_at_amazons_fields_matches_tpurec(rng, B):
    """The plain forward at F=8 (kernel 2's R=12 block of 96 stacked rows
    at B=4096 on the card) and its backward (kernel 3's plain version)
    against jax.vjp of tpurec's reference, 1e-5 of max(1, max|x|)."""
    emb, flat = _attention_inputs(rng, B)
    dy = rng.normal(size=(B, F, A)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda e, w: jax_attention(e, w, L, H),
                       jnp.asarray(emb), [jnp.asarray(w) for w in flat])
    demb_j, dw_j = vjp(jnp.asarray(dy))
    te = torch.from_numpy(emb).requires_grad_(True)
    tw = [torch.from_numpy(w).requires_grad_(True) for w in flat]
    y = field_attention(te, tw, L, H, train=True, rate=0.0)
    y.backward(torch.from_numpy(dy))
    with torch.no_grad():
        assert torch.equal(y, field_attention(te, tw, L, H))
    pairs = [("y", y.detach(), y_j), ("demb", te.grad, demb_j)]
    pairs += [(f"w{i}", w.grad, g) for i, (w, g) in enumerate(zip(tw, dw_j))]
    for name, got, want in pairs:
        want = np.asarray(want)
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
