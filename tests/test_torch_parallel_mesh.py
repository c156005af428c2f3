"""The port's mesh layer without spawning ranks: make_mesh's checks and
messages, the Shardings rules, the data feed's arithmetic and the
backend's choice against the JAX package's (tpurec/parallel/), and
kernel 1's row window in its plain version.

The mesh's collectives run in tests/test_torch_parallel_lookup.py,
tests/test_torch_parallel_steps.py and, with expert parallelism,
tests/test_torch_parallel_expert.py (gloo, spawned ranks)."""

import jax
import numpy as np
import pytest
import torch

from tpurec.parallel import Shardings as JShardings
from tpurec.parallel import feed as jfeed
from tpurec.parallel import make_mesh as jmake_mesh
from tpurec_torch.nn.core import EmbeddingLayout
from tpurec_torch.ops.embedding import (EmbeddingGather, _wrap_int32,
                                        embedding_gather_reference,
                                        take_rows)
from tpurec_torch.parallel import Shardings, make_mesh
from tpurec_torch.parallel import feed
from tpurec_torch.parallel.mesh import Mesh, choose_backend
from tpurec_torch.serve import quantize_table


def _mesh(n_data, n_model, rank=0):
    return Mesh(n_data, n_model, rank, torch.device("cpu"), "none")


@pytest.mark.parametrize("n_data,n_model,world", [
    (3, 1, 2), (2, 2, 8), (1, 3, 2), (4, 2, 4)])
def test_make_mesh_errors_are_tpurecs(n_data, n_model, world):
    with pytest.raises(AssertionError) as want:
        jmake_mesh(n_data, n_model, devices=jax.devices()[:world])
    with pytest.raises(AssertionError) as got:
        make_mesh(n_data, n_model, world=world)
    assert str(got.value) == str(want.value)


def test_make_mesh_of_one_rank_has_no_groups():
    m = make_mesh(0, 1, device="cpu")
    assert (m.n_data, m.n_model, m.d, m.m) == (1, 1, 0, 0)
    assert m.data_group is None and m.model_group is None
    assert m.shape == {"data": 1, "model": 1} and m.size == 1
    with pytest.raises(AssertionError):
        make_mesh(0, 3, world=4)


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (1, 2), (2, 2), (4, 1),
                                            (2, 4)])
def test_rank_layout_is_tpurecs_device_layout(n_data, n_model):
    jm = jmake_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    ids = np.vectorize(lambda dv: dv.id)(jm.devices)
    for r in range(n_data * n_model):
        m = _mesh(n_data, n_model, r)
        assert ids[m.d, m.m] == jax.devices()[r].id
        assert list(m.data_ranks) == [int(i) for i in ids[:, m.m]]
        assert list(m.model_ranks) == [int(i) for i in ids[m.d, :]]


PATHS = [
    ("params", "embedding", "table"),
    ("params", "experts", "linear_0", "weight"),
    ("params", "towers", "bn_0", "scale"),
    ("opt_state", "1", "m"), ("opt_state", "1", "v"),
    ("opt_state", "0", "1", "mu", "experts", "linear_0", "bias"),
    ("opt_state", "1", "mu", "embedding", "table"),
    ("opt_state", "1", "nu", "embedding", "table"),
    ("model_state", "batch_stats", "experts", "bn_0", "mean"),
    ("params", "m"), ("m",), ("step",),
]


@pytest.mark.parametrize("path", PATHS, ids=".".join)
def test_shardings_are_tpurecs(path):
    jm = jmake_mesh(1, 2, devices=jax.devices()[:2])
    want = tuple(JShardings(jm)._spec_for_path(path))
    sh = Shardings(_mesh(1, 2))
    assert sh.spec(path) == want == sh.spec(".".join(path))
    # the port's own state names
    assert sh.spec("embedding.table") == ("model", None)
    assert sh.spec("emb_opt.m") == sh.spec("emb_opt.v") == ("model", None)


@pytest.mark.parametrize("n_rows", [0, 1, 7, 100, 1001, 4096])
@pytest.mark.parametrize("P", [1, 2, 3, 4, 8])
def test_process_shard_is_tpurecs(n_rows, P):
    got = [feed.process_shard(n_rows, i, P) for i in range(P)]
    assert got == [jfeed.process_shard(n_rows, i, P) for i in range(P)]
    with pytest.raises(ValueError, match="not in"):
        feed.process_shard(n_rows, P, P)


@pytest.mark.parametrize("n_rows", [1, 97, 1000, 4097])
@pytest.mark.parametrize("n_data,n_model", [(1, 1), (2, 1), (1, 2), (2, 2),
                                            (4, 1), (8, 1)])
def test_feed_is_tpurecs_per_data_block(n_rows, n_data, n_model):
    """tpurec's single-process feed owns every data block: the port's
    ranks' shares, block by block, add up to it, and each block's range is
    its split of a [n_rows] array (tpurec/parallel/feed.py:94-118)."""
    jm = jmake_mesh(n_data, n_model, devices=jax.devices()[:n_data * n_model])
    jf = jfeed.GlobalBatchFeed(jm)
    ranges = []
    for r in range(n_data * n_model):
        f = feed.GlobalBatchFeed(_mesh(n_data, n_model, r))
        lo, hi = f.dataset_range(n_rows)
        d = r // n_model
        assert (lo, hi) == (d * n_rows // n_data, (d + 1) * n_rows // n_data)
        if r % n_model == 0:
            ranges.append((lo, hi))
        for bs in (8, 64, 512):
            assert f.local_rows_per_step(bs) * n_data == \
                jf.local_rows_per_step(bs)
            nb, bl = feed.epoch_plan(n_rows, bs, f)
            jnb, jbl = jfeed.epoch_plan(n_rows, bs, jf)
            assert (nb, bl * n_data) == (jnb, jbl)
        if n_data > 1:
            with pytest.raises(ValueError, match="not divisible"):
                f.local_rows_per_step(n_data * 8 + 1)
    assert ranges[0][0] == 0 and ranges[-1][1] == n_rows
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert (ranges[0][0], ranges[-1][1]) == jf.dataset_range(n_rows)
    with pytest.raises(ValueError, match="empty"):
        feed.epoch_plan(0, 8, feed.GlobalBatchFeed(_mesh(n_data, n_model)))


def test_feed_puts_this_ranks_rows():
    f = feed.GlobalBatchFeed(_mesh(2, 1, 1))
    b = {"x": np.arange(8).reshape(4, 2), "y": np.ones(4, np.float32)}
    out = f.global_batch(b, 8)
    assert torch.equal(out["x"], torch.arange(8).reshape(4, 2))
    with pytest.raises(ValueError, match="supplies 4 of 8"):
        f.global_batch({"x": np.zeros((8, 2))}, 8)
    st = f.global_stacked_batch({"x": np.zeros((3, 4, 2))}, 8)
    assert st["x"].shape == (3, 4, 2)
    with pytest.raises(ValueError, match="no 'rows' axis"):
        feed.GlobalBatchFeed(_mesh(2, 1), data_axis="rows")


@pytest.mark.parametrize("dev,local_world,cards,want", [
    ("cpu", 4, 0, "gloo"), ("cuda", 1, 1, "nccl"), ("cuda", 4, 1, "gloo"),
    ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo"), ("cuda", 2, 8, "nccl")])
def test_backend_choice(dev, local_world, cards, want):
    backend, why = choose_backend(torch.device(dev), local_world, cards)
    assert backend == want and why


def test_a_rank_without_its_card_raises():
    """init_distributed puts a rank on a card unless asked for the CPU,
    and raises where there is none (before joining any group)."""
    from tpurec_torch.parallel.mesh import init_distributed, joined

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_distributed()
    assert joined() is None


FIELD_DIMS = (64, 48, 16, 9000, 24, 10000)


def _ids(rng, n=300):
    ids = np.stack([rng.integers(-3, d + 5, n) for d in FIELD_DIMS],
                   1).astype(np.int32)
    ids[0, 3] = 10**8
    ids[1, 0] = -(2**31)
    return torch.from_numpy(ids)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_whole_table_window_is_the_plain_gather(dtype):
    """Today's calls pass the whole table as the window: the plain
    version keeps jnp.take's rules bit for bit (the formula it had)."""
    rng = np.random.default_rng(0)
    layout = EmbeddingLayout(FIELD_DIMS)
    q, s = quantize_table(torch.from_numpy(rng.normal(
        size=(layout.vocab, 8)).astype(np.float32)), dtype)
    off, lim = layout.device_arrays("cpu", layout.vocab)
    ids = _ids(rng)
    g = _wrap_int32(ids.long() + off.long()[None, :])
    want = take_rows(q, g, lim.long()[None, :]).to(torch.float32)
    if s is not None:
        want = want * take_rows(s, g)[..., None]
    got = layout.gather(q, s)(ids)
    assert torch.isnan(want).any()
    assert torch.equal(torch.nan_to_num(got, 7.0),
                       torch.nan_to_num(want, 7.0))
    assert torch.equal(got.isnan(), want.isnan())
    gw = layout.gather(q, s, window=(0, layout.vocab))
    assert torch.equal(torch.nan_to_num(gw(ids), 7.0),
                       torch.nan_to_num(want, 7.0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [2, 3, 5])
def test_windows_sum_to_the_gather(dtype, n):
    """Each window reads its rows and zeros elsewhere; a fill (NaN) is
    every window's, so the sum keeps it."""
    rng = np.random.default_rng(1)
    layout = EmbeddingLayout(FIELD_DIMS)
    V = layout.vocab
    q, _ = quantize_table(torch.from_numpy(rng.normal(
        size=(V, 8)).astype(np.float32)), dtype)
    ids = _ids(rng)
    want = layout.gather(q)(ids)
    per = -(-V // n)
    qp = torch.cat([q, torch.zeros(per * n - V, 8, dtype=q.dtype)])
    parts = []
    for m in range(n):
        g = layout.gather(qp[m * per:(m + 1) * per].contiguous(),
                          window=(m * per, V))
        assert g.serves(g.table, (m * per, V)) and not g.serves(g.table)
        parts.append(g(ids))
    for p in parts:
        lone = ~p.isnan() & (p != 0)
        assert torch.equal(p[lone], want[lone])
    assert torch.equal(torch.nan_to_num(sum(parts), 7.0),
                       torch.nan_to_num(want, 7.0))
    off, lim = layout.device_arrays("cpu", V)
    ref = embedding_gather_reference(qp[:per], ids, off, lim, None, 0, V)
    assert torch.equal(torch.nan_to_num(ref, 7.0),
                       torch.nan_to_num(parts[0], 7.0))
    with pytest.raises(ValueError, match="window"):
        EmbeddingGather(q, off, lim, row_lo=V + 1, n_table_rows=V)
