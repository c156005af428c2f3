"""tpurec_torch embedding gather (plain version on the CPU) against the JAX
package: the Pallas gather in interpret mode, the Predictor's lookup
(mixed_table_lookup + dequantisation) with its out-of-range rule, the row
layout, and table quantisation.  All comparisons are bit-exact (NaN
matches NaN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.nn.core import EmbeddingLayout as JaxLayout
from tpurec.nn.core import mixed_table_lookup as jax_mixed_lookup
from tpurec.ops.embedding_pallas import embedding_gather_fused
from tpurec.serve import quantize_table as jax_quantize
from tpurec_torch.nn.core import EmbeddingLayout, mixed_table_lookup
from tpurec_torch.ops.embedding import EmbeddingGather, embedding_gather
from tpurec_torch.serve import quantize_table

# a mixed layout: small fields (<= 8192 rows) and big fields interleaved
FIELD_DIMS = (9000, 7, 5, 12000, 3, 300)


def _torch_table(q):
    """numpy table from jax_quantize -> torch (bf16 via its bit pattern)."""
    if q.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(q).view(np.int16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.array(q))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_gather_matches_pallas_gather(rng, table_dtype):
    V, D, N = 400, 16, 300
    t = rng.normal(size=(V, D)).astype(np.float32)
    q, _ = jax_quantize(t, table_dtype)
    ids = rng.integers(0, V, N).astype(np.int32)
    want = embedding_gather_fused(jnp.asarray(q), jnp.asarray(ids),
                                  rows_per_block=128, interpret=True)
    got = embedding_gather(
        _torch_table(q), torch.from_numpy(ids)[:, None],
        torch.zeros(1, dtype=torch.int32), torch.full((1,), V, dtype=torch.int32))
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  np.asarray(want).astype(np.float32))


def _bad_ids(X, layout):
    """Overwrite some ids with out-of-range values: negative ids that wrap,
    ids past the field, past the small prefix, past the table, int32
    extremes."""
    X = X.copy()
    big, small = layout.big_fields[0], layout.small_fields[0]
    X[0, small] = -1                       # wraps inside the small prefix
    X[1, small] = layout.small_rows        # past the prefix -> fill
    X[2, big] = -5                         # wraps from the table's end
    X[3, big] = 10**7                      # past the table -> fill
    X[4, small] = -(10**6)                 # below -limit -> fill
    X[5, big] = np.iinfo(np.int32).max     # + offset wraps around int32
    X[6, small] = np.iinfo(np.int32).min
    return X


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_gather_matches_predictor_lookup(rng, table_dtype):
    """Port lookup == the JAX Predictor's (serve.py:202-206), in-range and
    out-of-range ids alike."""
    D, B = 8, 40
    jl = JaxLayout(FIELD_DIMS)
    t = rng.normal(size=(jl.vocab, D)).astype(np.float32)
    q, s = jax_quantize(t, table_dtype)
    X = np.stack([rng.integers(0, d, B) for d in FIELD_DIMS], 1)
    X = _bad_ids(X.astype(np.int32), jl)

    x = jnp.asarray(X)
    want = jax_mixed_lookup(jnp.asarray(q), x, jl).astype(jnp.float32)
    if s is not None:
        sc = jnp.take(jnp.asarray(s), x + jnp.asarray(jl.offsets)[None], axis=0)
        want = want * sc[:, :, None]

    got = mixed_table_lookup(
        _torch_table(q), torch.from_numpy(X), EmbeddingLayout(FIELD_DIMS),
        None if s is None else torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (B, len(FIELD_DIMS), D)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got[3].numpy()).any()          # the fill rule was hit


@pytest.mark.parametrize("field_dims", [FIELD_DIMS, (5, 7, 3), (9000, 10000),
                                        (250000, 10, 1368287, 50, 4)])
def test_layout_matches_jax(field_dims):
    a, b = JaxLayout(field_dims), EmbeddingLayout(field_dims)
    np.testing.assert_array_equal(a.offsets, b.offsets)
    assert (a.vocab, a.n_rows, a.small_rows, a.small_fields, a.big_fields) \
        == (b.vocab, b.n_rows, b.small_rows, b.small_fields, b.big_fields)


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_quantize_table_matches_jax(rng, table_dtype):
    t = rng.normal(size=(257, 16)).astype(np.float32) * 3
    t[5] = 0.0                     # all-zero row: scale 1.0
    t[7, :] = 127 * 0.25           # exact halves after scaling
    t[7, 0] = 127 * 0.5
    q, s = quantize_table(t, table_dtype)
    jq, js = jax_quantize(t, table_dtype)
    if table_dtype == "bfloat16":
        assert q.dtype == torch.bfloat16
        np.testing.assert_array_equal(q.view(torch.int16).numpy(),
                                      np.asarray(jq).view(np.int16))
    else:
        np.testing.assert_array_equal(q.numpy(), jq)
    if js is None:
        assert s is None
    else:
        np.testing.assert_array_equal(s.numpy(), js)


def test_gather_rejects_bad_arguments():
    t = torch.zeros(10, 4)
    ids = torch.zeros(3, 2, dtype=torch.int32)
    off = torch.zeros(2, dtype=torch.int32)
    lim = torch.full((2,), 10, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids"):
        embedding_gather(t, ids.long(), off, lim)
    with pytest.raises(ValueError, match="offsets"):
        embedding_gather(t, ids, off[:1], lim)
    with pytest.raises(ValueError, match="scales"):
        embedding_gather(t.to(torch.int8), ids, off, lim)
    with pytest.raises(ValueError, match="cuda or cpu"):
        embedding_gather(t.to("meta"), ids.to("meta"), off.to("meta"),
                         lim.to("meta"))


# -- the prepared gather (EmbeddingGather) ---------------------------------

@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_prepared_gather_matches_pallas_gather(rng, table_dtype):
    V, D, N = 400, 16, 300
    t = rng.normal(size=(V, D)).astype(np.float32)
    q, _ = jax_quantize(t, table_dtype)
    ids = rng.integers(0, V, N).astype(np.int32)
    want = embedding_gather_fused(jnp.asarray(q), jnp.asarray(ids),
                                  rows_per_block=128, interpret=True)
    g = EmbeddingGather(_torch_table(q), torch.zeros(1, dtype=torch.int32),
                        torch.full((1,), V, dtype=torch.int32))
    got = g(torch.from_numpy(ids)[:, None])
    np.testing.assert_array_equal(got[:, 0].numpy(),
                                  np.asarray(want).astype(np.float32))


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_prepared_gather_matches_one_shot_and_jax(rng, table_dtype):
    """layout.gather(table, scales)(ids) == embedding_gather(...) == the
    JAX Predictor's lookup, out-of-range ids included, over two calls of
    different lengths."""
    D, B = 8, 40
    jl = JaxLayout(FIELD_DIMS)
    t = rng.normal(size=(jl.vocab, D)).astype(np.float32)
    q, s = jax_quantize(t, table_dtype)
    X = np.stack([rng.integers(0, d, B) for d in FIELD_DIMS], 1)
    X = _bad_ids(X.astype(np.int32), jl)
    x = jnp.asarray(X)
    want = jax_mixed_lookup(jnp.asarray(q), x, jl).astype(jnp.float32)
    if s is not None:
        sc = jnp.take(jnp.asarray(s), x + jnp.asarray(jl.offsets)[None],
                      axis=0)
        want = want * sc[:, :, None]

    layout = EmbeddingLayout(FIELD_DIMS)
    table = _torch_table(q)
    scales = None if s is None else torch.from_numpy(s)
    ids = torch.from_numpy(X)
    g = layout.gather(table, scales)
    got = g(ids)
    offsets, limits = layout.device_arrays("cpu", table.shape[0])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(),
        embedding_gather(table, ids, offsets, limits, scales).numpy())
    np.testing.assert_array_equal(g(ids[:7].contiguous()).numpy(),
                                  got[:7].numpy())
    assert np.isnan(got[3].numpy()).any()          # the fill rule was hit


def _gather_args():
    return (torch.zeros(10, 4), torch.zeros(2, dtype=torch.int32),
            torch.full((2,), 10, dtype=torch.int32))


def test_prepared_gather_refuses_bad_ids():
    g = EmbeddingGather(*_gather_args())
    ids = torch.zeros(3, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="ids must be"):
        g(ids.long())                                   # dtype
    with pytest.raises(ValueError, match="ids must be"):
        g(torch.zeros(3, 3, dtype=torch.int32))         # width
    with pytest.raises(ValueError, match="ids must be"):
        g(torch.zeros(6, dtype=torch.int32))            # rank
    with pytest.raises(ValueError, match="ids are on meta"):
        g(ids.to("meta"))                               # device
    with pytest.raises(ValueError, match="contiguous"):
        g(torch.zeros(2, 3, dtype=torch.int32).t())
    assert g(ids).shape == (3, 2, 4)


@pytest.mark.parametrize("case,match", [
    ("table_rank", "table must be"),
    ("table_dtype", "table must be"),
    ("offsets_dtype", "offsets must be"),
    ("limits_length", "limits must be"),
    ("int8_without_scales", "scales go with"),
    ("float_with_scales", "scales go with"),
    ("scales_shape", "scales must be"),
    ("devices", "one device"),
    ("not_contiguous", "contiguous"),
    ("meta", "cuda or cpu"),
])
def test_prepared_gather_refuses_a_table_set_that_does_not_fit(case, match):
    table, off, lim = _gather_args()
    scales = None
    if case == "table_rank":
        table = torch.zeros(40)
    elif case == "table_dtype":
        table = table.double()
    elif case == "offsets_dtype":
        off = off.long()
    elif case == "limits_length":
        lim = lim[:1]
    elif case == "int8_without_scales":
        table = table.to(torch.int8)
    elif case == "float_with_scales":
        scales = torch.ones(10)
    elif case == "scales_shape":
        table, scales = table.to(torch.int8), torch.ones(9)
    elif case == "devices":
        off = off.to("meta")
    elif case == "not_contiguous":
        table = torch.zeros(4, 10).t()
    elif case == "meta":
        table, off, lim = table.to("meta"), off.to("meta"), lim.to("meta")
    with pytest.raises(ValueError, match=match):
        EmbeddingGather(table, off, lim, scales)


def test_prepared_gather_follows_its_table():
    """A module holds one gather per table: an update in place keeps it
    (and is seen), another table object rebuilds it."""
    from torch import nn

    from tpurec_torch.nn.core import FusedEmbedding

    emb = FusedEmbedding(FIELD_DIMS, 4, device="cpu")
    emb.reset_parameters(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(np.stack([rng.integers(0, d, 9)
                                     for d in FIELD_DIMS], 1).astype(np.int32))
    with torch.no_grad():
        y1 = emb(ids)
        g1 = emb._gather
        emb.table.mul_(2.0)
        y2 = emb(ids)
    assert emb._gather is g1
    torch.testing.assert_close(y2, 2.0 * y1, rtol=0, atol=0)
    emb.table = nn.Parameter(torch.zeros_like(emb.table))
    with torch.no_grad():
        y3 = emb(ids)
    assert emb._gather is not g1 and emb._gather.serves(emb.table)
    assert not g1.serves(emb.table)
    assert bool((y3 == 0).all())
