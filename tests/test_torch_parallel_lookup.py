"""The row-sharded table (tpurec_torch.parallel.embedding) and the mesh's
collectives, over gloo on the CPU, against the port's one-device gather
and the JAX package's sharded lookup on its virtual 8-device mesh.

One spawn per world (tests/test_torch_mesh_worker.py's ``lookup`` task):
2 ranks run (2, 1) and (1, 2); 4 ranks (2, 2), (4, 1) and (1, 4).  Each
rank gathers its data slice of the ids from its shard through
``sharded_embedding_lookup`` (kernel 1's plain version with the row
window, then the model group's sum), the function that the models'
``FusedEmbedding`` and the hybrid and sparse updates call, and the rows
are gathered over the data group for the check.

- The rows equal the one-device gather bit for bit, NaN fills included
  (ids past a field's rows): a row is read by one shard and the others
  add zeros.  The JAX package's mesh Trainer gives the same rows for the
  same out-of-range ids (its GSPMD lookup, checked here too).
- The table's gradient equals the one-device one: bit for bit on the
  model axis alone, within 1e-6 where the data ranks' partial sums are
  added (another summation order); the JAX package's within rtol 2e-6
  (XLA's own summation order).
- The collectives' backward rules: the model group's all-reduce passes
  the gradient through (an all-reduce there would count it n_model
  times), the data group's sums it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mesh_worker as mw
from tpurec_torch.ops.embedding import EmbeddingGather, embedding_lookup

SHAPES = {2: ["2x1", "1x2"], 4: ["2x2", "4x1", "1x4"]}
GRAD_ATOL = 1e-6
GRAD_RTOL_XLA = 2e-6


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("lookup")
    res = {}
    for w in (2, 4):
        mw.spawn("lookup", w, str(out))
        with np.load(out / f"lookup_{w}.npz", allow_pickle=True) as z:
            res.update({k: z[k] for k in z.files})
    return res


def _one_device(global_ids=False):
    layout, table, ids, w = mw.lookup_inputs()
    t = torch.from_numpy(table).requires_grad_(True)
    if global_ids:
        ids = np.clip(ids + layout.offsets[None], 0,
                      layout.vocab - 1).astype(np.int32)
        F = ids.shape[1]
        g = EmbeddingGather(t, torch.zeros(F, dtype=torch.int32),
                            torch.full((F,), layout.vocab,
                                       dtype=torch.int32))
    else:
        g = layout.gather(t)
    out = embedding_lookup(g, torch.from_numpy(ids))
    torch.nansum(torch.tanh(out) * torch.from_numpy(w)).backward()
    return out.detach().numpy(), t.grad.numpy()


ALL = [(w, s) for w in SHAPES for s in SHAPES[w]]


@pytest.mark.parametrize("shape", [s for _, s in ALL])
def test_coordinates_and_groups(runs, shape):
    n_data, n_model = map(int, shape.split("x"))
    layout = np.arange(n_data * n_model).reshape(n_data, n_model)
    for r, (d, m, data_ranks, model_ranks, d_sum, m_sum, gm, gd) in \
            enumerate(runs[f"{shape}/coords"]):
        assert (d, m) == divmod(r, n_model)
        assert data_ranks == list(layout[:, m])
        assert model_ranks == list(layout[d, :])
        assert d_sum == sum(data_ranks) and m_sum == sum(model_ranks)
        # loss = k * AR(3 x), k = rank + 1
        assert gm == 3.0 * (r + 1)                       # identity
        assert gd == 3.0 * sum(q + 1 for q in data_ranks)  # summed


@pytest.mark.parametrize("shape", [s for _, s in ALL])
def test_sharded_lookup_and_grad_match_one_device(runs, shape):
    rows, grad = _one_device()
    got = runs[f"{shape}/rows"]
    assert np.isnan(rows).any()
    np.testing.assert_array_equal(got, rows)         # NaN where NaN
    V, V_pad, n_local = runs[f"{shape}/shape"]
    n_model = int(shape.split("x")[1])
    assert V == grad.shape[0]
    assert V_pad % n_model == 0 and n_local * n_model == V_pad >= V
    if shape.startswith("1x"):
        np.testing.assert_array_equal(runs[f"{shape}/grad"], grad)
    else:
        np.testing.assert_allclose(runs[f"{shape}/grad"], grad, rtol=0,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", ["2x2", "1x4"])
def test_lookup_matches_tpurec_sharded_lookup(runs, shape):
    """tpurec/parallel/embedding.py's shard_map lookup on its virtual
    (n_data, n_model) mesh, from the same table and global-row ids."""
    from tpurec.parallel import make_mesh
    from tpurec.parallel.embedding import (shard_table,
                                           sharded_embedding_lookup)

    layout, table, ids, w = mw.lookup_inputs()
    gids = np.clip(ids + layout.offsets[None], 0,
                   layout.vocab - 1).astype(np.int32)
    n_data, n_model = map(int, shape.split("x"))
    mesh = make_mesh(n_data, n_model, devices=jax.devices()[:n_data
                                                            * n_model])

    def loss(tbl):
        with mesh:
            out = sharded_embedding_lookup(shard_table(tbl, mesh),
                                           jnp.asarray(gids), mesh)
        return jnp.sum(jnp.tanh(out) * w), out

    (_, out), g = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(table))
    np.testing.assert_array_equal(runs[f"{shape}/rows_global"],
                                  np.asarray(out))
    # XLA sums a row's gradients in another order than index_add_:
    # float32 rounding of a sum of up to 9 terms of size ~3
    np.testing.assert_allclose(runs[f"{shape}/grad_global"],
                               np.asarray(g)[:table.shape[0]],
                               rtol=GRAD_RTOL_XLA, atol=GRAD_ATOL)
    rows, grad = _one_device(global_ids=True)
    np.testing.assert_array_equal(runs[f"{shape}/rows_global"], rows)


def test_out_of_range_ids_match_tpurec_mesh_trainer(runs):
    """The lookup the JAX package's models run (mixed_table_lookup) on a
    row-sharded table of its virtual (2, 2) mesh, out-of-range ids
    included: the port's (2, 2) rows equal it, NaN fills and wraps too."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from tpurec.nn.core import EmbeddingLayout, mixed_table_lookup
    from tpurec.parallel import make_mesh

    _, table, ids, _ = mw.lookup_inputs()
    layout = EmbeddingLayout(mw.FIELD_DIMS)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    t = jax.device_put(jnp.asarray(table), NamedSharding(mesh, P("model",
                                                                 None)))
    x = jax.device_put(jnp.asarray(ids), NamedSharding(mesh, P("data",
                                                               None)))
    with mesh:
        want = np.asarray(jax.jit(lambda a, b: mixed_table_lookup(
            a, b, layout))(t, x))
    np.testing.assert_array_equal(runs["2x2/rows"], want)
