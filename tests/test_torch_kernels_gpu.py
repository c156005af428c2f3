"""tpurec_torch's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``gpu``: without a card each test skips (the decision is
made inside the fixture, so every worker collects the same tests).

Run on a machine with an H100:  python -m pytest tests/test_torch_kernels_gpu.py
"""

import numpy as np
import pytest
import torch

from tpurec_torch.ops.attention import (field_attention,
                                        field_attention_reference)
from tpurec_torch.ops.embedding import (embedding_gather,
                                        embedding_gather_reference)
from tpurec_torch.serve import quantize_table

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("D", [16, 6])
def test_gather_kernel_bit_exact(cuda, table_dtype, D):
    rng = np.random.default_rng(0)
    V, N, F = 5000, 97, 5
    q, s = quantize_table(rng.normal(size=(V, D)).astype(np.float32),
                          table_dtype)
    ids = rng.integers(-1200, 1200, (N, F)).astype(np.int32)
    ids[0, 0] = np.iinfo(np.int32).max
    offsets = np.array([0, 1000, 2000, 3000, 4000], np.int32)
    limits = np.array([1000, 3000, V, V, 2 * V], np.int32)
    args = [torch.from_numpy(a) for a in (ids, offsets, limits)]
    cpu = embedding_gather_reference(q, *args, s)
    before = embedding_gather.launches
    got = embedding_gather(q.to(cuda), *[a.to(cuda) for a in args],
                           None if s is None else s.to(cuda))
    torch.cuda.synchronize()
    assert embedding_gather.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), cpu.numpy())


@pytest.mark.parametrize("B,res", [(1, True), (37, True), (513, False)])
def test_attention_kernel_matches_plain(cuda, B, res):
    rng = np.random.default_rng(1)
    F, D, A, H, L = 23, 16, 64, 2, 3
    mk = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    flat = [mk(D, A), mk(A), mk(D, A) if res else None, mk(A) if res else None]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    emb = mk(B, F, D)
    want = field_attention_reference(emb, flat, L, H)
    before = field_attention.launches
    got = field_attention(emb, flat, L, H)
    torch.cuda.synchronize()
    assert field_attention.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4
