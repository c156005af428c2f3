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


# -- training: kernel 2 with dropout, kernel 3, kernels 6 and 7 -------------

def _attn_inputs(rng, cuda, B, res=True, F=23, D=16, A=64, L=3):
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    flat = [mk(D, A), mk(A), mk(D, A) if res else None,
            mk(A) if res else None]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    return mk(B, F, D), flat


def decoded_keep_masks(cuda, B, F, H, seed, rate):
    """Kernel 2's keep mask of layer 0, read back through its output: with
    q = k = 0 the softmax is 1/F, head h's value channel 0 of field g is
    2**g, so output column h*hd of field f is c * sum_g keep * 2**g."""
    from tpurec_torch.ops.attention import field_attention

    D, A = 4, 4 * H
    hd = A // H
    emb = torch.zeros(B, F, D)
    emb[:, :, 0] = 2.0 ** torch.arange(F)
    w_emb = torch.zeros(D, A)
    w_emb[0, 0] = 1.0
    w_in = torch.zeros(A, 3 * A)
    for h in range(H):
        w_in[0, 2 * A + h * hd] = 1.0
    flat = [w_emb, torch.zeros(A), None, None, w_in, torch.zeros(3 * A),
            torch.eye(A), torch.zeros(A)]
    y = field_attention(emb.to(cuda), [None if w is None else w.to(cuda)
                                       for w in flat], 1, H, train=True,
                        rate=rate, seed=seed)
    c = np.float32(np.float32(1.0) / np.float32(F)) / np.float32(1.0 - rate)
    ints = torch.round(y[..., ::hd].double().cpu() / float(c)).long()
    bits = (ints[..., None] >> torch.arange(F)) & 1          # [B, F, H, F]
    return bits.permute(0, 2, 1, 3).bool()


def test_attention_dropout_mask_is_the_plain_mask(cuda):
    from tpurec_torch.ops.attention import keep_mask

    seed = torch.tensor(31337, device=cuda)
    got = decoded_keep_masks(cuda, 64, 12, 2, seed, 0.2)
    want = keep_mask(seed.cpu(), 64, 0, 2, 12, 0.2)
    assert torch.equal(got, want)


@pytest.mark.parametrize("B", [1, 37, 513])
def test_attention_train_forward_matches_plain(cuda, B):
    from tpurec_torch.ops.attention import field_attention_fwd

    rng = np.random.default_rng(2)
    emb, flat = _attn_inputs(rng, cuda, B)
    seed = torch.tensor(5, device=cuda)
    saved_plain = []
    want = field_attention_reference(emb, flat, 3, 2, 0.2, seed,
                                     saved=saved_plain)
    y, saved = field_attention_fwd(emb, flat, 3, 2, 0.2, seed, save=True)
    torch.cuda.synchronize()
    assert (y - want).abs().max().item() <= 1e-4
    assert (saved - torch.stack(saved_plain)).abs().max().item() <= 1e-4


@pytest.mark.parametrize("B,res,rate", [(1, True, 0.2), (37, False, 0.0),
                                        (513, True, 0.2)])
def test_attention_backward_matches_autograd(cuda, B, res, rate):
    from tpurec_torch.ops.attention import field_attention_bwd

    rng = np.random.default_rng(3)
    emb, flat = _attn_inputs(rng, cuda, B, res)
    seed = torch.tensor(9, device=cuda)
    leaves = [None if w is None else w.clone().requires_grad_(True)
              for w in flat]
    e = emb.clone().requires_grad_(True)
    dy = torch.from_numpy(rng.normal(size=(B, 23, 64)).astype(
        np.float32)).to(cuda)
    saved = []
    field_attention_reference(e, leaves, 3, 2, rate, seed,
                              saved=saved).backward(dy)
    before = field_attention_bwd.launches
    demb, grads = field_attention_bwd(
        emb, dy, torch.stack(saved).detach(), flat, 3, 2, rate, seed)
    torch.cuda.synchronize()
    assert field_attention_bwd.launches == before + 1
    assert (demb - e.grad).abs().max().item() <= 1e-4
    for g, w in zip(grads, leaves):
        if w is None:
            assert g is None
            continue
        scale = max(1.0, w.grad.abs().max().item())
        assert (g - w.grad).abs().max().item() <= 1e-4 * scale


def test_attention_autograd_runs_both_kernels(cuda):
    """field_attention(train=True) on the card: kernel 2 forward, kernel 3
    backward, against autograd through the plain version, same seed."""
    from tpurec_torch.ops.attention import field_attention_bwd

    rng = np.random.default_rng(4)
    emb, flat = _attn_inputs(rng, cuda, 64)
    seed = torch.tensor(11, device=cuda)
    dy = torch.from_numpy(rng.normal(size=(64, 23, 64)).astype(
        np.float32)).to(cuda)

    def grads(fn):
        leaves = [w.clone().requires_grad_(True) for w in flat]
        e = emb.clone().requires_grad_(True)
        fn(e, leaves).backward(dy)
        return [e.grad] + [w.grad for w in leaves]

    before = (field_attention.launches, field_attention_bwd.launches)
    got = grads(lambda e, w: field_attention(e, w, 3, 2, train=True,
                                             rate=0.2, seed=seed))
    torch.cuda.synchronize()
    assert (field_attention.launches, field_attention_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    want = grads(lambda e, w: field_attention_reference(e, w, 3, 2, 0.2,
                                                        seed))
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
def test_decay_sweep_matches_plain(cuda, moments):
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_decay_adam_reference)

    g = torch.Generator().manual_seed(0)
    V, D, S = 10_008, 16, 901
    p = torch.randn(V, D, generator=g)
    m = (torch.randn(V, D, generator=g) * 0.01).to(moments)
    v = (torch.rand(V, D, generator=g) * 0.01).to(moments)
    gs = torch.randn(S, D, generator=g)
    kw = dict(lr=1e-3, coef=2e-5)
    want = fused_decay_adam_reference(*(t.to(cuda) for t in (p, m, v, gs)),
                                      4, **kw)
    got = fused_decay_adam(*(t.to(cuda) for t in (p, m, v, gs)), 4, **kw)
    torch.cuda.synchronize()
    assert (got[0] - want[0]).abs().max().item() <= 1e-6
    for a, b in zip(got[1:3], want[1:3]):
        # FMA contraction may move a float32 moment by an ulp of the terms
        # of b1 * m + (1 - b1) * u (more than one of the result where they
        # cancel), which can flip a bfloat16 rounding
        a, b = a.float(), b.float()
        tol = 1e-6 if moments == torch.float32 else 1e-2
        assert ((a - b).abs() <= tol * b.abs() + 1e-6 * b.abs().max()).all()
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-5)


def test_sparse_rows_match_plain(cuda):
    from tpurec_torch.ops.fused_adam import (adam_rows, fused_sparse_adam,
                                             write_rows)

    g = torch.Generator().manual_seed(1)
    V, D, N = 5000, 16, 1024
    p = torch.randn(V, D, generator=g)
    m = torch.randn(V, D, generator=g) * 0.01
    v = torch.rand(V, D, generator=g) * 0.01
    # heavy duplicates past a small-field prefix [0, 64), as the hybrid
    # step calls it
    ids = 100 + torch.randint(0, 50, (N,), generator=g)
    gr = torch.randn(N, D, generator=g)
    gs = torch.randn(64, D, generator=g)
    kw = dict(lr=1e-3, coef=2e-5)
    want = fused_sparse_adam(p.clone(), m.clone(), v.clone(), ids, gr, 3,
                             g_small=gs, **kw)
    before = (adam_rows.launches, write_rows.launches)
    got = fused_sparse_adam(*(t.to(cuda) for t in (p, m, v, ids, gr)), 3,
                            g_small=gs.to(cuda), **kw)
    torch.cuda.synchronize()
    assert (adam_rows.launches, write_rows.launches) == (before[0] + 1,
                                                         before[1] + 1)
    for a, b in zip(got[:3], want[:3]):
        assert (a.cpu() - b).abs().max().item() <= 2e-6
    # sentinels (>= V) and negative ids touch nothing
    ids2 = torch.tensor([4, V, V + 3, -1], device=cuda)
    t2 = p.to(cuda)
    m2, v2 = m.to(cuda), v.to(cuda)
    rows = adam_rows(t2, m2, v2, ids2, torch.ones(4, D, device=cuda), 1,
                     **kw)
    write_rows(t2, m2, v2, ids2, *rows)
    torch.cuda.synchronize()
    changed = (t2.cpu() != p).any(1).nonzero().flatten().tolist()
    assert changed == [4]
