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
    y = field_attention_reference(e, leaves, 3, 2, rate, seed, saved=saved)
    y.backward(dy)
    before = field_attention_bwd.launches
    demb, grads = field_attention_bwd(
        emb, dy, torch.stack(saved).detach(), y.detach(), flat, 3, 2, rate,
        seed)
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


def _sparse_case(V, D, ids, seed, moments, S=64):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(V, D, generator=g)
    m = (torch.randn(V, D, generator=g) * 0.01).to(moments)
    v = (torch.rand(V, D, generator=g) * 0.01).to(moments)
    gr = torch.randn(len(ids), D, generator=g)
    gs = torch.randn(S, D, generator=g)
    return p, m, v, torch.as_tensor(ids, dtype=torch.int64), gr, gs


@pytest.mark.parametrize("moments", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [16, 8, 24, 12])
@pytest.mark.parametrize("case", ["duplicates", "sentinels", "prefix",
                                  "all_equal"])
def test_sparse_rows_match_plain(cuda, D, case, moments):
    """Kernel 6 in the sweep's pass: one launch of the sweep with rows
    (fused_sparse_adam's count and the sweep's rise by one), equal to the
    plain version with duplicate ids, ids outside [0, V) (which touch
    nothing), touched rows inside g_small's prefix (which take their
    rows' step in its place) and 1,024 equal ids; bitwise repeatable.
    float32 moments: p, m and v within 2e-6; bfloat16: p within 2e-6 of
    max(1, |p'|), m and v within a bfloat16 rounding.  D = 24 and 12 put
    rows across the 256-value tiles, 12 also a lane's 8 values across two
    rows."""
    from tpurec_torch.ops.fused_adam import (fused_decay_adam,
                                             fused_sparse_adam,
                                             fused_sparse_adam_reference)

    V, N = 5008, 1024
    rng = np.random.default_rng(D)
    ids = {"duplicates": 100 + rng.integers(0, 50, N),
           "sentinels": np.where(rng.random(N) < 0.3,
                                 rng.choice([-1, -7, V, V + 9], N),
                                 rng.integers(0, V, N)),
           "prefix": rng.integers(0, 128, N),
           "all_equal": np.full(N, 70)}[case]
    p, m, v, ids, gr, gs = _sparse_case(V, D, ids, D, moments)
    kw = dict(lr=1e-3, coef=2e-5)
    want = fused_sparse_adam_reference(p.clone(), m.clone(), v.clone(), ids,
                                       gr, 3, g_small=gs, **kw)
    outs = []
    for _ in range(2):
        before = (fused_sparse_adam.launches, fused_decay_adam.launches)
        got = fused_sparse_adam(*(t.to(cuda) for t in (p, m, v, ids, gr)),
                                3, g_small=gs.to(cuda), **kw)
        torch.cuda.synchronize()
        assert (fused_sparse_adam.launches, fused_decay_adam.launches) == (
            before[0] + 1, before[1] + 1)
        outs.append([t.cpu() for t in got])
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    got = outs[0]
    if moments == torch.float32:
        for a, b in zip(got[:3], want[:3]):
            assert (a - b).abs().max().item() <= 2e-6
    else:
        scale = torch.maximum(want[0].abs(), torch.ones(()))
        assert ((got[0] - want[0]).abs() / scale).max().item() <= 2e-6
        for a, b in zip(got[1:3], want[1:3]):
            a, b = a.float(), b.float()
            assert ((a - b).abs() <= 1e-2 * b.abs()
                    + 1e-6 * b.abs().max()).all()
    assert float(got[3]) == pytest.approx(float(want[3]), rel=1e-5)


def test_sparse_rows_sentinels_touch_nothing(cuda):
    """Ids >= V and negative ids leave their neighbours as the sweep
    leaves them: with zero moments, lr 1e-2 and no weight decay, only the
    one real id's row moves."""
    from tpurec_torch.ops.fused_adam import fused_sparse_adam

    D = 16
    t = torch.randn(64, D, device=cuda)
    z = torch.zeros(64, D, device=cuda, dtype=torch.bfloat16)
    before = t.clone()
    fused_sparse_adam(t, z, z.clone(), torch.tensor([4, 64, 70, -1],
                                                    device=cuda),
                      torch.ones(4, D, device=cuda), 1, lr=1e-2)
    torch.cuda.synchronize()
    changed = (t != before).any(1).nonzero().flatten().tolist()
    assert changed == [4]


# -- the cross network (kernels 8, 9) and one attention layer (4, 5) --------

def _cross_inputs(cuda, B, D, L=3, seed=5):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, D, generator=g)
    w = torch.randn(L, D, generator=g) * 0.05
    b = torch.randn(L, D, generator=g) * 0.1
    gy = torch.randn(B, D, generator=g)
    return [t.to(cuda) for t in (x, w, b, gy)]


@pytest.mark.parametrize("B,D", [(1, 368), (513, 368), (4097, 368),
                                 (37, 13), (513, 13)])
def test_cross_kernels_match_plain(cuda, B, D):
    from tpurec_torch.ops.cross_network import (cross_network,
                                                cross_network_bwd,
                                                cross_network_bwd_reference,
                                                cross_network_fwd,
                                                cross_network_reference)

    x, w, b, gy = _cross_inputs(cuda, B, D)
    x[0, 3] = float("nan")                  # a real row holding NaN
    before = (cross_network.launches, cross_network_bwd.launches)
    y = cross_network_fwd(x, w, b)
    got = cross_network_bwd(x, w, b, gy)
    again = cross_network_bwd(x, w, b, gy)
    torch.cuda.synchronize()
    assert (cross_network.launches, cross_network_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    want_y = cross_network_reference(x, w, b)
    want = cross_network_bwd_reference(x, w, b, gy)
    # bitwise repeatable, NaN for NaN
    assert all(torch.equal(p.nan_to_num(7.0), q.nan_to_num(7.0))
               and torch.equal(p.isnan(), q.isnan())
               for p, q in zip(got, again))
    for a, e, rel in zip((y,) + got, (want_y,) + want,
                         (1e-5, 1e-5, 1e-4, 1e-4)):
        assert torch.equal(torch.isnan(a), torch.isnan(e))
        ok = ~torch.isnan(e)
        scale = e[ok].abs().max().item() if ok.any() else 1.0
        if ok.any():
            assert (a[ok] - e[ok]).abs().max().item() <= rel * scale
    assert torch.isnan(got[1]).any() and torch.isnan(got[2]).any()


def test_cross_autograd_runs_both_kernels(cuda):
    from tpurec_torch.ops.cross_network import (cross_network,
                                                cross_network_bwd,
                                                cross_network_reference)

    x, w, b, gy = _cross_inputs(cuda, 512, 368, seed=6)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        fn(*leaves).backward(gy)
        return [t.grad for t in leaves]

    before = (cross_network.launches, cross_network_bwd.launches)
    got = grads(cross_network)
    torch.cuda.synchronize()
    assert (cross_network.launches, cross_network_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    for a, e in zip(got, grads(cross_network_reference)):
        assert (a - e).abs().max().item() <= 1e-4 * max(
            1.0, e.abs().max().item())


@pytest.mark.parametrize("B,rate", [(1, 0.0), (513, 0.0), (1, 0.2),
                                    (513, 0.2)])
def test_attention_layer_kernels_match_plain(cuda, B, rate):
    from tpurec_torch.ops.attention import (attention_layer,
                                            attention_layer_bwd,
                                            attention_layer_bwd_reference,
                                            attention_layer_fwd,
                                            fused_attention_layer, keep_mask)

    rng = np.random.default_rng(7)
    F, A, H = 23, 64, 2
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    x, dy = mk(B, F, A), mk(B, F, A)
    ws = [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    seed = torch.tensor(21, device=cuda)
    before = (fused_attention_layer.launches, attention_layer_bwd.launches)
    y = attention_layer_fwd(x, *ws, H, 2, rate, seed)
    dx, grads = attention_layer_bwd(x, dy, *ws, H, 2, rate, seed)
    dx2, grads2 = attention_layer_bwd(x, dy, *ws, H, 2, rate, seed)
    torch.cuda.synchronize()
    assert (fused_attention_layer.launches, attention_layer_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert torch.equal(dx, dx2) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    keep = keep_mask(seed, B, 2, H, F, rate) if rate else None
    assert (y - attention_layer(x, *ws, H, keep, rate)).abs().max() <= 1e-4
    dx_r, grads_r = attention_layer_bwd_reference(x, dy, *ws, H, 2, rate,
                                                  seed)
    assert (dx - dx_r).abs().max().item() <= 1e-4
    for g, e in zip(grads, grads_r):
        assert (g - e).abs().max().item() <= 1e-4 * max(
            1.0, e.abs().max().item())


def test_layered_equals_stack_on_the_card(cuda):
    """field_attention_layered (kernels 4, 5) in training with seed s and
    field_attention (kernels 2, 3) with seed s: one output, one gradient."""
    from tpurec_torch.ops.attention import (attention_layer_bwd,
                                            field_attention_bwd,
                                            field_attention_layered,
                                            fused_attention_layer)

    rng = np.random.default_rng(8)
    emb, flat = _attn_inputs(rng, cuda, 96)
    seed = torch.tensor(77, device=cuda)
    dy = torch.from_numpy(rng.normal(size=(96, 23, 64)).astype(
        np.float32)).to(cuda)

    def run(fn):
        leaves = [w.clone().requires_grad_(True) for w in flat]
        e = emb.clone().requires_grad_(True)
        y = fn(e, leaves, 3, 2, train=True, rate=0.2, seed=seed)
        y.backward(dy)
        return [y.detach(), e.grad] + [w.grad for w in leaves]

    before = [f.launches for f in (fused_attention_layer,
                                   attention_layer_bwd, field_attention,
                                   field_attention_bwd)]
    layered, stack = run(field_attention_layered), run(field_attention)
    torch.cuda.synchronize()
    after = [f.launches for f in (fused_attention_layer, attention_layer_bwd,
                                  field_attention, field_attention_bwd)]
    assert [a - b for a, b in zip(after, before)] == [3, 3, 1, 1]
    for a, b in zip(layered, stack):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            1.0, b.abs().max().item())


# -- kernel 2 in blocks of R batch rows; the prepared gather ----------------

def _flagship_rows(cuda):
    from tpurec_torch.ops.attention import _sm_count, fwd_config

    return fwd_config(4096, 23, 16, 64, 2, _sm_count(cuda))[0]


@pytest.mark.parametrize("shape", [(23, 16, 64, 3), (12, 4, 8, 1),
                                   (100, 16, 64, 1)])
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_attention_forward_in_row_blocks_matches_plain(cuda, shape, rate):
    """Kernel 2 (eval, and training with its saved layer inputs) against
    the plain version at B = 1, R - 1, R, R + 1, 513 and 4097 (the last
    block partly past B), bitwise repeatable over two calls.  F=100 is
    too wide to stage the weights in shared memory: its products read
    them from device memory."""
    from tpurec_torch.ops.attention import field_attention_fwd

    from tpurec_torch.ops.attention import _sm_count, fwd_config

    F, D, A, L = shape
    R = _flagship_rows(cuda)
    assert fwd_config(4096, F, D, A, 2, _sm_count(cuda))[1] == (F < 100)
    rng = np.random.default_rng(12)
    seed = torch.tensor(17, device=cuda)
    worst = 0.0
    for B in sorted({1, max(1, R - 1), R, R + 1, 513, 4097}):
        emb, flat = _attn_inputs(rng, cuda, B, F=F, D=D, A=A, L=L)
        saved_plain = []
        want = field_attention_reference(emb, flat, L, 2, rate, seed,
                                         saved=saved_plain)
        y, saved = field_attention_fwd(emb, flat, L, 2, rate, seed,
                                       save=rate > 0)
        y2, saved2 = field_attention_fwd(emb, flat, L, 2, rate, seed,
                                         save=rate > 0)
        torch.cuda.synchronize()
        assert torch.equal(y, y2)
        err = (y - want).abs().max().item()
        if rate > 0:
            assert torch.equal(saved, saved2)
            err = max(err, (saved - torch.stack(saved_plain)).abs().max()
                      .item())
        assert err <= 1e-4, (B, err)
        worst = max(worst, err)
    print(f"kernel 2 {shape} rate {rate}: max abs err {worst:.3g} vs plain")


def test_attention_nan_stays_in_its_batch_row(cuda):
    """A NaN in one batch row's embeddings reaches that row's output and
    leaves its block-mates' bit for bit."""
    rng = np.random.default_rng(13)
    emb, flat = _attn_inputs(rng, cuda, 512)
    assert _flagship_rows(cuda) > 1
    y0 = field_attention(emb, flat, 3, 2)
    bad = emb.clone()
    bad[5, 3, 0] = float("nan")
    y1 = field_attention(bad, flat, 3, 2)
    torch.cuda.synchronize()
    others = [r for r in range(512) if r != 5]
    assert bool(torch.isnan(y1[5]).any())
    assert torch.equal(y0[others], y1[others])


def test_attention_dropout_mask_across_row_blocks(cuda):
    """decoded_keep_masks at a batch that the wrapper stacks R > 1 rows a
    block for: the kernel's mask is still the plain hash of the global
    batch row."""
    from tpurec_torch.ops.attention import _sm_count, keep_mask, \
        rows_per_block

    assert rows_per_block(600, 12, 4, 8, 2, _sm_count(cuda)) > 1
    seed = torch.tensor(4711, device=cuda)
    got = decoded_keep_masks(cuda, 600, 12, 2, seed, 0.2)
    want = keep_mask(seed.cpu(), 600, 0, 2, 12, 0.2)
    assert torch.equal(got, want)


def test_attention_backward_from_kernel_saved_inputs(cuda):
    """Kernel 3 fed by kernel 2's saved layer inputs against autograd
    through the plain version, one dropout seed."""
    from tpurec_torch.ops.attention import (field_attention_bwd,
                                            field_attention_fwd)

    rng = np.random.default_rng(14)
    emb, flat = _attn_inputs(rng, cuda, 513)
    seed = torch.tensor(23, device=cuda)
    dy = torch.from_numpy(rng.normal(size=(513, 23, 64)).astype(
        np.float32)).to(cuda)
    y, saved = field_attention_fwd(emb, flat, 3, 2, 0.2, seed, save=True)
    demb, grads = field_attention_bwd(emb, dy, saved, y, flat, 3, 2, 0.2,
                                      seed)
    leaves = [w.clone().requires_grad_(True) for w in flat]
    e = emb.clone().requires_grad_(True)
    field_attention_reference(e, leaves, 3, 2, 0.2, seed).backward(dy)
    torch.cuda.synchronize()
    assert (demb - e.grad).abs().max().item() <= 1e-4
    for g, w in zip(grads, leaves):
        scale = max(1.0, w.grad.abs().max().item())
        assert (g - w.grad).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
def test_prepared_gather_bit_exact(cuda, table_dtype):
    """EmbeddingGather on the card: bit-exact against the plain version at
    N = 1, 97, 4097 with out-of-range ids, one launch a call, and an
    update of the table in place seen by the next call."""
    from tpurec_torch.ops.embedding import EmbeddingGather

    rng = np.random.default_rng(15)
    V, F, D = 5000, 5, 16
    q, s = quantize_table(rng.normal(size=(V, D)).astype(np.float32),
                          table_dtype)
    ids = rng.integers(-1200, 1200, (4097, F)).astype(np.int32)
    ids[0, 0] = np.iinfo(np.int32).max
    offsets = torch.tensor([0, 1000, 2000, 3000, 4000], dtype=torch.int32)
    limits = torch.tensor([1000, 3000, V, V, 2 * V], dtype=torch.int32)
    table = q.to(cuda)
    scales = None if s is None else s.to(cuda)
    g = EmbeddingGather(table, offsets.to(cuda), limits.to(cuda), scales)
    before = embedding_gather.launches
    for n in (1, 97, 4097):
        x = torch.from_numpy(ids[:n].copy())
        got = g(x.to(cuda))
        want = embedding_gather_reference(q, x, offsets, limits, s)
        torch.cuda.synchronize()
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())
    assert embedding_gather.launches == before + 3
    if table_dtype == "float32":
        table.mul_(2.0)
        x = torch.from_numpy(ids[:97].copy())
        got = g(x.to(cuda))
        want = embedding_gather_reference(q * 2.0, x, offsets, limits)
        np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


# -- kernels 3 and 5 in groups of R batch rows on a persistent grid ---------

RAGGED = ["1", "R-1", "R", "R+1", "512", "513", "4097"]


def _ragged_batch(cuda, which):
    """A batch size of the list above, R the rows a backward group stacks
    at the flagship shapes."""
    from tpurec_torch.ops.attention import _sm_count, bwd_config

    R = bwd_config(512, 23, 16, 64, 2, _sm_count(cuda))[0]
    by_r = {"R-1": R - 1, "R": R, "R+1": R + 1}
    return max(1, by_r[which] if which in by_r else int(which))


def _away_from_relu_kink(emb, flat, rate, seed, dy, L=3, H=2):
    """dy with zeros where the plain forward's pre-ReLU value (float64)
    lies within 1e-4 of 0: there rounding alone sets the ReLU's mask, and
    the kernel's recomputed value and the plain version's may fall on
    either side, each gradient right for its own rounding."""
    from tpurec_torch.ops.attention import attention_layer, keep_mask

    e = emb.double()
    f = [None if w is None else w.double() for w in flat]
    saved = []
    field_attention_reference(e, f, L, H, rate, seed, saved=saved)
    keep = (keep_mask(seed, emb.shape[0], L - 1, H, emb.shape[1], rate)
            if rate else None)
    z = attention_layer(saved[-1], *f[4 + 4 * (L - 1):], H, keep, rate)
    if f[2] is not None:
        z = z + (e @ f[2] + f[3])
    return torch.where(z.abs() < 1e-4, torch.zeros_like(dy), dy)


def _stack_bwd_vs_autograd(cuda, emb, flat, dy, rate, seed):
    """Kernel 3 twice and autograd through the plain version: -> (demb,
    grads, the plain demb, the plain grads), the two calls bitwise equal."""
    from tpurec_torch.ops.attention import field_attention_bwd

    leaves = [None if w is None else w.clone().requires_grad_(True)
              for w in flat]
    e = emb.clone().requires_grad_(True)
    saved = []
    y = field_attention_reference(e, leaves, 3, 2, rate, seed, saved=saved)
    y.backward(dy)
    saved, y = torch.stack(saved).detach(), y.detach()
    before = field_attention_bwd.launches
    demb, grads = field_attention_bwd(emb, dy, saved, y, flat, 3, 2, rate,
                                      seed)
    demb2, grads2 = field_attention_bwd(emb, dy, saved, y, flat, 3, 2, rate,
                                        seed)
    torch.cuda.synchronize()
    assert field_attention_bwd.launches == before + 2
    assert torch.equal(demb.nan_to_num(7.0), demb2.nan_to_num(7.0))
    for g, g2 in zip(grads, grads2):
        assert g is None or torch.equal(g.nan_to_num(7.0), g2.nan_to_num(7.0))
    return demb, grads, e.grad, [None if w is None else w.grad
                                 for w in leaves]


@pytest.mark.parametrize("which", RAGGED)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_stack_backward_at_ragged_batches(cuda, which, rate):
    """Kernel 3 against autograd of the plain version at B = 1, R - 1, R,
    R + 1, 512, 513, 4097, with and without the residual: demb within
    1e-4, weight gradients within 1e-4 x max(1, max|g|), bitwise
    repeatable."""
    B = _ragged_batch(cuda, which)
    rng = np.random.default_rng(30 + B)
    seed = torch.tensor(41, device=cuda)
    for res in (True, False):
        emb, flat = _attn_inputs(rng, cuda, B, res)
        dy = torch.from_numpy(rng.normal(size=(B, 23, 64)).astype(
            np.float32)).to(cuda)
        dy = _away_from_relu_kink(emb, flat, rate, seed, dy)
        demb, grads, want, want_g = _stack_bwd_vs_autograd(
            cuda, emb, flat, dy, rate, seed)
        assert (demb - want).abs().max().item() <= 1e-4, (B, res)
        for g, w in zip(grads, want_g):
            if w is None:
                assert g is None
                continue
            assert (g - w).abs().max().item() <= 1e-4 * max(
                1.0, w.abs().max().item()), (B, res)


@pytest.mark.parametrize("which", RAGGED)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_layer_backward_at_ragged_batches(cuda, which, rate):
    """Kernel 5 against the plain version at the same batch sizes, bitwise
    repeatable."""
    from tpurec_torch.ops.attention import (attention_layer_bwd,
                                            attention_layer_bwd_reference)

    B = _ragged_batch(cuda, which)
    rng = np.random.default_rng(50 + B)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    x, dy = mk(B, 23, 64) * 5, mk(B, 23, 64) * 5
    ws = [mk(64, 192), mk(192), mk(64, 64), mk(64)]
    seed = torch.tensor(43, device=cuda)
    dx, grads = attention_layer_bwd(x, dy, *ws, 2, 1, rate, seed)
    dx2, grads2 = attention_layer_bwd(x, dy, *ws, 2, 1, rate, seed)
    want, want_g = attention_layer_bwd_reference(x, dy, *ws, 2, 1, rate,
                                                 seed)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and all(
        torch.equal(a, b) for a, b in zip(grads, grads2))
    assert (dx - want).abs().max().item() <= 1e-4
    for g, w in zip(grads, want_g):
        assert (g - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


def test_backward_nan_stays_in_its_batch_row(cuda):
    """A NaN in one batch row's input: its group-mates' demb (kernel 3) and
    dx (kernel 5) still equal the plain version's, while the weight
    gradients, sums over every row, go NaN as the plain version's do."""
    from tpurec_torch.ops.attention import (attention_layer_bwd,
                                            attention_layer_bwd_reference)

    rng = np.random.default_rng(60)
    B, bad = 512, 5
    emb, flat = _attn_inputs(rng, cuda, B)
    seed = torch.tensor(47, device=cuda)
    dy = torch.from_numpy(rng.normal(size=(B, 23, 64)).astype(
        np.float32)).to(cuda)
    dy = _away_from_relu_kink(emb, flat, 0.2, seed, dy)
    emb[bad, 3, 0] = float("nan")
    demb, grads, want, want_g = _stack_bwd_vs_autograd(
        cuda, emb, flat, dy, 0.2, seed)
    others = [r for r in range(B) if r != bad]
    assert bool(torch.isnan(demb[bad]).any())
    assert (demb[others] - want[others]).abs().max().item() <= 1e-4
    for g, w in zip(grads, want_g):
        assert bool(torch.isnan(g).any()) == bool(torch.isnan(w).any())
    assert any(bool(torch.isnan(g).any()) for g in grads)

    x = torch.from_numpy(rng.normal(size=(B, 23, 64)).astype(
        np.float32)).to(cuda)
    x[bad, 7, 1] = float("nan")
    ws = flat[4:8]
    dx, lg = attention_layer_bwd(x, dy, *ws, 2, 0, 0.2, seed)
    want, want_g = attention_layer_bwd_reference(x, dy, *ws, 2, 0, 0.2,
                                                 seed)
    torch.cuda.synchronize()
    assert bool(torch.isnan(dx[bad]).any())
    assert (dx[others] - want[others]).abs().max().item() <= 1e-4
    for g, w in zip(lg, want_g):
        assert bool(torch.isnan(g).any()) == bool(torch.isnan(w).any())


def test_backward_dropout_mask_across_row_groups(cuda):
    """Kernel 5's dropout mask read back through dx: with q = k = 0 the
    softmax is 1/F, the in-projection passes v = x and dx = dv, and dy's
    channel h*hd of field f is 2**f, so dx's channel h*hd of key field g
    is c * sum_f keep[h, f, g] * 2**f.  At B=600 (many groups of R rows,
    several a block) the kernel's mask is the plain hash of the global
    batch row."""
    from tpurec_torch.ops.attention import (_sm_count, attention_layer_bwd,
                                            keep_mask, layer_bwd_config)

    B, F, H, rate = 600, 12, 2, 0.2
    A = 4 * H
    hd = A // H
    R, _, _, grid = layer_bwd_config(B, F, A, H, _sm_count(cuda))
    assert R > 1 and -(-B // R) > grid
    w_in = torch.zeros(A, 3 * A)
    w_in[:, 2 * A:] = torch.eye(A)
    ws = [w.to(cuda) for w in (w_in, torch.zeros(3 * A), torch.eye(A),
                               torch.zeros(A))]
    x = torch.zeros(B, F, A, device=cuda)
    dy = torch.zeros(B, F, A)
    for h in range(H):
        dy[:, :, h * hd] = 2.0 ** torch.arange(F)
    seed = torch.tensor(4711, device=cuda)
    dx, _ = attention_layer_bwd(x, dy.to(cuda), *ws, H, 1, rate, seed)
    c = np.float32(np.float32(1.0) / np.float32(F)) / np.float32(1.0 - rate)
    ints = torch.round(dx[..., ::hd].double().cpu() / float(c)).long()
    bits = (ints[..., None] >> torch.arange(F)) & 1        # [B, g, H, f]
    got = bits.permute(0, 2, 3, 1).bool()                  # [B, H, f, g]
    assert torch.equal(got, keep_mask(seed.cpu(), B, 1, H, F, rate))


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_backward_unstaged_and_one_row_groups(cuda, rate):
    """A=128: w_in and w_out do not fit beside a group's activations, so
    kernels 3 and 5 read them from device memory and stack one batch row
    a group; both against autograd of the plain version."""
    from tpurec_torch.ops.attention import (_sm_count, attention_layer_bwd,
                                            attention_layer_bwd_reference,
                                            bwd_config, layer_bwd_config)

    n_sm = _sm_count(cuda)
    assert bwd_config(37, 23, 16, 128, 2, n_sm)[:2] == (1, False)
    assert layer_bwd_config(37, 23, 128, 2, n_sm)[1] is False
    rng = np.random.default_rng(70)
    emb, flat = _attn_inputs(rng, cuda, 37, A=128)
    # weights scaled by sqrt(64 / A): activations and gradients at the
    # flagship's scale (unscaled, demb reaches about 1.6e3)
    flat = [w * 0.5 ** 0.5 for w in flat]
    seed = torch.tensor(53, device=cuda)
    dy = torch.from_numpy(rng.normal(size=(37, 23, 128)).astype(
        np.float32)).to(cuda)
    dy = _away_from_relu_kink(emb, flat, rate, seed, dy)
    demb, grads, want, want_g = _stack_bwd_vs_autograd(
        cuda, emb, flat, dy, rate, seed)
    assert (demb - want).abs().max().item() <= 1e-4
    for g, w in zip(grads, want_g):
        assert (g - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())
    x = torch.from_numpy(rng.normal(size=(37, 23, 128)).astype(
        np.float32)).to(cuda)
    dx, lg = attention_layer_bwd(x, dy, *flat[4:8], 2, 0, rate, seed)
    want, want_g = attention_layer_bwd_reference(x, dy, *flat[4:8], 2, 0,
                                                 rate, seed)
    torch.cuda.synchronize()
    assert (dx - want).abs().max().item() <= 1e-4
    for g, w in zip(lg, want_g):
        assert (g - w).abs().max().item() <= 1e-4 * max(
            1.0, w.abs().max().item())


# -- kernel 4 in blocks of R batch rows; kernel 9 in one launch -------------

def _layer_batch(cuda, which):
    """A batch size of LAYER_RAGGED, R the rows a kernel-4 block stacks at
    the flagship shapes."""
    from tpurec_torch.ops.attention import _sm_count, layer_fwd_config

    R = layer_fwd_config(512, 23, 64, 2, _sm_count(cuda))[0]
    by_r = {"R-1": R - 1, "R": R, "R+1": R + 1}
    return max(1, by_r[which] if which in by_r else int(which))


LAYER_RAGGED = ["1", "R-1", "R", "R+1", "511", "512", "513", "4097"]


@pytest.mark.parametrize("which", LAYER_RAGGED)
@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_layer_forward_in_row_blocks_matches_plain(cuda, which, rate):
    """Kernel 4 against its plain version at B = 1, R - 1, R, R + 1, 511,
    512, 513 and 4097 (the last block partly past B where R does not
    divide B), with dropout 0 and 0.2: within 1e-4, bitwise repeatable,
    one launch a call."""
    from tpurec_torch.ops.attention import (attention_layer,
                                            attention_layer_fwd,
                                            fused_attention_layer, keep_mask)

    B = _layer_batch(cuda, which)
    rng = np.random.default_rng(80 + B)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    x = mk(B, 23, 64) * 5
    ws = [mk(64, 192), mk(192), mk(64, 64), mk(64)]
    seed = torch.tensor(61, device=cuda)
    before = fused_attention_layer.launches
    y = attention_layer_fwd(x, *ws, 2, 1, rate, seed)
    y2 = attention_layer_fwd(x, *ws, 2, 1, rate, seed)
    torch.cuda.synchronize()
    assert fused_attention_layer.launches == before + 2
    assert torch.equal(y, y2)
    keep = keep_mask(seed, B, 1, 2, 23, rate) if rate else None
    want = attention_layer(x, *ws, 2, keep, rate)
    assert (y - want).abs().max().item() <= 1e-4, B


def test_layer_forward_nan_stays_in_its_batch_row(cuda):
    """A NaN in one batch row's input reaches that row's output and leaves
    its block-mates' bit for bit."""
    from tpurec_torch.ops.attention import (_sm_count, attention_layer_fwd,
                                            layer_fwd_config)

    assert layer_fwd_config(512, 23, 64, 2, _sm_count(cuda))[0] > 1
    rng = np.random.default_rng(90)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        (rng.normal(size=s) * 0.2).astype(np.float32)).to(cuda)
    x = mk(512, 23, 64) * 5
    ws = [mk(64, 192), mk(192), mk(64, 64), mk(64)]
    y0 = attention_layer_fwd(x, *ws, 2)
    bad = x.clone()
    bad[5, 3, 0] = float("nan")
    y1 = attention_layer_fwd(bad, *ws, 2)
    torch.cuda.synchronize()
    others = [r for r in range(512) if r != 5]
    assert bool(torch.isnan(y1[5]).any())
    assert torch.equal(y0[others], y1[others])


# B = 1, then each side of the boundaries of kernel 9's launch at D=368: 2
# rows a warp, 8 a block, 64 a cluster, 1024 a full grid's pass
CROSS_BATCHES = [1, 2, 3, 7, 8, 9, 63, 64, 65, 1023, 1024, 1025, 4097]


def _cross_bwd_vs_plain(cuda, x, w, b, gy):
    """Kernel 9 twice against its plain version: the two calls bitwise
    equal, NaN for NaN; dx within 1e-5 and dw, db within 1e-4 of their
    scales where the plain value is not NaN.  -> the kernel's result."""
    from tpurec_torch.ops.cross_network import (cross_network_bwd,
                                                cross_network_bwd_reference)

    got = cross_network_bwd(x, w, b, gy)
    again = cross_network_bwd(x, w, b, gy)
    want = cross_network_bwd_reference(x, w, b, gy)
    torch.cuda.synchronize()
    for p, q in zip(got, again):
        assert torch.equal(p.nan_to_num(7.0), q.nan_to_num(7.0))
        assert torch.equal(p.isnan(), q.isnan())
    for a, e, rel in zip(got, want, (1e-5, 1e-4, 1e-4)):
        assert torch.equal(torch.isnan(a), torch.isnan(e))
        ok = ~torch.isnan(e)
        if ok.any():
            scale = e[ok].abs().max().item()
            assert (a[ok] - e[ok]).abs().max().item() <= rel * scale
    return got


@pytest.mark.parametrize("B", CROSS_BATCHES)
def test_cross_backward_at_launch_boundaries(cuda, B):
    from tpurec_torch.ops.cross_network import bwd_config

    assert bwd_config(512, 368, 3, 4)[:3] == (4, 2, 64)
    _cross_bwd_vs_plain(cuda, *_cross_inputs(cuda, B, 368, seed=B))


def test_cross_backward_nan_row_reaches_weight_gradients(cuda):
    """A real row holding NaN, in a warp's second row slot and a later
    cluster's block: dw and db go NaN as the plain version's do, and the
    other rows' dx stay finite."""
    x, w, b, gy = _cross_inputs(cuda, 1025, 368, seed=9)
    x[601, 11] = float("nan")
    dx, dw, db = _cross_bwd_vs_plain(cuda, x, w, b, gy)
    assert bool(torch.isnan(dw).any() and torch.isnan(db).any())
    others = [r for r in range(1025) if r != 601]
    assert bool(torch.isfinite(dx[others]).all())


def test_cross_backward_is_one_launch(cuda):
    """One call of kernel 9's wrapper launches one kernel on the card (the
    ordered cross-block sum runs inside it)."""
    from torch.profiler import ProfilerActivity, profile

    from tpurec_torch.ops.cross_network import cross_network_bwd

    x, w, b, gy = _cross_inputs(cuda, 512, 368, seed=10)
    cross_network_bwd(x, w, b, gy)                 # the stream's counter
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cross_network_bwd(x, w, b, gy)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and e.self_device_time_total > 0]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "cross_bwd_kernel" in kernels[0][0]


def _cross_fwd_launch(cuda, x, w, b, warps, rows):
    """Kernel 8 through its C entry point at `warps` warps a block and
    `rows` rows a warp (16-byte loads)."""
    from tpurec_torch.ops import _build
    from tpurec_torch.ops import cross_network as cn

    lib = _build.load("cross_network", cn._SIGNATURES)
    (B, D), L = x.shape, w.shape[0]
    out = torch.full_like(x, float("nan"))
    rc = lib.tpurec_cross_network_fwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), B, D, L, 4, warps, rows,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    return out


def _cross_fwd_close(got, want):
    """Within 1e-5 of the output's scale where the plain value is not NaN,
    NaN where it is."""
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    scale = want[ok].abs().max().item()
    assert (got[ok] - want[ok]).abs().max().item() <= 1e-5 * scale


@pytest.mark.parametrize("B", CROSS_BATCHES + [512, 4096])
def test_cross_forward_at_ragged_batches(cuda, B):
    """Kernel 8's wrapper at each side of its launch's boundaries (1 or 2
    rows a warp, 4 warps a block), bitwise repeatable, one launch a
    call."""
    from tpurec_torch.ops.cross_network import (cross_network,
                                                cross_network_fwd,
                                                cross_network_reference)

    x, w, b, _ = _cross_inputs(cuda, B, 368, seed=B + 1)
    before = cross_network.launches
    y = cross_network_fwd(x, w, b)
    again = cross_network_fwd(x, w, b)
    torch.cuda.synchronize()
    assert cross_network.launches == before + 2
    assert torch.equal(y, again)
    _cross_fwd_close(y, cross_network_reference(x, w, b))


@pytest.mark.parametrize("warps", range(1, 9))
@pytest.mark.parametrize("rows", [1, 2])
def test_cross_forward_at_each_launch_setting(cuda, warps, rows):
    """Every rows-a-block and rows-a-warp setting phase 15 times gives the
    plain version's output, at a ragged batch."""
    from tpurec_torch.ops.cross_network import cross_network_reference

    x, w, b, _ = _cross_inputs(cuda, 1037, 368, seed=warps)
    got = _cross_fwd_launch(cuda, x, w, b, warps, rows)
    torch.cuda.synchronize()
    _cross_fwd_close(got, cross_network_reference(x, w, b))


def test_cross_forward_nan_row_stays_in_its_row(cuda):
    """A row holding NaN is NaN throughout, as the recurrence makes it;
    its warp-mate (the other row of its warp) is untouched."""
    from tpurec_torch.ops.cross_network import (cross_network_fwd,
                                                cross_network_reference)

    x, w, b, _ = _cross_inputs(cuda, 513, 368, seed=11)
    clean = cross_network_fwd(x, w, b)
    x[200, 7] = float("nan")
    y = cross_network_fwd(x, w, b)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[200]).all())
    others = [r for r in range(513) if r != 200]
    assert torch.equal(y[others], clean[others])
    _cross_fwd_close(y, cross_network_reference(x, w, b))


@pytest.mark.parametrize("L", [1, 2, 4, 5, 11])
@pytest.mark.parametrize("B", [513, 4096])
def test_cross_forward_at_any_depth(cuda, L, B):
    """Kernel 8 takes the layers three at a time: a depth that leaves a
    partial group, and one over the backward's 8, give the plain
    version's output (1 and 2 rows a warp)."""
    from tpurec_torch.ops.cross_network import (cross_network_fwd,
                                                cross_network_reference)

    x, w, b, _ = _cross_inputs(cuda, B, 368, L=L, seed=L)
    y = cross_network_fwd(x, w, b)
    torch.cuda.synchronize()
    _cross_fwd_close(y, cross_network_reference(x, w, b))


def test_cross_forward_inf_row(cuda):
    """The kept difference of kernel 8's rewrite: with x0[j] = +inf, c_l
    is inf with w_l[j]'s sign, and where w_l[j] > 0 for every l >= 1 the
    row's S_L is +-inf and its outputs +-inf, where the recurrence's dot
    products of mixed-sign infinities make it NaN; elsewhere both are NaN
    throughout.  No other row is touched."""
    from tpurec_torch.ops.cross_network import (cross_network_fwd,
                                                cross_network_reference)

    x, w, b, _ = _cross_inputs(cuda, 513, 368, seed=12)
    pos = (w[1:] > 0).all(0)
    cols = {"w0>0": int(torch.nonzero(pos & (w[0] > 0))[0]),
            "w0<0": int(torch.nonzero(pos & (w[0] < 0))[0]),
            "mixed": int(torch.nonzero(~pos)[0])}
    clean = cross_network_fwd(x, w, b)
    for r, j in enumerate(cols.values()):
        x[300 + r, j] = float("inf")
    y = cross_network_fwd(x, w, b)
    want = cross_network_reference(x, w, b)
    torch.cuda.synchronize()
    for r, (what, j) in enumerate(cols.items()):
        row, plain = y[300 + r], want[300 + r]
        assert bool(torch.isnan(plain).all()), what
        if what == "mixed":
            assert bool(torch.isnan(row).all()), what
        else:
            assert bool(torch.isinf(row).all()), what
    others = [i for i in range(513) if not 300 <= i < 303]
    assert torch.equal(y[others], clean[others])


def test_predict_async_submits_without_a_sync(cuda):
    """Predictor.predict_async on the card stages ids in pinned memory and
    queues the copy back: no synchronizing call under sync debug mode
    "error"; three requests fetched in another order, one twice, equal
    their sequential results bitwise, and the CPU's plain path within
    1e-4."""
    from tpurec_torch.config import Config, ModelConfig
    from tpurec_torch.serve import Predictor
    from tpurec_torch.train import Trainer

    dims, n_domain, domain_idx = (300, 7, 9, 4, 1000), 4, 3
    cfg = Config(model=ModelConfig(model="mmoe", embed_dim=8,
                                   mmoe_expert_dims=(16, 8),
                                   mmoe_tower_dims=(8,), atten_embed_dim=8,
                                   att_layer_num=2))
    tr = Trainer(cfg, dims, n_domain, domain_idx,
                 domain2group=np.arange(n_domain), device=cuda)

    def predictor(device):
        return Predictor(cfg, dims, n_domain, domain_idx,
                         domain2group=np.arange(n_domain),
                         batch_sizes=(16, 64), table_dtype="bfloat16",
                         device=device).load_from_trainer(tr).warm()

    pred = predictor(cuda)
    rng = np.random.default_rng(2)
    reqs = [np.stack([rng.integers(0, d, n) for d in dims], 1)
            for n in (150, 1, 70)]
    want = [pred(X) for X in reqs]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fetches = [pred.predict_async(X) for X in reqs]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    got = {k: fetches[k]() for k in (2, 0, 1)}
    for k, w in enumerate(want):
        np.testing.assert_array_equal(got[k], w)
    np.testing.assert_array_equal(fetches[0](), want[0])
    cpu = predictor("cpu")
    for X, w in zip(reqs, want):
        np.testing.assert_allclose(w, cpu(X), atol=1e-4, rtol=0)
