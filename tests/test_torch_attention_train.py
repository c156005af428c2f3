"""The attention stack in training (tpurec_torch.ops.attention, plain
versions on the CPU): its gradient against jax.vjp of the JAX package's
field_attention_reference at rate 0, the dropout mask (kernel 2's
training mode), and kernel 3's plain backward against autograd.

Gradients agree to float32 rounding of sums in another order: rtol 1e-5
with atol 1e-6 for values near zero (inputs are O(1), weights O(0.2))."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpurec.ops.attention_pallas import \
    field_attention_reference as jax_attention
from tpurec_torch.ops.attention import (field_attention,
                                        field_attention_bwd,
                                        field_attention_reference,
                                        keep_mask, keep_threshold)

B, F, D, A, H, L = 6, 5, 4, 8, 2, 2


def _inputs(rng, res=True):
    mk = lambda *s: (rng.normal(size=s) * 0.3).astype(np.float32)  # noqa
    flat = [mk(D, A), mk(A), mk(D, A) if res else None,
            mk(A) if res else None]
    for _ in range(L):
        flat += [mk(A, 3 * A), mk(3 * A), mk(A, A), mk(A)]
    return rng.normal(size=(B, F, D)).astype(np.float32), flat


def _leaf(a):
    return None if a is None else torch.from_numpy(a).requires_grad_(True)


def test_gradient_matches_jax_vjp(rng):
    emb, flat = _inputs(rng)
    dy = rng.normal(size=(B, F, A)).astype(np.float32)
    y_j, vjp = jax.vjp(lambda e, w: jax_attention(e, w, L, H),
                       jnp.asarray(emb), [jnp.asarray(w) for w in flat])
    demb_j, dw_j = vjp(jnp.asarray(dy))
    te, tw = _leaf(emb), [_leaf(w) for w in flat]
    y = field_attention(te, tw, L, H, train=True, rate=0.0)
    y.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(demb_j),
                               rtol=1e-5, atol=1e-6)
    for i, (w, want) in enumerate(zip(tw, dw_j)):
        np.testing.assert_allclose(w.grad.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6, err_msg=f"w{i}")


def test_train_at_rate_zero_equals_eval(rng):
    emb, flat = _inputs(rng)
    te, tw = torch.from_numpy(emb), [torch.from_numpy(w) for w in flat]
    seed = torch.tensor(123)
    torch.testing.assert_close(
        field_attention(te, tw, L, H, train=True, rate=0.0, seed=seed),
        field_attention(te, tw, L, H), rtol=0, atol=0)
    # eval ignores the rate
    torch.testing.assert_close(
        field_attention(te, tw, L, H, train=False, rate=0.5, seed=seed),
        field_attention(te, tw, L, H), rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.2, 0.5])
def test_keep_mask_share_and_seed(rate):
    seed = torch.tensor(2024)
    keep = keep_mask(seed, 512, 1, 2, 23, rate)
    assert keep.shape == (512, 2, 23, 23) and keep.dtype == torch.bool
    drop_share = 1.0 - keep.float().mean().item()
    assert abs(drop_share - rate) < 0.01
    assert torch.equal(keep, keep_mask(seed, 512, 1, 2, 23, rate))
    for other in (keep_mask(torch.tensor(2025), 512, 1, 2, 23, rate),
                  keep_mask(seed, 512, 2, 2, 23, rate)):
        assert (other != keep).float().mean().item() > 0.2
    # the threshold rule of attention_pallas.py::_keep_mask
    assert keep_threshold(rate) == min(int((1 - rate) * 2**32), 2**32 - 1)
    assert keep_threshold(0.0) == 2**32 - 1


def test_keep_mask_is_the_source_hash():
    """Bits of the uint32 hash computed in Python integers (the CUDA
    source's arithmetic) against the int64 tensor version."""
    def mix(x):
        x ^= x >> 16
        x = (x * 0x7FEB352D) & 0xFFFFFFFF
        x ^= x >> 15
        x = (x * 0x846CA68B) & 0xFFFFFFFF
        return x ^ (x >> 16)

    seed, Bq, Fq, Hq, rate = 2**31 - 2, 3, 4, 2, 0.3
    thresh = keep_threshold(rate)
    want = torch.zeros(Bq, Hq, Fq, Fq, dtype=torch.bool)
    for b in range(Bq):
        key = mix(mix(seed ^ 0x9E3779B9) ^ b)
        for h in range(Hq):
            for f in range(Fq):
                for g in range(Fq):
                    ctr = ((1 * Hq + h) * Fq + f) * Fq + g
                    want[b, h, f, g] = mix(key ^ ctr) < thresh
    assert torch.equal(keep_mask(torch.tensor(seed), Bq, 1, Hq, Fq, rate),
                       want)


@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_plain_backward_regenerates_the_mask(rng, rate, res):
    """Kernel 3's plain version (layer internals recomputed from the saved
    inputs, the mask regenerated from the seed) equals autograd through
    the plain training forward with the same seed."""
    emb, flat = _inputs(rng, res)
    dy = torch.from_numpy(rng.normal(size=(B, F, A)).astype(np.float32))
    seed = torch.tensor(77)
    te, tw = _leaf(emb), [_leaf(w) for w in flat]
    saved = []
    y = field_attention_reference(te, tw, L, H, rate, seed, saved=saved)
    y.backward(dy)
    with torch.no_grad():
        demb, grads = field_attention_bwd(
            te.detach(), dy, torch.stack(saved), [
                None if w is None else w.detach() for w in tw], L, H, rate,
            seed)
    torch.testing.assert_close(demb, te.grad, rtol=1e-5, atol=1e-6)
    for i, (g, w) in enumerate(zip(grads, tw)):
        if w is None:
            assert g is None
        else:
            torch.testing.assert_close(g, w.grad, rtol=1e-5, atol=1e-6,
                                       msg=f"w{i}")
    if rate:
        # dropout changed the output, and a different seed changes it again
        y0 = field_attention_reference(te, tw, L, H)
        y2 = field_attention_reference(te, tw, L, H, rate, torch.tensor(78))
        assert not torch.allclose(y, y0) and not torch.allclose(y, y2)
