"""Port parity for the attention backward (K5): gwkit_torch's plain version
of kernel D (``reference_attention_bwd``), recomputing or fed the forward's
saved row state (m, l, o), against gwkit's Pallas backward
``_flash_bwd_impl`` in interpret mode; the plain forward's saved state
against a numpy computation of K1's; and gradients through the port's
``FlashAttention`` against ``jax.grad`` through gwkit's ``flash_attention``
(interpret mode), as tests/test_attention.py holds gwkit's. Same numpy
inputs; f32 rtol 1e-4, atol 1e-5 (f32 summation order); bf16 2e-2 of each
output's largest value (rounding points)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.ops.attention import _flash_bwd_impl
from gwkit.ops.attention import flash_attention as gw_flash
from gwkit_torch.ops import _cuda
from gwkit_torch.ops.attention import (FlashAttention, attention_bwd, flash_attention, reference_attention,
                                       reference_attention_bwd)

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(T, H, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(2, T, H, 64)) * scale / 8).astype(np.float32)
    k, v, do = (rng.normal(size=(2, T, H, 64)).astype(np.float32) for _ in range(3))
    return q, k, v, do


@pytest.mark.parametrize("T", [70, 128])  # 70: padded to the 64-row block and masked
def test_plain_backward_matches_gwkit_pallas_backward(T):
    q, k, v, do = _inputs(T, 2, seed=T)
    want = _flash_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, do)), block_q=64, interpret=True)
    got = reference_attention_bwd(*(torch.from_numpy(a) for a in (q, k, v, do)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T", [70, 128, 256, 300])
def test_plain_backward_from_saved_state_matches_gwkit_pallas_backward(T):
    """The plain backward fed the plain forward's saved (m, l, o)."""
    q, k, v, do = _inputs(T, 2, seed=T + 1)
    want = _flash_bwd_impl(*(jnp.asarray(a) for a in (q, k, v, do)), block_q=64, interpret=True)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    _, state = reference_attention(tq, tk, tv, with_state=True)
    got = reference_attention_bwd(tq, tk, tv, tdo, state)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("T", [70, 128, 256, 300])
def test_bf16_plain_backward_from_saved_state_matches_gwkit(T):
    q, k, v, do = _inputs(T, 2, seed=T + 2)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    tq, tk, tv, tdo = (bf(a) for a in (q, k, v, do))
    _, state = reference_attention(tq, tk, tv, with_state=True)
    got = reference_attention_bwd(tq, tk, tv, tdo, state)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = _flash_bwd_impl(*(jb(a) for a in (q, k, v, do)), block_q=64, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_forward_state_is_k1s(dtype):
    """m = the exact row max of q k^T, l = sum exp(s - m) in f32, o = the f32
    product of p = round(exp(s - m) / l) with v: K1's values (numpy, f64
    products of the same rounded inputs), in (B*H, T) and (B, T, H, hd)."""
    q, k, v, _ = _inputs(70, 3, seed=11, scale=4.0)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out, state = reference_attention(tq, tk, tv, with_state=True)
    np.testing.assert_array_equal(out.float().numpy(), reference_attention(tq, tk, tv).float().numpy())
    qn, kn, vn = (t.float().numpy().astype(np.float64) for t in (tq, tk, tv))
    s = np.einsum("bqhd,bkhd->bhqk", qn, kn)
    m = s.max(axis=-1, keepdims=True)
    l = np.exp(s - m).sum(axis=-1, keepdims=True)
    p = torch.from_numpy((np.exp(s - m) / l).astype(np.float32)).to(dtype).float().numpy()
    o = np.einsum("bhqk,bkhd->bqhd", p.astype(np.float64), vn)
    B, H, T = s.shape[:3]
    assert state.m.shape == state.l.shape == (B * H, T) and state.o.shape == (B, T, H, 64)
    assert state.m.dtype == state.l.dtype == state.o.dtype == torch.float32
    np.testing.assert_allclose(state.m.numpy(), m.reshape(B * H, T), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(state.l.numpy(), l.reshape(B * H, T), rtol=1e-5)
    # p is rounded to dtype from an f32 p: a last-bit difference of s can
    # move an element of p by one ulp of dtype
    atol = 1e-5 if dtype == torch.float32 else 2e-2 * np.abs(o).max()
    np.testing.assert_allclose(state.o.numpy(), o, rtol=1e-4, atol=atol)


def test_saved_state_backward_equals_recompute_on_cpu():
    """FlashAttention saves the state where a gradient is wanted, and the
    backward from it equals the backward that recomputes it."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(40, 2, seed=4))
    _, state = reference_attention(q, k, v, with_state=True)
    for g, w in zip(reference_attention_bwd(q, k, v, do, state), reference_attention_bwd(q, k, v, do)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5, atol=1e-6)
    _cuda.reset_counts()
    with torch.no_grad():
        flash_attention(q, k, v)
    assert _cuda.PLAIN_CALLS == {"attention": 1}


@pytest.mark.parametrize("scale", [1e-3, 1.0, 60.0])
def test_flash_attention_gradients_match_jax_grad(scale):
    """Gradients of sum(flash_attention * W) for a fixed W, both packages."""
    q, k, v, w = _inputs(70, 2, seed=7, scale=scale)
    tq = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (flash_attention(*tq) * torch.from_numpy(w)).sum().backward()
    want = jax.grad(lambda a, b, c: jnp.sum(gw_flash(a, b, c, block_q=64, interpret=True) * w),
                    argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    for t, g in zip(tq, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-5 * max(scale, 1.0))


def test_flash_attention_gradients_match_autograd_of_plain_softmax():
    """The hand-derived backward equals autograd of the plain forward."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(50, 3, seed=3))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    (FlashAttention.apply(*a) * w).sum().backward()
    probs = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", b[0], b[1]), dim=-1)
    (torch.einsum("bhqk,bkhd->bqhd", probs, b[2]) * w).sum().backward()
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.grad.numpy(), y.grad.numpy(), **TOL)


def test_backward_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors the wrapper runs the plain version and launches nothing."""
    _cuda.reset_counts()
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(40, 2, seed=1))
    got = attention_bwd(q, k, v, do)
    want = reference_attention_bwd(q, k, v, do)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert _cuda.LAUNCHES["attention_bwd"] == 0 and _cuda.PLAIN_CALLS["attention_bwd"] == 2


def test_bf16_plain_backward_rounds_where_gwkit_does():
    """In bf16 the plain version rounds p, dS and the outputs as gwkit's
    kernel does; against gwkit's interpret-mode kernel on the same bf16
    inputs it agrees to a few bf16 ulps of each output's largest value."""
    q, k, v, do = _inputs(64, 2, seed=5)
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    got = reference_attention_bwd(*(bf(a) for a in (q, k, v, do)))
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = _flash_bwd_impl(*(jb(a) for a in (q, k, v, do)), block_q=64, interpret=True)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        w = np.asarray(w.astype(jnp.float32))
        assert np.abs(g.float().numpy() - w).max() <= 2e-2 * np.abs(w).max()
