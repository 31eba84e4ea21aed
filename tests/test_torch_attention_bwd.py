"""Port parity for the attention backward (K5): gwkit_torch's plain version
of kernel D (``reference_attention_bwd``) against gwkit's Pallas backward
``_flash_bwd_impl`` in interpret mode, and gradients through the port's
``FlashAttention`` against ``jax.grad`` through gwkit's ``flash_attention``
(interpret mode), as tests/test_attention.py holds gwkit's. Same numpy
inputs; f32; rtol 1e-4, atol 1e-5 (f32 summation order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.ops.attention import _flash_bwd_impl
from gwkit.ops.attention import flash_attention as gw_flash
from gwkit_torch.ops import _cuda
from gwkit_torch.ops.attention import (FlashAttention, attention_bwd, flash_attention,
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
