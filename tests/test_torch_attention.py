"""Port parity: gwkit_torch.ops.attention (plain path on the CPU) against
gwkit's reference_attention and its Pallas flash kernel in interpret mode.
Same numpy inputs; f32; tolerance rtol 2e-5, atol 2e-6 (f32 summation order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gwkit.ops.attention import flash_attention as gw_flash
from gwkit.ops.attention import reference_attention as gw_reference
from gwkit_torch.ops.attention import attention_from_qkv, flash_attention, reference_attention

TOL = dict(rtol=2e-5, atol=2e-6)


def _qkv(T, H, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(2, T, H, 64)) * 64 ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(2, T, H, 64)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("H", [2, 6])
@pytest.mark.parametrize("T", [50, 130, 256])
def test_attention_matches_gwkit(T, H):
    q, k, v = _qkv(T, H, seed=T + H)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v))).numpy()
    want_ref = np.asarray(gw_reference(*(jnp.asarray(a) for a in (q, k, v))))
    want_flash = np.asarray(gw_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    np.testing.assert_allclose(got, want_ref, **TOL)
    np.testing.assert_allclose(got, want_flash, **TOL)


def test_attention_from_fused_qkv_layout():
    """The block chain's entry reads q, k, v out of one (B, T, 3D) projection."""
    q, k, v = _qkv(130, 6, seed=1)
    B, T = q.shape[:2]
    qkv = np.concatenate([a.reshape(B, T, -1) for a in (q, k, v)], axis=-1)
    got = attention_from_qkv(torch.from_numpy(qkv), n_heads=6).numpy()
    want = np.asarray(gw_reference(*(jnp.asarray(a) for a in (q, k, v)))).reshape(B, T, -1)
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper takes the plain version, nothing else."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(50, 2, seed=2))
    np.testing.assert_array_equal(flash_attention(q, k, v).numpy(),
                                  reference_attention(q, k, v).numpy())
