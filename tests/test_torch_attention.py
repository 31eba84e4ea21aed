"""Port parity: gwkit_torch.ops.attention (plain path on the CPU) against
gwkit's reference_attention and its Pallas flash kernel in interpret mode.
Same numpy inputs; f32; tolerance rtol 2e-5, atol 2e-6 (f32 summation order).

The T values hold the places where kernel A branches or masks on the card:
a ragged last 64-key tile (63, 65, 255, 257, 300), whole tiles (64, 256),
one pass over the scores up to T = 256 and two passes above it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gwkit.ops.attention import flash_attention as gw_flash
from gwkit.ops.attention import reference_attention as gw_reference
from gwkit_torch.ops import _cuda
from gwkit_torch.ops import attention as torch_attention
from gwkit_torch.ops.attention import attention_from_qkv, flash_attention, reference_attention
from gwkit_torch.utils.tracing import COUNTERS

TOL = dict(rtol=2e-5, atol=2e-6)
EDGE_T = [63, 64, 65, 255, 256, 257, 300]


def _qkv(T, H, seed):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(2, T, H, 64)) * 64 ** -0.5).astype(np.float32)
    k, v = (rng.normal(size=(2, T, H, 64)).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("H", [2, 6])
@pytest.mark.parametrize("T", sorted({50, 130, *EDGE_T}))
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


@pytest.mark.parametrize("T", EDGE_T)
def test_attention_entries_on_fused_qkv_match_gwkit(T):
    """Both entries on views of one (B, T, 3D) projection: attention_from_qkv
    (K3's contract on the card) and flash_attention on the in-place q, k, v
    views (K1's), against gwkit's reference and its Pallas K1."""
    q, k, v = _qkv(T, 6, seed=T)
    B = q.shape[0]
    qkv = torch.from_numpy(np.concatenate([a.reshape(B, T, -1) for a in (q, k, v)], axis=-1))
    views = [qkv[..., i * 384:(i + 1) * 384].view(B, T, 6, 64) for i in range(3)]
    want_ref = np.asarray(gw_reference(*(jnp.asarray(a) for a in (q, k, v))))
    want_flash = np.asarray(gw_flash(*(jnp.asarray(a) for a in (q, k, v)), interpret=True))
    for got in (attention_from_qkv(qkv, n_heads=6).numpy().reshape(B, T, 6, 64),
                flash_attention(*views).numpy()):
        np.testing.assert_allclose(got, want_ref, **TOL)
        np.testing.assert_allclose(got, want_flash, **TOL)


def test_attention_wrapper_takes_plain_version_on_cpu():
    """On a CPU tensor the wrapper takes the plain version, nothing else."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(50, 2, seed=2))
    np.testing.assert_array_equal(flash_attention(q, k, v).numpy(),
                                  reference_attention(q, k, v).numpy())


def test_two_pass_launch_counter(monkeypatch):
    """Each launch of kernel A past its one-pass limit adds one to
    ``COUNTERS["attention_two_pass_launches"]`` beside ``LAUNCHES["attention"]``;
    a launch at T = 256 counts only in the latter (a stand-in library that
    accepts the call, as the card's does)."""
    calls = []

    class Lib:
        def gw_attention(self, *args):
            calls.append(args)
            return 0

    assert torch_attention.ONE_PASS_MAX_T == 256
    monkeypatch.setitem(COUNTERS, "attention_two_pass_launches", 5)
    _cuda.reset_counts()
    counted = []
    for T, k1 in ((257, False), (1500, True), (256, False)):
        q = torch.zeros(1, T, 2, 64).bfloat16()
        torch_attention._launch(Lib(), 0, q, q, q, torch.empty_like(q), 1, T, 2, 128, 128, k1=k1)
        counted.append((COUNTERS["attention_two_pass_launches"], _cuda.LAUNCHES["attention"]))
    assert counted == [(6, 1), (7, 2), (7, 3)]
    assert [c[8] for c in calls] == [257, 1500, 256] and [c[14] for c in calls] == [0, 1, 0]
