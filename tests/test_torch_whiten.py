"""Port parity: gwkit_torch.ops.whiten.whiten_estimate (and its Welch PSD
and PSD interpolation) against gwkit's on 1e-21-scale strain, where the f32
rescaling steps are what keep every intermediate representable.
Whitened output is O(sqrt(fs)); f32 FFT order noise gives ~1e-5 relative:
rtol 1e-4, atol 1e-4 x the output's scale."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gwkit.ops.psd import interpolate_psd as gw_interp
from gwkit.ops.psd import welch_psd as gw_welch
from gwkit.ops.whiten import whiten_estimate as gw_whiten
from gwkit_torch.ops.psd import interpolate_psd, median_bias, welch_psd
from gwkit_torch.ops.whiten import whiten_estimate


def _strain(n, seed=0):
    rng = np.random.default_rng(seed)
    white = rng.normal(size=(2, n))
    colored = np.cumsum(white, axis=-1) * 0.05 + white  # red tilt, like a real PSD
    return (colored * 1e-21).astype(np.float32)


@pytest.mark.parametrize("n", [16 * 2048, 16 * 2048 + 1000])
def test_whiten_estimate_matches_gwkit(n):
    x = _strain(n, seed=n % 7)
    want = np.asarray(gw_whiten(jnp.asarray(x), low_frequency_cutoff=20.0))
    got = whiten_estimate(torch.from_numpy(x), low_frequency_cutoff=20.0).numpy()
    assert got.shape == want.shape == (2, n - 512)
    assert np.isfinite(got).all() and float(np.abs(got).max()) > 1.0  # not flushed to zero
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).std()))


def test_welch_and_interpolation_match_gwkit():
    x = np.random.default_rng(1).normal(size=(2, 8 * 2048)).astype(np.float32)
    want = np.asarray(gw_welch(jnp.asarray(x), 1 / 2048.0))
    got = welch_psd(torch.from_numpy(x), 1 / 2048.0).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=0)
    wi = np.asarray(gw_interp(jnp.asarray(want), 2.0, 1 / 8.0, 8 * 1024 + 1))
    gi = interpolate_psd(torch.from_numpy(want.copy()), 2.0, 1 / 8.0, 8 * 1024 + 1).numpy()
    np.testing.assert_allclose(gi, wi, rtol=1e-6, atol=0)
    assert median_bias(1023) == pytest.approx(np.log(2.0))
