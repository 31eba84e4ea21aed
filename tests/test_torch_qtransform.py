"""Port parity: gwkit_torch.ops.qtransform (plan copied, Q-scan on
torch.fft) against gwkit's make_qplan and qscan, median_stride 1 and 8.

The scan keeps, per sample, the plane with the largest peak normalized
energy; a near-tie could flip between frameworks and swap a whole
spectrogram. The test reports the smallest relative margin between the best
and second-best plane and requires it to exceed the f32 error by far, so a
flip cannot hide behind a loose tolerance. f32; rtol 1e-4, atol 1e-4 x the
spectrogram's scale (median-normalized energies of order 1-100)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gwkit.ops import qtransform as gq
from gwkit_torch.ops import qtransform as pq


def test_make_qplan_tables_equal_gwkit():
    for args in [(1.0, 2048.0, (4.0, 128.0), (128, 128)), (1.0, 2048.0, (4.0, 128.0), (32, 32))]:
        a, b = gq.make_qplan(*args), pq.make_qplan(*args)
        assert a.qs == b.qs and a.n_rows == b.n_rows and a.n_common == b.n_common
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.row_inv, b.row_inv)
        np.testing.assert_array_equal(a.row_f, b.row_f)
        np.testing.assert_array_equal(a.row_q, b.row_q)
        for fa, fb in zip(a.freq_interp, b.freq_interp):
            np.testing.assert_array_equal(fa, fb)
        assert len(a.buckets) == len(b.buckets)
        for ba, bb in zip(a.buckets, b.buckets):
            assert ba.length == bb.length
            np.testing.assert_array_equal(ba.rows, bb.rows)
            np.testing.assert_array_equal(ba.gather_idx, bb.gather_idx)
            np.testing.assert_array_equal(ba.gather_weight, bb.gather_weight)


def test_median_matches_jnp_median_on_even_and_odd_lengths():
    x = np.random.default_rng(0).normal(size=(3, 4, 64)).astype(np.float32)
    for n in (64, 63):
        got = pq.median(torch.from_numpy(x[..., :n]), dim=-1).numpy()
        np.testing.assert_array_equal(got, np.asarray(jnp.median(jnp.asarray(x[..., :n]), axis=-1)))


def _windows(n, seed):
    """Whitened-like noise windows, some with a loud chirp (forces a
    well-defined best plane)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 2048)).astype(np.float32)
    t = np.arange(2048) / 2048.0
    chirp = np.sin(2 * np.pi * (30 * t + 60 * t ** 2)) * np.exp(-((t - 0.6) / 0.1) ** 2)
    x[::2] += (8 * chirp).astype(np.float32)
    return x


@pytest.mark.parametrize("median_stride", [1, 8])
def test_qscan_matches_gwkit(median_stride):
    plan_args = (1.0, 2048.0, (4.0, 128.0), (128, 128))
    x = _windows(6, seed=median_stride)
    want = np.asarray(gq.qscan(jnp.asarray(x), gq.make_qplan(*plan_args),
                               median_stride=median_stride))
    plan = pq.make_qplan(*plan_args)
    xt = torch.from_numpy(x)
    got = pq.qscan(xt, plan, median_stride=median_stride).numpy()

    _, rowmax = pq._row_energies(xt, plan, "median", median_stride)
    peaks = np.sort(pq.plane_peaks(rowmax, plan).numpy(), axis=1)
    margin = float(((peaks[:, -1] - peaks[:, -2]) / peaks[:, -1]).min())
    assert margin > 1e-4, f"best-plane margin {margin:.2e} is within reach of f32 error"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))
