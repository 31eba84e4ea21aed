"""Port parity: gwkit_torch.ops.qtransform (plan copied, Q-scan on
torch.fft) against gwkit's make_qplan and qscan, median_stride 1 and 8,
and gwkit's time_decimation fold (d in {1, 2, 4} under every norm; the
fold exact at the sampled points; the tap cache across d on one plan;
the Q-adapter and a tiny search with d = 4).

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


DECIMATION_PLAN = (1.0, 2048.0, (4.0, 128.0), (64, 64))  # d = 2 folds L >= 128, d = 4 L >= 256


@pytest.mark.parametrize("median_stride", [1, 8])
@pytest.mark.parametrize("norm", ["median", "mean", "none"])
@pytest.mark.parametrize("time_decimation", [1, 2, 4])
def test_qscan_time_decimation_matches_gwkit(time_decimation, norm, median_stride):
    x = _windows(4, seed=10 * time_decimation + median_stride)
    want = np.asarray(gq.qscan(jnp.asarray(x), gq.make_qplan(*DECIMATION_PLAN), norm=norm,
                               median_stride=median_stride, time_decimation=time_decimation))
    plan = pq.make_qplan(*DECIMATION_PLAN)
    xt = torch.from_numpy(x)
    got = pq.qscan(xt, plan, norm=norm, median_stride=median_stride, time_decimation=time_decimation).numpy()

    _, rowmax = pq._row_energies(xt, plan, norm, median_stride, time_decimation)
    peaks = np.sort(pq.plane_peaks(rowmax, plan).numpy(), axis=1)
    margin = float(((peaks[:, -1] - peaks[:, -2]) / peaks[:, -1]).min())
    assert margin > 1e-4, f"best-plane margin {margin:.2e} is within reach of f32 error"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.parametrize("d", [2, 4])
def test_qscan_time_decimation_exact(d):
    """The fold is exact: a bucket's folded energies, rescaled by 1/d^2,
    equal its full energies at every d-th sample (gwkit's
    test_qscan_time_decimation_exact, bucket by bucket)."""
    plan = pq.make_qplan(1.0, 2048.0, (4.0, 64.0), (64, 64))
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(2, 2048)).astype(np.float32))
    fseries = torch.fft.rfft(x, dim=-1)
    for bucket in plan.buckets:
        spec = fseries[:, torch.from_numpy(bucket.gather_idx.astype(np.int64))] * torch.from_numpy(
            bucket.gather_weight)
        full = pq._tile_energy(spec).numpy()
        dec = pq._tile_energy(spec, d, rescale=True).numpy()
        assert dec.shape[-1] == bucket.length // d
        np.testing.assert_allclose(dec, full[..., ::d], rtol=2e-4, atol=1e-8)


def test_qscan_mixed_decimation_on_one_plan_is_bit_identical():
    """d = 1, then d = 4, then d = 1 on one plan: the third call returns the
    first's bits, and the d = 4 call equals a d = 4 call on a fresh plan,
    so no call takes another's interpolation taps."""
    plan = pq.make_qplan(*DECIMATION_PLAN)
    x = torch.from_numpy(_windows(3, seed=5))
    first = pq.qscan(x, plan)
    dec = pq.qscan(x, plan, time_decimation=4)
    again = pq.qscan(x, plan)
    assert torch.equal(again, first)
    assert torch.equal(dec, pq.qscan(x, pq.make_qplan.__wrapped__(*DECIMATION_PLAN), time_decimation=4))
    assert not torch.equal(dec, first)


def test_qadapter_time_decimation_matches_gwkit():
    """qadapter_apply with QAdapterConfig(time_decimation=4) against gwkit's,
    gwkit's initial weights carried across by from_gwkit_numpy."""
    import jax

    from gwkit.models.qadapter import QAdapterConfig as GwQ
    from gwkit.models.qadapter import init_qadapter as gw_init
    from gwkit.models.qadapter import qadapter_apply as gw_apply
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.qadapter import QAdapterConfig, qadapter_apply

    geo = dict(spectrogram_shape=(64, 64), target_shape=(16, 32), channels=(4, 8, 8), median_stride=8,
               time_decimation=4)
    gw_params = gw_init(jax.random.PRNGKey(3), GwQ(**geo))
    params = from_gwkit_numpy(qadapter=jax.tree.map(np.asarray, gw_params))["qadapter"]
    x = _windows(6, seed=7).reshape(3, 2, 2048)
    want = np.asarray(gw_apply(GwQ(**geo), gw_params, jnp.asarray(x)))
    got = qadapter_apply(QAdapterConfig(**geo), params, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 2, 16, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def test_tiny_search_with_time_decimation_matches_gwkit():
    """A tiny-width search whose Q-adapter folds by 4: the same scores and
    the identical trigger list as gwkit's."""
    import jax

    from gwkit.models.adapters import AdapterConfig
    from gwkit.models.qadapter import QAdapterConfig as GwQ
    from gwkit.models.whisper import WhisperConfig as GwW
    from gwkit.search.engine import score_segments as gw_score_segments
    from gwkit.search.slicer import Segment as GwSegment, SlicerConfig as GwCfg
    from gwkit.train.tasks import build_mlgwsc as gw_build
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    geo = dict(spectrogram_shape=(64, 64), target_shape=(80, 128), channels=(4, 8, 8), median_stride=8,
               time_decimation=4)
    enc = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=64)
    gw_task = gw_build(jax.random.PRNGKey(1), encoder=GwW(**enc), qcfg=GwQ(**geo), usr=True,
                       acfg=AdapterConfig(r=2, alpha=4, use_dora=True, targets="kv"))
    tr = jax.tree.map(np.asarray, gw_task.trainable)
    params = from_gwkit_numpy(jax.tree.map(np.asarray, gw_task.frozen["encoder"]),
                              tr["adapters"], tr["head"], tr["qadapter"])
    port_task = build_mlgwsc(WhisperConfig(**enc), QAdapterConfig(**geo), params, device="cpu")
    gw_score = jax.jit(lambda w: gw_task.forward(gw_task.trainable, gw_task.frozen, w)[:, 0])

    rng = np.random.default_rng(4)
    strain = rng.normal(size=(2, 12 * 2048))
    t = np.arange(2048) / 2048
    strain[:, 5 * 2048:6 * 2048] += 6 * np.sin(2 * np.pi * (40 * t + 80 * t ** 2)) * np.exp(-((t - 0.5) / 0.15) ** 2)
    strain = (strain * 1e-21).astype(np.float32)

    def run_both(thr):
        want = gw_score_segments(gw_score, [GwSegment("seg", strain, 1000.0, 1 / 2048)], GwCfg(batch_size=64),
                                 trigger_threshold=thr)
        got = score_segments(port_task.score, [Segment("seg", strain, 1000.0, 1 / 2048)],
                             SlicerConfig(batch_size=64), trigger_threshold=thr, device=torch.device("cpu"))
        return got, want

    got, want = run_both(1e9)
    np.testing.assert_allclose(got.all_vals, want.all_vals, rtol=1e-4, atol=1e-6)
    err = float(np.abs(got.all_vals - want.all_vals).max())
    # a threshold in the widest gap near the 80% quantile, far wider than the packages' gap
    s = np.unique(want.all_vals.astype(np.float64))
    i = max(range(int(0.8 * len(s)) - 10, int(0.8 * len(s)) + 10), key=lambda j: s[j] - s[j - 1])
    assert s[i] - s[i - 1] > 20 * err
    got, want = run_both(float(0.5 * (s[i] + s[i - 1])))
    assert 0 < sum(len(v) for v in got.triggers.values()) < got.n_windows
    assert got.triggers.keys() == want.triggers.keys()
    for key in want.triggers:
        g, w = np.asarray(got.triggers[key]), np.asarray(want.triggers[key])
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4, atol=1e-6)
