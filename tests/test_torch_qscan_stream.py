"""Port parity: the streaming Q-scan (gwkit_torch.ops.qtransform's
make_stream_plan, stream_energies, stream_crops and qscan_stream), the
task's forward from Q spectrograms and the streaming search, against gwkit
on the CPU in f32.

gwkit computes the band iDFTs as f32 matmuls, the port with torch.fft: the
energies are held at atol 5e-5 of each bucket's maximum (gwkit's own bound
against np.fft, tests/test_qscan_stream.py). Spectrograms are held at rtol
1e-4 and atol 1e-4 x their maximum, with the best-plane margin guard of
tests/test_torch_qtransform.py (a near-tie between planes could swap a
whole spectrogram between the packages); the search as in
tests/test_torch_search.py (all_vals rtol 1e-4, atol 1e-6; the same
trigger times and clusters at a threshold in a gap of the scores); the
int8 forward from Q spectrograms as tests/test_torch_quant.py holds the
int8 layer (rtol 2e-5, atol 2e-6, and its rule for a flipped quantum)."""
import dataclasses
import functools
import os

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.ops import qtransform as gq
from gwkit_torch.ops import qtransform as pq

CAP = os.path.join(os.path.dirname(__file__), "..", "artifacts", "capstone_r5")
RUN = os.path.join(CAP, "run")
FS = 2048
SR = 512.0
QR = (4.0, 64.0)
SHAPE = (64, 64)


def _margin(rowmax, plan):
    """Smallest relative gap between the best and the second-best plane."""
    peaks = np.sort(pq.plane_peaks(rowmax.reshape(-1, rowmax.shape[-1]), plan).numpy(), axis=1)
    return float(((peaks[:, -1] - peaks[:, -2]) / peaks[:, -1]).min())


@pytest.mark.parametrize("args", [(1.0, SR, QR, SHAPE, 0.2, 8), (1.0, 2048.0, (4.0, 128.0), (32, 32), 0.2, 16)])
def test_make_stream_plan_equals_gwkit(args):
    a, b = gq.make_stream_plan(*args), pq.make_stream_plan(*args)
    assert (a.chunk_seconds, a.chunk_samples) == (b.chunk_seconds, b.chunk_samples)
    np.testing.assert_array_equal(a.base.row_inv, b.base.row_inv)
    assert len(a.buckets) == len(b.buckets)
    for sa, sb in zip(a.buckets, b.buckets):
        for field in dataclasses.fields(sa):
            x, y = getattr(sa, field.name), getattr(sb, field.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, field.name
                np.testing.assert_array_equal(x, y, err_msg=field.name)
            else:
                assert x == y, field.name
        np.testing.assert_array_equal(sa.gather_idx, sb.gather_idx)
        np.testing.assert_array_equal(sa.gather_weight, sb.gather_weight)


@pytest.mark.parametrize("chunk_seconds", [1, 0])
def test_make_stream_plan_rejects_bad_chunk_as_gwkit(chunk_seconds):
    for mod in (gq, pq):
        with pytest.raises(ValueError, match="chunk_seconds"):
            mod.make_stream_plan(1.0, SR, QR, SHAPE, 0.2, chunk_seconds)


def _chunk(seed, seconds=8, sr=SR, chirp_at=(3.2,)):
    """(2, seconds * sr) whitened-like noise with loud chirps in detector 0
    and a quieter one in detector 1 (well-defined best planes)."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    x = rng.normal(size=(2, n)).astype(np.float32)
    t = np.arange(n) / sr
    for t0 in chirp_at:
        f = 20 + 60 * (t - t0).clip(0)
        burst = np.sin(2 * np.pi * np.cumsum(f) / sr) * np.exp(-0.5 * ((t - (t0 + 0.3)) / 0.1) ** 2)
        x[0] += (10 * burst).astype(np.float32)
        x[1] += (5 * burst).astype(np.float32)
    return x


def test_stream_energies_match_gwkit_and_fft():
    chunk = _chunk(5, chirp_at=(1.0, 5.5))
    args = (1.0, SR, QR, SHAPE, 0.2, 8)
    want = gq.stream_energies(jnp.asarray(chunk), gq.make_stream_plan(*args))
    splan = pq.make_stream_plan(*args)
    got = pq.stream_energies(torch.from_numpy(chunk), splan)
    fseries = np.fft.rfft(chunk.astype(np.float64), axis=-1)
    for sb, g, w in zip(splan.buckets, got, want):
        ref = np.abs(np.fft.ifft(fseries[:, sb.gather_idx] * sb.gather_weight, axis=-1)) ** 2
        assert g.dtype == torch.float32 and g.shape == (2, len(sb.rows), sb.length)
        scale = float(ref.max())
        np.testing.assert_allclose(g.numpy() / scale, np.asarray(w) / scale, rtol=0, atol=5e-5)
        np.testing.assert_allclose(g.numpy() / scale, ref / scale, rtol=0, atol=5e-5)


# window starts (s from the chunk's start): integer, fractional and, at 7.0
# and 6.995 in the 8 s chunk, clamped (i0 = L_b - (L_w + 3), frac > 1 and
# the third tap in use)
STARTS = {"integer": [3.0, 0.0, 5.0], "fractional": [3.1, 0.37, 4.9501], "clamped": [7.0, 6.995, 6.5]}


@pytest.mark.parametrize("norm,median_stride", [("median", 1), ("median", 8), ("mean", 1), ("none", 1)])
@pytest.mark.parametrize("starts", sorted(STARTS))
def test_qscan_stream_matches_gwkit(starts, norm, median_stride):
    chunk = _chunk(1, chirp_at=(0.2, 3.2, 6.6))
    st = np.asarray(STARTS[starts], np.float32)
    args = (1.0, SR, QR, SHAPE, 0.2, 8)
    want = np.asarray(gq.qscan_stream(jnp.asarray(chunk), jnp.asarray(st), gq.make_stream_plan(*args), norm=norm,
                                      median_stride=median_stride))
    splan = pq.make_stream_plan(*args)
    ct, stt = torch.from_numpy(chunk), torch.from_numpy(st)
    got = pq.qscan_stream(ct, stt, splan, norm=norm, median_stride=median_stride).numpy()
    assert got.shape == want.shape == (3, 2, *SHAPE)
    if starts == "clamped":  # the clamp is reached in every bucket, and frac > 1 there
        for sb in splan.buckets:
            assert int(np.floor(st[0] * sb.window_length)) > sb.length - (sb.window_length + 3)
    _, rowmax = pq._stream_rows(pq.stream_energies(ct, splan), stt, splan, norm, median_stride)
    margin = _margin(rowmax, splan.base)
    assert margin > 1e-4, f"best-plane margin {margin:.2e} is within reach of f32 error"
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, FS)).astype(np.float32)
    t = np.arange(FS) / FS
    x[::2] += (8 * np.sin(2 * np.pi * (30 * t + 60 * t ** 2)) * np.exp(-((t - 0.6) / 0.1) ** 2)).astype(np.float32)
    return x


def _tiny_gwkit_task(quant_int8=False, geo=None):
    """A tiny gwkit mlgwsc task (non-zero DoRA B) and the port's on the CPU
    with the same weights."""
    from gwkit.models.adapters import AdapterConfig
    from gwkit.models.qadapter import QAdapterConfig as GwQ
    from gwkit.models.whisper import WhisperConfig as GwW
    from gwkit.train.tasks import build_mlgwsc as gw_build
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    geo = geo or dict(spectrogram_shape=(32, 32), target_shape=(80, 128), channels=(4, 8, 8), median_stride=8)
    enc = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=64)
    gw_task = gw_build(jax.random.PRNGKey(0), encoder=GwW(**enc, fused_block=quant_int8, quant_int8=quant_int8),
                       qcfg=GwQ(**geo), usr=True,
                       acfg=AdapterConfig(r=2, alpha=4, use_dora=True, targets="kv"))
    gw_task.trainable["adapters"] = jax.tree.map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07,
        gw_task.trainable["adapters"])
    tr = jax.tree.map(np.asarray, gw_task.trainable)
    params = from_gwkit_numpy(jax.tree.map(np.asarray, gw_task.frozen["encoder"]),
                              tr["adapters"], tr["head"], tr["qadapter"])
    port_enc = WhisperConfig(**enc, fused_block=quant_int8, quant_int8=quant_int8)
    return gw_task, build_mlgwsc(port_enc, QAdapterConfig(**geo), params, device="cpu")


def _near_tie_windows(inputs, n_windows, within=3e-5):
    """Windows whose int8 quantization inputs (rows of every window's
    detectors and frames, window-major) hold a value within ``within``
    quanta of a rounding tie: where the packages' last-bit differences may
    round a whole row to the other quantum (tests/test_torch_quant.py)."""
    windows = set()
    for h in inputs:
        sx = torch.clamp_min(h.abs().amax(dim=-1, keepdim=True), 1e-6) / 127.0
        v = (h / sx).abs()
        rows = np.flatnonzero((((v - v.floor()) - 0.5).abs() < within).any(-1).numpy())
        windows |= set((rows // (h.shape[0] // n_windows)).tolist())
    return windows


@pytest.mark.parametrize("quant_int8", [False, True])
def test_forward_from_qspec_equals_forward(quant_int8, monkeypatch):
    """The task's forward from Q spectrograms equals its forward from strain
    on the strain's own spectrograms, through the same prepared encoder (int8:
    kernel E's plain version); and gwkit's forward_from_qspec on them (int8:
    gwkit's quantized fused block in interpret mode). Measured int8 max
    |delta| 1.1e-8 on scores up to 0.044, no flipped quantum."""
    from gwkit_torch.ops import _cuda
    from gwkit_torch.ops import fused_block as fb
    from gwkit_torch.ops.fused_mlp import _ln

    gw_task, task = _tiny_gwkit_task(quant_int8)
    x = _windows(6, seed=4).reshape(3, 2, FS)
    xt = torch.from_numpy(x)
    plan = pq.make_qplan(1.0, 2048.0, (4.0, 128.0), (32, 32))
    qspec = pq.qscan(xt.reshape(6, FS), plan, median_stride=8).reshape(3, 2, 32, 32)
    want = task.forward(xt)
    encoder = task._encoder
    quant_inputs, real_int8_gemm = [], fb.int8_gemm

    def recording(x2, proj, ln=None, **kw):  # every int8 projection's quantization input
        quant_inputs.append((_ln(x2, *ln) if ln is not None else x2).detach().clone())
        return real_int8_gemm(x2, proj, ln=ln, **kw)

    monkeypatch.setattr(fb, "int8_gemm", recording)
    _cuda.reset_counts()
    got = task.forward_from_qspec(qspec)
    assert task._encoder is encoder  # the same prepared encoder
    assert _cuda.PLAIN_CALLS.get("int8_gemm", 0) == len(quant_inputs) == (4 if quant_int8 else 0)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(task.score_spec(qspec).numpy(), got[:, 0].numpy())
    gw = np.asarray(gw_task.forward_from_qspec(gw_task.trainable, gw_task.frozen, jnp.asarray(qspec.numpy())))
    got = got.numpy()
    if not quant_int8:
        np.testing.assert_allclose(got, gw, rtol=1e-4, atol=1e-4 * float(np.abs(gw).max()))
        return
    tol = dict(rtol=2e-5, atol=2e-6)
    flipped = np.flatnonzero((~np.isclose(got, gw, **tol)).any(-1))
    assert set(flipped.tolist()) <= _near_tie_windows(quant_inputs, len(got)), \
        f"windows {flipped.tolist()} differ with no value at a tie"
    assert len(flipped) <= 1
    assert np.abs(got[flipped] - gw[flipped]).max(initial=0) <= 1e-2 * np.abs(gw).max()
    np.testing.assert_allclose(np.delete(got, flipped, 0), np.delete(gw, flipped, 0), **tol)


def test_trained_adapters_reach_both_forwards():
    """Scored, then trained (adapters updated in place), then scored: both
    forwards serve the trained adapters."""
    from gwkit_torch.io import tree_leaves

    _, task = _tiny_gwkit_task()
    x = torch.from_numpy(_windows(4, seed=5).reshape(2, 2, FS))
    plan = pq.make_qplan(1.0, 2048.0, (4.0, 128.0), (32, 32))
    qspec = pq.qscan(x.reshape(4, FS), plan, median_stride=8).reshape(2, 2, 32, 32)
    before = task.score_spec(qspec)
    with torch.no_grad():
        for t in tree_leaves(task.trainable["adapters"]):
            t.add_(0.05)
    after_spec, after = task.score_spec(qspec), task.score(x)
    assert (after_spec - before).abs().max() > 1e-4
    np.testing.assert_allclose(after_spec.numpy(), after.numpy(), rtol=1e-5, atol=1e-6)


def _segment_strain(seconds, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, int(seconds * FS)))
    t = np.arange(FS) / FS
    chirp = np.sin(2 * np.pi * (40 * t + 80 * t ** 2)) * np.exp(-((t - 0.5) / 0.15) ** 2)
    for start in (5 * FS, 13 * FS):
        x[:, start:start + FS] += 6 * chirp
    return (x * 1e-21).astype(np.float32)


def _threshold_in_a_gap(vals, err, q=0.8):
    s = np.unique(np.asarray(vals, np.float64))
    i0 = int(q * len(s))
    i = max(range(max(1, i0 - 10), min(len(s), i0 + 10)), key=lambda j: s[j] - s[j - 1])
    assert s[i] - s[i - 1] > 20 * err, f"no clean gap: {s[i] - s[i - 1]:.2e} vs error {err:.2e}"
    return float(0.5 * (s[i] + s[i - 1]))


def test_tiny_streaming_search_same_scores_triggers_and_clusters():
    from gwkit.search.cluster import get_clusters as gw_clusters
    from gwkit.search.engine import score_segments as gw_score_segments
    from gwkit.search.slicer import Segment as GwSegment, SlicerConfig as GwCfg
    from gwkit_torch.search.cluster import get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import Segment, SlicerConfig

    gw_task, task = _tiny_gwkit_task()
    gw_score = jax.jit(lambda w: gw_task.forward(gw_task.trainable, gw_task.frozen, w)[:, 0])
    gw_spec = jax.jit(lambda q: gw_task.forward_from_qspec(gw_task.trainable, gw_task.frozen, q)[:, 0])
    strain = _segment_strain(20, seed=3)
    kw = dict(batch_size=64, max_block=8 * FS)  # blocked: three 8 s blocks, 8 s stream chunks
    stream = dict(stream_plan_args=(1.0, 2048.0, (4.0, 128.0), (32, 32), 0.2), stream_norm="median",
                  stream_median_stride=8)
    n_spec = [0]

    def score_spec(q):
        n_spec[0] += 1
        return task.score_spec(q)

    def run_both(thr):
        want = gw_score_segments(gw_score, [GwSegment("seg", strain, 1000.0, 1 / FS)], GwCfg(**kw),
                                 trigger_threshold=thr, stream_score_fn=gw_spec, **stream)
        got = score_segments(task.score, [Segment("seg", strain, 1000.0, 1 / FS)], SlicerConfig(**kw),
                             trigger_threshold=thr, device=torch.device("cpu"), stream_score_fn=score_spec,
                             **stream)
        return got, want

    got, want = run_both(1e9)
    assert got.n_windows == want.n_windows == 189 and n_spec[0] == 5  # 68 + 68 + 53 windows, batches of 64
    np.testing.assert_allclose(got.all_vals, want.all_vals, rtol=1e-4, atol=1e-6)
    err = float(np.abs(got.all_vals - want.all_vals).max())
    got, want = run_both(_threshold_in_a_gap(want.all_vals, err))
    assert 0 < sum(len(v) for v in got.triggers.values()) < got.n_windows
    assert got.triggers.keys() == want.triggers.keys()
    for key in want.triggers:
        g, w = np.asarray(got.triggers[key]), np.asarray(want.triggers[key])
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4, atol=1e-6)
    for a, b in zip(get_clusters(got.triggers), gw_clusters(want.triggers)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
    # a short (unblocked) segment keeps the per-window path, as in gwkit
    short = score_segments(task.score, [Segment("s", strain[:, :6 * FS], 0.0, 1 / FS)], SlicerConfig(**kw),
                           trigger_threshold=1e9, device=torch.device("cpu"), stream_score_fn=None, **stream)
    n_spec[0] = 0
    short_s = score_segments(task.score, [Segment("s", strain[:, :6 * FS], 0.0, 1 / FS)], SlicerConfig(**kw),
                             trigger_threshold=1e9, device=torch.device("cpu"), stream_score_fn=score_spec,
                             **stream)
    assert n_spec[0] == 0
    np.testing.assert_array_equal(short.all_vals, short_s.all_vals)


def test_get_triggers_requires_qspec_surface():
    """qscan_stream on a task without a Q-scan front end is gwkit's ValueError."""
    from gwkit_torch.search.engine import get_triggers

    class NoQspec:
        device = torch.device("cpu")
        qcfg = None
        score = staticmethod(lambda w: w.sum(dim=(1, 2)))

    with pytest.raises(ValueError, match="qscan_stream"):
        get_triggers(NoQspec(), "/nonexistent.hdf", qscan_stream=True)


def test_qscan_stream_cli_on_hdf5_file_matches_gwkit_cli(tmp_path, monkeypatch):
    """``--qscan-stream --cpu`` on a 20 s file with the whitening block cut to
    8 s (so the streaming path runs) against gwkit's CLI, the capstone
    components at (80, 128)."""
    from gwkit.cli.inference import main as gw_main
    from gwkit.search import engine as gw_engine
    from gwkit_torch.cli.inference import main as port_main
    from gwkit_torch.search import engine as pt_engine

    monkeypatch.setattr(gw_engine, "SlicerConfig", functools.partial(gw_engine.SlicerConfig, max_block=8 * FS))
    monkeypatch.setattr(pt_engine, "SlicerConfig", functools.partial(pt_engine.SlicerConfig, max_block=8 * FS))
    path = str(tmp_path / "in.hdf")
    strain = _segment_strain(20, seed=5)
    with h5py.File(path, "w") as f:
        for i, det in enumerate(("H1", "L1")):
            ds = f.create_group(det).create_dataset("1238205000", data=strain[i].astype(np.float64))
            ds.attrs["start_time"] = 1238205000.0
            ds.attrs["delta_t"] = 1.0 / FS
    common = [path, "--lora-weights", os.path.join(RUN, "best_lora_weights"),
              "--dense-weights", os.path.join(RUN, "best_dense_layers.npz"),
              "--adapter-weights", os.path.join(RUN, "best_adapter.npz"),
              "--pretrained-encoder", os.path.join(CAP, "encoder_pretrained.npz"),
              "--target-shape", "80", "128", "--batch-size", "64", "--qscan-stream", "-t", "-1.5"]
    gw_main([common[0], str(tmp_path / "gw.hdf"), *common[1:], "--stream", "0"])
    port_main([common[0], str(tmp_path / "pt.hdf"), *common[1:], "--cpu"])
    with h5py.File(tmp_path / "gw.hdf") as a, h5py.File(tmp_path / "pt.hdf") as b:
        want = {k: a[k][()] for k in a}
        got = {k: b[k][()] for k in b}
    assert len(got["all_vals"]) == 189
    np.testing.assert_allclose(got["all_vals"], want["all_vals"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(want["all_vals"]).max()))
    err = float(np.abs(got["all_vals"] - want["all_vals"]).max())
    assert not (np.abs(want["all_vals"] + 1.5) <= 10 * err).any(), "a score sits at the threshold"
    assert 0 < len(want["time"])
    np.testing.assert_array_equal(got["time"], want["time"])
    np.testing.assert_allclose(got["stat"], want["stat"], rtol=1e-4)
