"""Port parity for the slice as a whole: whitening -> windows -> Q-scan ->
Q-adapter -> encoder (+DoRA) -> head -> triggers -> clusters.

(a) a tiny random gwkit model bridged with from_gwkit_numpy, on an in-memory
    20 s segment, unblocked and forced through the blocked path: the same
    all_vals (rtol 1e-4, atol 1e-6, as tests/test_golden_e2e.py) and an
    identical trigger list and clusters;
(b) the capstone weights at full width, (80, 512), f32, on a handful of
    windows, against gwkit's load_task_from_components;
(c) a 64 s HDF5 file through both CLIs' main (slow).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

CAP = os.path.join(os.path.dirname(__file__), "..", "artifacts", "capstone_r5")
RUN = os.path.join(CAP, "run")
FS = 2048


def _segment_strain(seconds, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, int(seconds * FS)))
    t = np.arange(FS) / FS
    chirp = np.sin(2 * np.pi * (40 * t + 80 * t ** 2)) * np.exp(-((t - 0.5) / 0.15) ** 2)
    for start in (5 * FS, 13 * FS):  # two loud-ish events, both detectors
        x[:, start:start + FS] += 6 * chirp
    return (x * 1e-21).astype(np.float32)


def _threshold_in_a_gap(vals, err, q=0.8):
    """A trigger threshold near the q-quantile that sits in a gap between
    scores more than 20 times wider than the two packages' largest score
    difference ``err``, so no score can fall on different sides of it."""
    s = np.unique(np.asarray(vals, np.float64))
    i0 = int(q * len(s))
    cand = range(max(1, i0 - 10), min(len(s), i0 + 10))
    i = max(cand, key=lambda j: s[j] - s[j - 1])
    assert s[i] - s[i - 1] > 20 * err, f"no clean gap: {s[i] - s[i - 1]:.2e} vs error {err:.2e}"
    return float(0.5 * (s[i] + s[i - 1]))


@pytest.fixture(scope="module")
def tiny():
    from gwkit.models.adapters import AdapterConfig
    from gwkit.models.qadapter import QAdapterConfig as GwQ
    from gwkit.models.whisper import WhisperConfig as GwW
    from gwkit.train.tasks import build_mlgwsc as gw_build
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    geo = dict(spectrogram_shape=(32, 32), target_shape=(80, 128), channels=(4, 8, 8), median_stride=8)
    enc = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=64)
    gw_task = gw_build(jax.random.PRNGKey(0), encoder=GwW(**enc), qcfg=GwQ(**geo), usr=True,
                       acfg=AdapterConfig(r=2, alpha=4, use_dora=True, targets="kv"))
    gw_task.trainable["adapters"] = jax.tree.map(  # non-zero B: the low-rank path counts
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07,
        gw_task.trainable["adapters"])
    tr = jax.tree.map(np.asarray, gw_task.trainable)
    params = from_gwkit_numpy(jax.tree.map(np.asarray, gw_task.frozen["encoder"]),
                              tr["adapters"], tr["head"], tr["qadapter"])
    port_task = build_mlgwsc(WhisperConfig(**enc), QAdapterConfig(**geo), params, device="cpu")
    gw_score = jax.jit(lambda w: gw_task.forward(gw_task.trainable, gw_task.frozen, w)[:, 0])
    return gw_score, port_task


@pytest.mark.parametrize("max_block", [None, 8 * FS])
def test_tiny_search_same_scores_triggers_and_clusters(tiny, max_block):
    from gwkit.search.cluster import get_clusters as gw_clusters
    from gwkit.search.engine import score_segments as gw_score_segments
    from gwkit.search.slicer import Segment as GwSegment, SlicerConfig as GwCfg
    from gwkit_torch.search.cluster import get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import Segment, SlicerConfig

    gw_score, port_task = tiny
    strain = _segment_strain(20, seed=3)
    kw = dict(batch_size=64, **({"max_block": max_block} if max_block else {}))

    def run_both(thr):
        want = gw_score_segments(gw_score, [GwSegment("seg", strain, 1000.0, 1 / FS)],
                                 GwCfg(**kw), trigger_threshold=thr)
        got = score_segments(port_task.score, [Segment("seg", strain, 1000.0, 1 / FS)],
                             SlicerConfig(**kw), trigger_threshold=thr, device=torch.device("cpu"))
        return got, want

    got, want = run_both(1e9)
    assert got.n_windows == want.n_windows == 189
    np.testing.assert_allclose(got.all_vals, want.all_vals, rtol=1e-4, atol=1e-6)
    err = float(np.abs(got.all_vals - want.all_vals).max())
    got, want = run_both(_threshold_in_a_gap(want.all_vals, err))
    assert 0 < sum(len(v) for v in got.triggers.values()) < got.n_windows
    # the identical trigger list: same segments, same windows (times exact),
    # scores as all_vals
    assert got.triggers.keys() == want.triggers.keys()
    for key in want.triggers:
        g, w = np.asarray(got.triggers[key]), np.asarray(want.triggers[key])
        np.testing.assert_array_equal(g[:, 0], w[:, 0])
        np.testing.assert_allclose(g[:, 1], w[:, 1], rtol=1e-4, atol=1e-6)
    for a, b in zip(get_clusters(got.triggers), gw_clusters(want.triggers)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=0)
        assert a.shape == b.shape


def _capstone_windows(n=3):
    rng = np.random.default_rng(11)
    w = rng.normal(size=(n, 2, FS)) * 45.0  # whitened noise is O(sqrt(fs))
    t = np.arange(FS) / FS
    w[0] += 400 * np.sin(2 * np.pi * (35 * t + 70 * t ** 2)) * np.exp(-((t - 0.6) / 0.1) ** 2)
    return w.astype(np.float32)


def test_capstone_full_width_scores_match_gwkit():
    """The trained capstone components at the (80, 512) serving geometry, f32."""
    from gwkit.cli.inference import load_task_from_components as gw_load
    from gwkit_torch.cli.inference import load_task_from_components

    files = (os.path.join(RUN, "best_lora_weights"), os.path.join(RUN, "best_dense_layers.npz"),
             os.path.join(RUN, "best_adapter.npz"))
    kw = dict(pretrained_encoder=os.path.join(CAP, "encoder_pretrained.npz"), target_shape=(80, 512))
    windows = _capstone_windows()
    gw_task = gw_load(*files, **kw)
    want = np.asarray(jax.jit(lambda w: gw_task.forward(gw_task.trainable, gw_task.frozen, w))(
        jnp.asarray(windows)))
    task = load_task_from_components(*files, device="cpu", **kw)
    assert task.cfg.encoder.compute_dtype == torch.float32 and not task.cfg.encoder.gelu_approx
    got = task.forward(torch.from_numpy(windows)).numpy()
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * float(np.abs(want).max()))


@pytest.mark.slow
def test_capstone_cli_on_hdf5_file_matches_gwkit_cli(tmp_path):
    import h5py

    from gwkit.cli.inference import main as gw_main
    from gwkit_torch.cli.inference import main as port_main

    path = str(tmp_path / "in.hdf")
    strain = _segment_strain(64, seed=5)
    with h5py.File(path, "w") as f:
        for i, det in enumerate(("H1", "L1")):
            ds = f.create_group(det).create_dataset("1238205000", data=strain[i].astype(np.float64))
            ds.attrs["start_time"] = 1238205000.0
            ds.attrs["delta_t"] = 1.0 / FS
    common = [path, "--lora-weights", os.path.join(RUN, "best_lora_weights"),
              "--dense-weights", os.path.join(RUN, "best_dense_layers.npz"),
              "--adapter-weights", os.path.join(RUN, "best_adapter.npz"),
              "--pretrained-encoder", os.path.join(CAP, "encoder_pretrained.npz"),
              "--target-shape", "80", "512", "--batch-size", "64"]
    gw_main([common[0], str(tmp_path / "gw.hdf"), *common[1:], "--stream", "0"])
    port_main([common[0], str(tmp_path / "pt.hdf"), *common[1:], "--cpu"])
    with h5py.File(tmp_path / "gw.hdf") as a, h5py.File(tmp_path / "pt.hdf") as b:
        want = {k: a[k][()] for k in a}
        got = {k: b[k][()] for k in b}
    np.testing.assert_allclose(got["all_vals"], want["all_vals"], rtol=1e-4,
                               atol=1e-4 * float(np.abs(want["all_vals"]).max()))
    err = float(np.abs(got["all_vals"] - want["all_vals"]).max())
    near = np.abs(want["all_vals"] + 0.5) <= 10 * err
    assert not near.any(), "a score sits within 10x the packages' difference of the -0.5 threshold"
    np.testing.assert_array_equal(got["time"], want["time"])
    np.testing.assert_allclose(got["stat"], want["stat"], rtol=1e-4)
