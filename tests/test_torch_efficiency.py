"""Port parity for the detection-efficiency workload: PartitionedDataset,
the curriculum schedulers, Trainer.reset_optimizer, EfficiencyEstimator and
write_efficiency_table, against gwkit on the same numpy inputs.

Tolerances: datasets, schedulers and the table writer exactly; the
optimizer's state right after a reset exactly, the parameters three steps
later within rtol 1e-4 and atol 1e-5 (tests/test_torch_train.py's rtol;
Adam divides by the root of small second moments, so last-bit differences
of the gradients grow, to 8e-7 here, against lr 0.05); the sweep through
both tiny tasks (d 32, 2 heads, 1 layer, 128 mel frames, f32 on the CPU)
with scores within 1e-4 x max |score|, and tables equal except where a
score lies that close to a threshold (then one sample may cross, and the
entry may differ by one sample's share).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.data.datasets import InjectionDataset as GwInjectionDataset
from gwkit.data.datasets import PartitionedDataset as GwPartitionedDataset
from gwkit.evaluation.efficiency import EfficiencyEstimator as GwEstimator
from gwkit.evaluation.efficiency import write_efficiency_table as gw_write
from gwkit.models.whisper import WhisperConfig as GwW
from gwkit.train import curriculum as gw_cl
from gwkit.train.tasks import build_signal_vs_noise as gw_build
from gwkit.train.trainer import TrainConfig as GwTrainConfig
from gwkit.train.trainer import Trainer as GwTrainer
from gwkit_torch.data.datasets import InjectionDataset, PartitionedDataset
from gwkit_torch.evaluation.efficiency import EfficiencyEstimator, write_efficiency_table
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.train import curriculum as cl
from gwkit_torch.train.tasks import build_signal_vs_noise
from gwkit_torch.train.trainer import TrainConfig, Trainer

TINY = dict(d_model=32, n_heads=2, n_layers=1, d_ff=64, max_positions=1500)


@pytest.mark.parametrize("shape", [(64,), (2, 64)])
def test_partitioned_dataset_matches_gwkit_across_the_boundary(shape):
    rng = np.random.default_rng(3)
    waves = rng.normal(size=(6, *shape)).astype(np.float32)
    noises = rng.normal(size=(12, *shape)).astype(np.float32)
    layout = dict(wave_limits=(1, 4), noise_combined_limits=(2, 8), noise_pure_limits=(8, 12), noises_per_signal=2)
    gw = GwPartitionedDataset(waves, noises, (5.0, 15.0), **layout)
    port = PartitionedDataset(waves, noises, (5.0, 15.0), **layout, device="cpu")
    assert len(port) == len(gw) == 10 and port.signal_samples == gw.signal_samples == 6
    for ds in (gw, port):
        assert ds.snrs() == (5.0, 15.0)
        ds.snrs((7.5, 7.5))
        assert ds.snrs() == (7.5, 7.5)
        ds.snrs(7.5, 7.5)
    idx = np.array([0, 1, 4, 5, 6, 7, 9, 3, 8, 2])  # both sides of index 6, wave/noise boundary
    want = gw.sample_batch(jax.random.PRNGKey(0), jnp.asarray(idx))
    got = port.sample_batch(torch.Generator().manual_seed(0), torch.from_numpy(idx))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[2].tolist() == [7.5] * 4 + [0.0] * 3 + [7.5, 0.0, 7.5]  # indices below 6 are injections
    # index 6 is the pure pool's first noise, unmixed
    np.testing.assert_array_equal(got[0][4].numpy(), noises[8])


def _scripted(scheduler_cls, metrics, **kw):
    calls = []
    ladder = [(45.0, 50.0), (25.0, 30.0), (15.0, 20.0), (5.0, 10.0)]
    s = scheduler_cls(ladder, verbose=False, **kw)
    s.on_step = lambda: calls.append(s.current)
    trace = []
    for m in metrics:
        s.step(m)
        trace.append((s.current, s.done, s.interrupt, len(calls)))
    return trace


SCHEDULERS = {
    "plateau": ("PlateauCLScheduler", dict(patience=1, allow_interrupt=True)),
    "plateau_abs_max": ("PlateauCLScheduler", dict(patience=0, threshold=0.05, threshold_mode="abs",
                                                   optimization_mode="max")),
    "threshold": ("ThresholdCLScheduler", dict(threshold=0.4)),
    "threshold_max": ("ThresholdCLScheduler", dict(threshold=0.6, optimization_mode="max")),
    "epoch_0": ("EpochCLScheduler", dict(patience=0)),
    "epoch_2": ("EpochCLScheduler", dict(patience=2)),
}
METRICS = [1.0, 0.9, 0.9, 0.95, 0.5, 0.5, 0.5, 0.3, 0.3, 0.3, 0.7, 0.7, 0.7, 0.2, 0.2, 0.2, 0.2]


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_curriculum_schedulers_match_gwkit_rung_by_rung(name):
    cls, kw = SCHEDULERS[name]
    got, want = _scripted(getattr(cl, cls), METRICS, **kw), _scripted(getattr(gw_cl, cls), METRICS, **kw)
    assert got == want
    assert len({t[0] for t in got}) > 1  # the script steps the ladder
    if name == "plateau":
        assert got[-1][1] and got[-1][2]  # the last rung plateaued: interrupt


def _quadratic(xp):
    def loss_fn(trainable, frozen, batch, key):
        x, y = batch
        return xp.mean((trainable["w"] * x - y) ** 2), {}
    return loss_fn


def test_reset_optimizer_restarts_adam_as_optax():
    """Three steps, a reset, three steps: the state after the reset is zero
    with count 0 (bias correction restarts), and the parameters after it
    equal gwkit's; without the reset they would not."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(4, 3)).astype(np.float32)
    batches = [(rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(4, 3)).astype(np.float32))
               for _ in range(3)]
    cfg = dict(learning_rate=0.05, clip_norm=0.0, optimizer="adamw")
    gw = GwTrainer(_quadratic(jnp), {"w": jnp.asarray(w0)}, {}, GwTrainConfig(**cfg))
    port = Trainer(_quadratic(torch), {"w": torch.tensor(w0)}, {}, TrainConfig(**cfg))
    control = Trainer(_quadratic(torch), {"w": torch.tensor(w0)}, {}, TrainConfig(**cfg))
    t_batches = [tuple(torch.from_numpy(a) for a in b) for b in batches]
    gw.run_epoch([tuple(jnp.asarray(a) for a in b) for b in batches], jax.random.PRNGKey(0))
    port.run_epoch(t_batches)
    control.run_epoch(t_batches)
    assert port.opt_state.count == 3
    gw.reset_optimizer()
    port.reset_optimizer()
    state = port.optimizer.state_to_gwkit(port.opt_state, port.trainable)
    want = jax.tree.leaves(gw.opt_state)
    got = jax.tree.leaves(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert port.opt_state.count == 0 and all(not m.any() for m in port.opt_state.mu + port.opt_state.nu)
    gw.run_epoch([tuple(jnp.asarray(a) for a in b) for b in batches], jax.random.PRNGKey(1))
    port.run_epoch(t_batches)
    control.run_epoch(t_batches)
    want_w = np.asarray(gw.trainable["w"])
    np.testing.assert_allclose(port.trainable["w"].detach().numpy(), want_w, rtol=1e-4, atol=1e-5)
    assert np.abs(control.trainable["w"].detach().numpy() - want_w).max() > 1e-2


def _datasets(rng, n_noise=37, n_wave=13, shape=(2, 256)):
    noise_set = rng.normal(size=(n_noise, *shape)).astype(np.float32)
    wave_noise = rng.normal(size=(n_wave, *shape)).astype(np.float32)
    waves = (0.2 * rng.normal(size=(n_wave, *shape))).astype(np.float32)
    empty = np.zeros((0, *shape), np.float32)
    gw = (GwInjectionDataset(noises=wave_noise, waveforms=waves), GwInjectionDataset(noises=noise_set, waveforms=empty))
    port = (InjectionDataset(wave_noise, waves, device="cpu"), InjectionDataset(noise_set, empty, device="cpu"))
    return gw, port


def _assert_tables_agree(got, want, noise, waves, faps, tol):
    """Equal, except that an entry may differ by one sample where the
    deciding score lies within ``tol`` of the threshold: an injection's
    score, or the next-ranked noise score (the threshold itself may then
    be the other sample)."""
    ranked = np.sort(noise)
    for i, j in zip(*np.nonzero(got != want)):
        assert abs(got[i, j] - want[i, j]) * len(waves[i]) <= 1 + 1e-9
        p = len(ranked) - max(int(faps[j] * len(ranked)), 1)
        near = min(np.abs(waves[i] - ranked[p]).min(), *(abs(ranked[q] - ranked[p]) for q in (p - 1, p + 1)
                                                          if 0 <= q < len(ranked)))
        assert near <= tol, (i, j, near)


SNRS, FAPS = (1.0, 3.0, 8.5), (0.1, 0.05, 1e-3)


def test_efficiency_sweep_with_a_host_score_matches_gwkit(tmp_path):
    """A score computed identically in both packages: the sweep (the
    wrap-padded last batches trimmed, FAP 1e-3 at k = max(int(FAP N), 1))
    and the written table are equal byte for byte."""
    (gw_wave, gw_noise), (wave, noise) = _datasets(np.random.default_rng(1))
    score = lambda x: x[:, 0, 5] + x[:, 1, 7]
    want = GwEstimator(gw_wave, gw_noise, SNRS, batch_size=8, faps=FAPS)(score, seed=3)
    est = EfficiencyEstimator(wave, noise, SNRS, batch_size=8, faps=FAPS)
    got = est(score, seed=3)
    np.testing.assert_array_equal(got, want)
    noise_scores, wave_scores = est.scores(score)
    assert len(noise_scores) == 37 and [len(w) for w in wave_scores] == [13] * 3
    assert wave.snrs() == (8.5, 8.5) and noise.snrs() == (0.0, 0.0)
    gw_write(str(tmp_path / "gw.txt"), SNRS, FAPS, want)
    write_efficiency_table(str(tmp_path / "pt.txt"), SNRS, FAPS, got)
    assert (tmp_path / "pt.txt").read_bytes() == (tmp_path / "gw.txt").read_bytes()
    odd = np.array([[1 / 3, 0.0, 1.0], [2 / 7, 0.1234565, 0.9999995]])
    gw_write(str(tmp_path / "gw2.txt"), (5, 12.25), (0.5, 1e-4, 3e-7), odd)
    write_efficiency_table(str(tmp_path / "pt2.txt"), (5, 12.25), (0.5, 1e-4, 3e-7), odd)
    assert (tmp_path / "pt2.txt").read_bytes() == (tmp_path / "gw2.txt").read_bytes()


def test_efficiency_sweep_through_both_tiny_tasks_matches_gwkit(tmp_path):
    gw_task = gw_build(jax.random.PRNGKey(0), encoder=GwW(**TINY), input_sample_rate=256, n_frames=128)
    gw_task.trainable["adapters"] = jax.tree.map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07, gw_task.trainable["adapters"])
    params = from_gwkit_numpy(encoder=jax.tree.map(np.asarray, gw_task.frozen["encoder"]),
                              **jax.tree.map(np.asarray, gw_task.trainable))
    task = build_signal_vs_noise(WhisperConfig(**TINY), params, input_sample_rate=256, n_frames=128, device="cpu")
    (gw_wave, gw_noise), (wave, noise) = _datasets(np.random.default_rng(2))
    gw_score = jax.jit(lambda x: gw_task.forward(gw_task.trainable, gw_task.frozen, x).reshape(-1))
    gw_est = GwEstimator(gw_wave, gw_noise, SNRS, batch_size=8, faps=FAPS)
    want = gw_est(gw_score, seed=0)
    est = EfficiencyEstimator(wave, noise, SNRS, batch_size=8, faps=FAPS)
    score = lambda x: task.forward(x).reshape(-1)
    got = est(score, seed=0)
    noise_scores, wave_scores = est.scores(score)
    want_noise = gw_est._collect_scores(gw_noise, gw_score, jax.random.PRNGKey(0))
    tol = 1e-4 * np.abs(want_noise).max()
    np.testing.assert_allclose(noise_scores, want_noise, rtol=0, atol=tol)
    for snr, w in zip(SNRS, wave_scores):
        gw_wave.snrs((snr, snr))
        np.testing.assert_allclose(w, gw_est._collect_scores(gw_wave, gw_score, jax.random.PRNGKey(0)), rtol=0,
                                   atol=tol)
    assert np.ptp(noise_scores) > 10 * tol  # the scores rank, not only round
    _assert_tables_agree(got, want, noise_scores, wave_scores, FAPS, tol)
    assert got.shape == (3, 3)


def test_the_remaining_plots_write_what_gwkit_writes(tmp_path):
    """plot_losses, plot_efficiency_curves, plot_efficiency_vs_epoch,
    plot_sensitivity_vs_far and plot_qscan: a PNG of gwkit's pixel size."""
    import matplotlib.image

    from gwkit.utils import plotting as gw_plotting
    from gwkit_torch.utils import plotting

    rng = np.random.default_rng(9)
    losses = tmp_path / "losses.txt"
    losses.write_text("".join(f"{e:04d}\t{0.7 - 0.1 * e:.6f}\t{0.72 - 0.1 * e:.6f}\n" for e in (1, 2, 3)))
    eff = rng.random((3, 2))
    cases = {
        "plot_losses": (str(losses),),
        "plot_efficiency_curves": ((5, 7, 9), (0.1, 0.01), eff),
        "plot_efficiency_vs_epoch": ((1, 2, 3, 4), rng.random((4, 3)), (5, 7, 9), 0.01),
        "plot_sensitivity_vs_far": (np.array([1e-6, 1e-4, 0.0, 1e-3]), np.array([100.0, 200.0, 50.0, 300.0])),
        "plot_qscan": (rng.random((16, 32)),),
    }
    for name, args in cases.items():
        got = getattr(plotting, name)(*args, str(tmp_path / f"pt_{name}.png"))
        want = getattr(gw_plotting, name)(*args, str(tmp_path / f"gw_{name}.png"))
        assert got == str(tmp_path / f"pt_{name}.png")
        assert matplotlib.image.imread(got).shape == matplotlib.image.imread(want).shape, name
