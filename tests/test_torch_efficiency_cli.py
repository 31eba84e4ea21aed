"""The port's efficiency-test, stream-evaluation, real-event and
preprocessing CLIs against gwkit's on the same tiny HDF5 files, with
``--cpu`` (f32, plain PyTorch): Whisper-tiny at 64 mel frames (32 tokens),
the same base encoder for both (``--pretrained-encoder``).

``train_efficiency``: the packages draw their initial trainables and SNRs
from different generators, so gwkit's initial trainables are handed to the
port's build_signal_vs_noise (tests/test_torch_mel_cli.py's device), the samples carry
zero waveforms (the SNR draw then changes nothing) and each epoch is one
batch of the whole training split (the shuffle then changes nothing); the
curriculum itself is held rung by rung by tests/test_torch_efficiency.py.
Then: losses.txt within 1e-5 (tests/test_torch_train.py's loss
tolerance), the scheduler's printed lines and the run_0000 layout equal.
The other CLIs read gwkit's checkpoints; their text outputs are equal,
``evaluate_stream``'s three HDF5 files key by key and bit for bit,
``real_events``' scores within 1e-4 x max and ``preprocess``' resampled
rows within 1e-5 x max (jnp's FFT against torch's), its windows exactly.
"""
import os

import h5py
import numpy as np
import pytest

import jax

import gwkit.train.tasks as gw_tasks
import gwkit_torch.train.tasks as tasks
from gwkit_torch.io import from_gwkit_numpy

ARGS = ["--n-frames", "64", "--lora-rank", "4", "--lora-alpha", "8"]
N_TRAIN, N_VALID = 8, 6


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from gwkit.data.datasets import InjectionDataset as GwDataset
    from gwkit.models.whisper import config_for, init_encoder_params
    from gwkit.train.checkpoints import save_pytree

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(12)
    enc = str(d / "encoder.npz")
    save_pytree(enc, jax.tree.map(np.asarray, init_encoder_params(jax.random.PRNGKey(1), config_for("tiny"))))
    train = str(d / "train.hdf")  # zero waveforms: the SNR draws cancel
    with h5py.File(train, "w") as f:
        for group, n in (("training", N_TRAIN), ("validation", N_VALID)):
            GwDataset(noises=rng.normal(size=(n, 2, 1024)).astype(np.float32),
                      waveforms=np.zeros((n // 2, 2, 1024), np.float32)).save(f, group)
    sweep = str(d / "sweep.hdf")  # a validation group of 5 injections and 11 pure noises
    with h5py.File(sweep, "w") as f:
        GwDataset(noises=rng.normal(size=(16, 2, 1024)).astype(np.float32),
                  waveforms=(0.3 * rng.normal(size=(5, 2, 1024))).astype(np.float32)).save(f, "validation")
    events = str(d / "events.hdf")
    with h5py.File(events, "w") as f:
        f["GW150914"] = rng.normal(size=(2, 4096)).astype(np.float32)
        f["GW170817"] = rng.normal(size=(2, 3000)).astype(np.float32)
    return dict(enc=enc, train=train, sweep=sweep, events=events)


def _share_initial_trainables(monkeypatch, name):
    """gwkit's build function records its initial trainables; the port's takes them."""
    held = {}
    gw_build, port_build = getattr(gw_tasks, name), getattr(tasks, name)

    def gw_wrapped(*a, **kw):
        task = gw_build(*a, **kw)
        held.update(jax.tree.map(np.asarray, task.trainable))
        return task

    def port_wrapped(encoder, params=None, **kw):
        return port_build(encoder, {**(params or {}), **from_gwkit_numpy(**held)}, **kw)

    monkeypatch.setattr(gw_tasks, name, gw_wrapped)
    monkeypatch.setattr(tasks, name, port_wrapped)


def _losses(path):
    return np.array([[float(v) for v in ln.split("\t")] for ln in open(path).read().splitlines()])


def _text(*parts):
    return open(os.path.join(*parts)).read()


@pytest.fixture(scope="module")
def trained(files, tmp_path_factory):
    """gwkit's and the port's train_efficiency runs: the epoch scheduler
    over the ladder 30 20 10 with a rung an epoch and the optimizer reset at
    each step (the printed lines captured by hand: capsys is per test)."""
    import contextlib
    import io

    from gwkit.cli import train_efficiency as gw_cli
    from gwkit_torch.cli import train_efficiency

    out = tmp_path_factory.mktemp("runs")
    common = ["-d", files["train"], "--pretrained-encoder", files["enc"], "--epochs", "3",
              "--batch-size", str(N_TRAIN), "--scheduler", "epoch", "--scheduler-patience", "0",
              "--snr-ladder", "30", "20", "10", "--reset-optimizer", "--learning-rate", "1e-4", *ARGS]
    printed = {}
    with pytest.MonkeyPatch.context() as mp:
        _share_initial_trainables(mp, "build_signal_vs_noise")
        for key, main, extra in (("gw", gw_cli.main, []), ("pt", train_efficiency.main, ["--cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                main([*common, "-o", str(out / key), *extra])
            printed[key] = buf.getvalue()
    return out, printed


def test_train_efficiency_cli_matches_gwkit(trained):
    out, printed = trained
    got, want = _losses(out / "pt" / "run_0000" / "losses.txt"), _losses(out / "gw" / "run_0000" / "losses.txt")
    assert got.shape == want.shape == (3, 3)
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-5)
    rungs = lambda s: [ln for ln in s.splitlines() if ln.startswith("# Reducing SNR range")]
    assert rungs(printed["pt"]) == rungs(printed["gw"])
    assert rungs(printed["pt"])[-2:] == ["# Reducing SNR range from 25.000000-30.000000 to 15.000000-20.000000",
                                         "# Reducing SNR range from 15.000000-20.000000 to 5.000000-10.000000"]
    assert sorted(os.listdir(out / "pt" / "run_0000")) == sorted(os.listdir(out / "gw" / "run_0000"))
    assert {"state_e_0001.npz", "state_e_0003.npz", "best.npz", "last.ckpt"} <= set(os.listdir(out / "pt" / "run_0000"))
    assert os.path.isfile(out / "pt" / "config.json")


@pytest.mark.parametrize("epochs", ["all", "best", "1,3"])
def test_calculate_efficiencies_cli_matches_gwkit(files, trained, tmp_path, epochs):
    from gwkit.cli import calculate_efficiencies as gw_cli
    from gwkit_torch.cli import calculate_efficiencies

    run = str(trained[0] / "gw" / "run_0000")
    common = ["-d", files["sweep"], "--checkpoint-dir", run, "--pretrained-encoder", files["enc"],
              "--snrs", "2", "6", "15", "--faps", "0.2", "0.1", "--batch-size", "4", "--epochs", epochs, *ARGS]
    gw_cli.main([*common, "-o", str(tmp_path / "gw")])
    calculate_efficiencies.main([*common, "-o", str(tmp_path / "pt"), "--cpu"])
    names = sorted(n for n in os.listdir(tmp_path / "gw") if n.startswith("out_efficiencies_"))
    assert names == sorted(n for n in os.listdir(tmp_path / "pt") if n.startswith("out_efficiencies_"))
    assert len(names) == {"all": 3, "best": 1, "1,3": 2}[epochs]
    for name in names:
        assert _text(tmp_path, "pt", name) == _text(tmp_path, "gw", name), name
    assert _text(tmp_path, "pt", names[0]).startswith("# SNR\tFAP=0.2\tFAP=0.1\n2\t")


def _score_dir(path, rng):
    os.makedirs(path)
    for start in (0, 16, 32):  # logits at a 0.1 s stride; injections at 20 and 37 s, a false alarm at 44 s
        t = start + (0.1 if start else 0.0) + 0.75 + 0.1 * np.arange(160)
        logit0 = np.where(np.abs(t - 20.0) < 0.3, 4.0, np.where(np.abs(t - 37.0) < 0.2, 3.0,
                          np.where(np.abs(t - 44.0) < 0.2, 2.0, -3.0)))
        logit0 = logit0 + 0.5 * rng.random(160)
        with h5py.File(os.path.join(path, f"scores-{start}-16.hdf"), "w") as f:
            f.create_dataset("data", data=np.stack([logit0, rng.normal(size=160)], axis=1))


def _assert_h5_equal(got, want):
    with h5py.File(got) as g, h5py.File(want) as w:
        assert sorted(g.keys()) == sorted(w.keys())
        for key in w:
            assert g[key].dtype == w[key].dtype
            np.testing.assert_array_equal(g[key][()], w[key][()])
        assert dict(g.attrs) == dict(w.attrs)


def test_evaluate_stream_cli_matches_gwkit(tmp_path):
    from gwkit.cli import evaluate_stream as gw_cli
    from gwkit_torch.cli import evaluate_stream

    rng = np.random.default_rng(13)
    inj = str(tmp_path / "inj.hdf")
    with h5py.File(inj, "w") as f:
        f["tc"], f["mass1"], f["mass2"], f["distance"] = (np.array([37.0, 20.0, 60.0]), np.array([30.0, 12.0, 20.0]),
                                                        np.array([25.0, 10.0, 20.0]), np.array([400.0, 900.0, 100.0]))
    for key in ("gw", "pt"):
        _score_dir(str(tmp_path / key), np.random.default_rng(14))
    for ranking, threshold in (("softmax", "0.9"), ("linear", "0.5")):
        args = ["--injection-file", inj, "--trigger-threshold", threshold, "--ranking-statistic", ranking, "--force"]
        gw_cli.main([*args, "--data-dir", str(tmp_path / "gw")])
        evaluate_stream.main([*args, "--data-dir", str(tmp_path / "pt"), "--cpu"])
        for name in ("triggers.hdf", "events.hdf", "statistics.hdf"):
            _assert_h5_equal(tmp_path / "pt" / name, tmp_path / "gw" / name)
    with h5py.File(tmp_path / "pt" / "events.hdf") as f:
        assert len(f["times"]) >= 3
    # the caches: from the triggers, and from the events, into fresh directories
    for load in ("--load-triggers", "--load-events"):
        cached = "triggers.hdf" if load == "--load-triggers" else "events.hdf"
        for key, main in (("gw", gw_cli.main), ("pt", evaluate_stream.main)):
            os.makedirs(tmp_path / f"{key}{load}")
            main([load, str(tmp_path / key / cached), "--injection-file", inj, "--duration", "48.1",
                  "--data-dir", str(tmp_path / f"{key}{load}")])
        for name in sorted(os.listdir(tmp_path / f"gw{load}")):
            _assert_h5_equal(tmp_path / f"pt{load}" / name, tmp_path / f"gw{load}" / name)
    # the refusals, as gwkit's
    for args, match in ((["--data-dir", ".", "--test-data-activation", "softmax", "--ranking-statistic", "linear"],
                         "linear ranking statistic"),
                        ([], "--data-dir is required"),
                        (["--load-triggers", str(tmp_path / "pt" / "triggers.hdf")], "--duration is required")):
        for main in (gw_cli.main, evaluate_stream.main):
            with pytest.raises(SystemExit, match=match):
                main([*args, "--injection-file", inj])
    with pytest.raises(IOError, match="already exists"):
        evaluate_stream.main(["--data-dir", str(tmp_path / "pt"), "--injection-file", inj])


@pytest.mark.parametrize("whiten", [False, True])
def test_real_events_cli_matches_gwkit(files, trained, tmp_path, capsys, whiten):
    from gwkit.cli import real_events as gw_cli
    from gwkit_torch.cli import real_events

    args = ["-d", files["events"], "--checkpoint", str(trained[0] / "gw" / "run_0000" / "best.npz"),
            "--pretrained-encoder", files["enc"], "--sample-rate", "1024", "--window", "512", "--step", "51",
            "--batch-size", "16", *ARGS] + (["--whiten"] if whiten else [])
    gw_cli.main([*args, "-o", str(tmp_path / "gw.hdf")])
    want_out = capsys.readouterr().out
    real_events.main([*args, "-o", str(tmp_path / "pt.hdf"), "--cpu"])
    got_out = capsys.readouterr().out
    with h5py.File(tmp_path / "pt.hdf") as g, h5py.File(tmp_path / "gw.hdf") as w:
        assert sorted(g.keys()) == sorted(w.keys()) == ["GW150914", "GW170817"]
        for key in w:
            assert g[key].dtype == w[key].dtype == np.float32 and g[key].shape == w[key].shape
            np.testing.assert_allclose(g[key][()], w[key][()], rtol=0, atol=1e-4 * np.abs(w[key][()]).max())
        half = 128 if whiten else 0  # the whitening crop: max_filter_duration 0.25 s at 1024 Hz, halved
        assert g["GW150914"].shape == (1 + (4096 - 2 * half - 512) // 51,)
    assert got_out == want_out and got_out.count("windows, max score") == 2
    assert os.path.isfile(str(tmp_path / "pt.hdf") + ".config.json")


def test_preprocess_cli_matches_gwkit(tmp_path, capsys):
    from gwkit.cli import preprocess as gw_cli
    from gwkit_torch.cli import preprocess

    rng = np.random.default_rng(15)
    src = str(tmp_path / "in.hdf")
    with h5py.File(src, "w") as f:
        f["strain"] = rng.normal(size=(7, 256)).astype(np.float32)
        f["group/one"] = rng.normal(size=256).astype(np.float32)
        f["group/inner/two"] = rng.normal(size=(2, 300)).astype(np.float32)
    for mode, extra in (("resample", ["--chunk", "3"]), ("resample", ["--target-rate", "1000", "--chunk", "4"]),
                        ("events", ["--window", "64", "--step", "20"])):
        gw_cli.main([mode, src, str(tmp_path / "gw.hdf"), *extra])
        want_out = capsys.readouterr().out
        preprocess.main(["--cpu", mode, src, str(tmp_path / "pt.hdf"), *extra])  # a top-level flag
        assert capsys.readouterr().out == want_out
        with h5py.File(tmp_path / "pt.hdf") as g, h5py.File(tmp_path / "gw.hdf") as w:
            names = []
            w.visititems(lambda n, o: names.append(n) if isinstance(o, h5py.Dataset) else None)
            assert len(names) == 3
            for name in names:
                got, want = g[name][()], w[name][()]
                assert got.shape == want.shape and got.dtype == want.dtype
                if mode == "events":
                    np.testing.assert_array_equal(got, want)
                else:
                    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
