"""The port's Signal_vs_Noise and glitch CLIs against gwkit's on the same
tiny HDF5 files, with ``--cpu`` (f32, plain PyTorch): Whisper-tiny at 64
mel frames (32 tokens), 0.5 s of strain, the same base encoder for both
(``--pretrained-encoder``).

The packages draw their initial trainables from different generators, so
each training comparison hands gwkit's initial trainables to the port's
builder; the glitch head's dropout rate is set to 0 in both packages (its
draws differ); and each training epoch is one batch holding the whole
training split at a fixed SNR, so the packages' different shuffles do not
matter. Then: losses.txt within 1e-5 (tests/test_torch_train.py's loss
tolerance), the printed validation metrics, the glitch reports and every
evaluation text file equal.
"""
import importlib.util
import os

import numpy as np
import pytest

import jax

import gwkit.models.heads as gw_heads
import gwkit.train.tasks as gw_tasks
import gwkit_torch.models.heads as heads
import gwkit_torch.train.tasks as tasks
from gwkit_torch.io import from_gwkit_numpy

ARGS = ["--n-frames", "64", "--lora-rank", "4", "--lora-alpha", "8"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    import h5py

    from gwkit.data.datasets import InjectionDataset as GwDataset
    from gwkit.models.whisper import config_for, init_encoder_params
    from gwkit.train.checkpoints import save_pytree

    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(11)
    enc = str(d / "encoder.npz")
    save_pytree(enc, jax.tree.map(np.asarray, init_encoder_params(jax.random.PRNGKey(1), config_for("tiny"))))
    signal = str(d / "signal.hdf")
    with h5py.File(signal, "w") as f:
        for group, n in (("training", 8), ("validation", 6)):
            GwDataset(noises=rng.normal(size=(n, 2, 1024)).astype(np.float32),
                      waveforms=(0.3 * rng.normal(size=(n // 2, 2, 1024))).astype(np.float32)).save(f, group)
    glitch = str(d / "glitch.hdf")
    with h5py.File(glitch, "w") as f:
        f["strain"] = rng.normal(size=(15, 1024)).astype(np.float32)
        f["labels"] = rng.integers(0, 11, 15).astype(np.int64)
    return dict(enc=enc, signal=signal, glitch=glitch)


def _share_initial_trainables(monkeypatch, name):
    """gwkit's builder records its initial trainables; the port's takes them."""
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


def _assert_losses_close(got_dir, want_dir):
    got, want = _losses(os.path.join(got_dir, "losses.txt")), _losses(os.path.join(want_dir, "losses.txt"))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 0], want[:, 0])
    np.testing.assert_allclose(got[:, 1:], want[:, 1:], rtol=0, atol=1e-5)


def _text(*parts):
    return open(os.path.join(*parts)).read()


def test_signal_cli_train_and_evaluate_match_gwkit(files, tmp_path, monkeypatch, capsys):
    from gwkit.cli import evaluate_classifier as gw_eval
    from gwkit.cli import train as gw_train
    from gwkit_torch.cli import evaluate_classifier, train

    _share_initial_trainables(monkeypatch, "build_signal_vs_noise")
    common = ["-d", files["signal"], "--pretrained-encoder", files["enc"], "--epochs", "2", "--batch-size", "8",
              "--snr", "8", "8", "--learning-rate", "1e-4", *ARGS]
    gw_train.main([*common, "-o", str(tmp_path / "gw")])
    want_out = capsys.readouterr().out
    train.main([*common, "-o", str(tmp_path / "pt"), "--cpu"])
    got_out = capsys.readouterr().out
    _assert_losses_close(tmp_path / "pt", tmp_path / "gw")
    lines = lambda out: [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert lines(got_out) == lines(want_out) and len(lines(got_out)) == 2
    for name in ("best.npz", "last.ckpt", "train_config.json", "config.json", "best_dense_layers.npz"):
        assert os.path.isfile(tmp_path / "pt" / name), name
    assert os.path.isdir(tmp_path / "pt" / "best_lora_weights")
    # one more epoch from the port's last checkpoint
    train.main([*common, "-o", str(tmp_path / "pt"), "--cpu", "--resume", "--epochs", "3"])
    assert _losses(tmp_path / "pt" / "losses.txt")[:, 0].tolist() == [1, 2, 3]

    ev = ["-d", files["signal"], "--checkpoint", str(tmp_path / "gw" / "best.npz"),
          "--pretrained-encoder", files["enc"], "--snrs", "8", "20", "--bootstrap", "50", "--batch-size", "4", *ARGS]
    gw_eval.main([*ev, "-o", str(tmp_path / "gw_eval")])
    evaluate_classifier.main([*ev, "-o", str(tmp_path / "pt_eval"), "--cpu"])
    assert _text(tmp_path, "pt_eval", "evaluation.txt") == _text(tmp_path, "gw_eval", "evaluation.txt")
    assert _text(tmp_path, "pt_eval", "evaluation.txt").count("SNR ") == 2
    assert os.path.isfile(tmp_path / "pt_eval" / "roc_snr20.png")

    # without matplotlib (the card's machine): the same text, no PNG, one logged line
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda n, *a: None if n == "matplotlib" else real(n, *a))
    evaluate_classifier.main([*ev, "-o", str(tmp_path / "pt_eval2"), "--cpu"])
    assert _text(tmp_path, "pt_eval2", "evaluation.txt") == _text(tmp_path, "gw_eval", "evaluation.txt")
    assert not [n for n in os.listdir(tmp_path / "pt_eval2") if n.endswith(".png")]


def test_glitch_cli_train_and_evaluate_match_gwkit(files, tmp_path, monkeypatch, capsys):
    from gwkit.cli import evaluate_classifier as gw_eval
    from gwkit.cli import train_glitch as gw_train
    from gwkit_torch.cli import evaluate_classifier, train_glitch

    _share_initial_trainables(monkeypatch, "build_glitch")
    monkeypatch.setitem(gw_heads.HEAD_DROPOUT, "glitch", 0.0)
    monkeypatch.setitem(heads.HEAD_DROPOUT, "glitch", 0.0)
    common = ["-d", files["glitch"], "--pretrained-encoder", files["enc"], "--epochs", "2", "--batch-size", "12",
              "--valid-fraction", "0.2", "--learning-rate", "1e-4", *ARGS]
    gw_train.main([*common, "-o", str(tmp_path / "gw")])
    want_out = capsys.readouterr().out
    train_glitch.main([*common, "-o", str(tmp_path / "pt"), "--cpu"])
    got_out = capsys.readouterr().out
    _assert_losses_close(tmp_path / "pt", tmp_path / "gw")
    lines = lambda out: [ln for ln in out.splitlines() if ln.startswith("epoch ")]
    assert lines(got_out) == lines(want_out) and len(lines(got_out)) == 2
    for name in ("classification_report.txt", "confusion_matrix.txt"):
        assert _text(tmp_path, "pt", name) == _text(tmp_path, "gw", name), name
    assert os.path.isfile(tmp_path / "pt" / "confusion_matrix.png")

    ev = ["-d", files["glitch"], "--task", "glitch", "--checkpoint", str(tmp_path / "gw" / "best.npz"),
          "--pretrained-encoder", files["enc"], "--valid-fraction", "0", "--batch-size", "4", *ARGS]
    gw_eval.main([*ev, "-o", str(tmp_path / "gw_eval")])
    evaluate_classifier.main([*ev, "-o", str(tmp_path / "pt_eval"), "--cpu"])
    for name in ("evaluation.txt", "confusion_matrix.txt"):
        assert _text(tmp_path, "pt_eval", name) == _text(tmp_path, "gw_eval", name), name
    assert _text(tmp_path, "pt_eval", "evaluation.txt").startswith("accuracy ")
    assert np.loadtxt(tmp_path / "pt_eval" / "confusion_matrix.txt").sum() == 15


def test_glitch_cli_full_finetune_with_augmentation(files, tmp_path):
    """--full-finetune --augment: the encoder trains (its own checkpoint
    leaves), no adapters are exported, the reports are written."""
    from gwkit_torch.cli import train_glitch

    out = tmp_path / "ft"
    train_glitch.main(["-d", files["glitch"], "--pretrained-encoder", files["enc"], "--epochs", "1",
                       "--batch-size", "6", "--full-finetune", "--augment", "-o", str(out), "--cpu", *ARGS])
    assert _losses(out / "losses.txt").shape == (1, 3) and np.isfinite(_losses(out / "losses.txt")).all()
    assert not os.path.exists(out / "best_lora_weights")
    assert os.path.isfile(out / "classification_report.txt")
    with np.load(out / "best.npz") as f:
        assert len([k for k in f if k.startswith("leaf_")]) > 20  # encoder and head
