"""The plain reference against the port's plain CPU path at small sizes: the
weight readers, the whitening, the Q-scan, the Q-adapter, one encoder layer
with DoRA, and the log-mel front end."""
import dataclasses

import numpy as np
import pytest
import torch

from gwbench import files
from gwbench.reference import mel as ref_mel
from gwbench.reference import model as ref_model
from gwbench.reference import weights as wfiles
from gwbench.reference.qscan import QScan
from gwbench.reference.whiten import whiten

CFG = files.config("mlgwsc-capstone-tiny")
W = {k: str(files.checkout_path(v)) for k, v in CFG["weights"].items() if k != "from"}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


@pytest.fixture(scope="module")
def port_task():
    from gwkit_torch.cli.inference import load_task_from_components

    return load_task_from_components(W["lora"], W["head"], W["qadapter"], pretrained_encoder=W["encoder"],
                                     target_shape=(80, 512), device="cpu")


def test_weight_readers_equal_the_ports_loader(port_task):
    p = port_task.params
    enc = wfiles.encoder(W["encoder"])
    for i, layer in enumerate(p["encoder"]["layers"]):
        for name, leaf in layer.items():
            for k, t in leaf.items():
                np.testing.assert_array_equal(enc["layers"][i][name][k], t.numpy())
    np.testing.assert_array_equal(enc["conv2"]["w"], p["encoder"]["conv2"]["w"].numpy())
    ads = wfiles.peft_dora(W["lora"], 4)
    for i, layer in enumerate(p["adapters"]):
        for proj, entry in layer.items():
            for k in ("a", "b", "m"):
                np.testing.assert_array_equal(ads[i][proj][k], entry[k].numpy())
            assert ads[i][proj]["scaling"] == float(entry["scaling"])
    head = wfiles.mlp_head(W["head"])
    for mine, theirs in zip(head, p["head"]):
        np.testing.assert_array_equal(mine["w"], theirs["w"].numpy())
    q = wfiles.nest(wfiles.npz_leaves(W["qadapter"], wfiles.QADAPTER_KEYS))
    np.testing.assert_array_equal(q["conv3"]["w"], p["qadapter"]["conv3"]["w"].numpy())
    np.testing.assert_array_equal(q["film_gamma"], p["qadapter"]["film_gamma"].numpy())


@pytest.fixture(scope="module")
def white():
    from gwkit_torch.ops.whiten import whiten_estimate

    raw = (np.random.default_rng(5).standard_normal((2, 8 * 2048)) * 1e-21).astype(np.float32)
    port = whiten_estimate(torch.from_numpy(raw), 1 / 2048, 0.5, 0.25, 20.0)
    mine = whiten(torch.from_numpy(raw), 1 / 2048, 0.5, 0.25, 20.0)
    return port, mine


def test_whitening(white):
    port, mine = white
    assert port.shape == mine.shape
    assert _rel(port, mine) < 1e-4


def test_qscan(white):
    from gwkit_torch.ops.qtransform import make_qplan, qscan

    x = white[1][:, 100: 100 + 2048].float()
    x = torch.cat([x, x * 3 + torch.sin(torch.arange(2048) * 0.3)])
    port = qscan(x, make_qplan(1.0, 2048.0, (4.0, 128.0), (128, 128)))
    mine = QScan(1.0, 2048.0, (4.0, 128.0), (128, 128))(x)
    assert _rel(port, mine) < 1e-4


def test_qadapter(port_task):
    from gwkit_torch.models.qadapter import qadapter_apply_spec

    spec = torch.rand(2, 2, 128, 128, generator=torch.Generator().manual_seed(3)) * 5
    port = qadapter_apply_spec(port_task.qcfg, port_task.params["qadapter"], spec)
    q = ref_model.tensors(wfiles.nest(wfiles.npz_leaves(W["qadapter"], wfiles.QADAPTER_KEYS)), "cpu")
    assert _rel(port, ref_model.qadapter(q, spec, (80, 512))) < 1e-5


@pytest.mark.parametrize("gelu", ["tanh", "erf"])
def test_one_encoder_layer_with_dora(port_task, gelu):
    """The capstone's first layer and its DoRA adapters (B non-zero), stem and
    final LayerNorm included, on 64 frames."""
    from gwkit_torch.models.whisper import WhisperEncoder

    p = port_task.params
    enc_cfg = dataclasses.replace(port_task.cfg.encoder, n_layers=1, gelu_approx=gelu == "tanh", max_positions=32)
    enc = {**p["encoder"], "layers": p["encoder"]["layers"][:1], "pos": p["encoder"]["pos"][:32]}
    mel = torch.randn(3, 80, 64, generator=torch.Generator().manual_seed(1))
    port = WhisperEncoder(enc_cfg, enc, p["adapters"][:1])(mel)
    ref_enc = wfiles.encoder(W["encoder"])
    ref_enc["layers"] = ref_enc["layers"][:1]
    mine = ref_model.Encoder(ref_enc, wfiles.peft_dora(W["lora"], 4)[:1], 6, gelu, "cpu")(mel)
    assert _rel(port, mine) < 1e-4


def test_log_mel_front_end():
    from gwkit_torch.ops.mel import whisper_log_mel
    from gwkit_torch.ops.resample import resample_timeseries

    strain = torch.from_numpy(np.random.default_rng(2).standard_normal((3, 2048)).astype(np.float32))
    for frames in (200, 3000):
        port = whisper_log_mel(resample_timeseries(strain, 2048, 16000), pad_to=frames * 160, num_frames=frames)
        mine = ref_mel.features(strain, 2048, frames)
        assert port.shape == mine.shape
        assert float((port - mine).abs().max()) < 2e-4


def test_resample_is_scipys():
    from scipy.signal import resample

    x = np.random.default_rng(4).standard_normal((2, 2048))
    np.testing.assert_allclose(ref_mel.resample(torch.from_numpy(x), 16000).numpy(), resample(x, 16000, axis=-1),
                               atol=1e-10)
