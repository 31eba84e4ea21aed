"""Port parity for the Signal_vs_Noise and glitch workloads: the task
builders (one and two detectors, adapters and full fine-tuning), the
classifier assembly with its CNN head, three Trainer steps, ``fit``'s
callbacks, the glitch dataset, the encoder export to an HF state dict and
the WhisperConfig switches, against gwkit on the same numpy inputs and
weights (f32 on the CPU, a tiny width, n_frames 128).

Tolerances: forwards within 1e-4 x max |logit|; the Trainer as
tests/test_torch_train.py holds it (losses 1e-5 absolute, parameters rtol
1e-4 with atol lr/20), with the exception that file's docstring explains
counted: Adam moves an element by about the learning rate whatever its
gradient's size, so where a gradient cancels to rounding level (a head
unit alive on one sample) the two packages' elements may part by up to a
step. The heads here are 1024 wide, so a few such elements appear (4 of
the 524,288 of the second head layer in the two-detector case); at most
1e-4 of a leaf may lie beyond the tolerance, each within 3 x lr (three
steps). The glitch head's dropout draws from each package's
own generator, so trainer comparisons run with its rate set to 0 in both
packages and the dropout itself is held by its semantics
(test_torch_train.py::test_head_dropout_matches_gwkit_semantics) and here
by train/eval behaviour.
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gwkit.models.heads as gw_heads
import gwkit_torch.models.heads as heads
from gwkit.models import classifier as gw_clf
from gwkit.models.adapters import AdapterConfig as GwAdapterConfig
from gwkit.models.whisper import WhisperConfig as GwW
from gwkit.train import tasks as gw_tasks
from gwkit.train.trainer import TrainConfig as GwTrainConfig
from gwkit.train.trainer import Trainer as GwTrainer
from gwkit_torch.io import from_gwkit_numpy, to_gwkit_numpy
from gwkit_torch.models import classifier as clf
from gwkit_torch.models.adapters import AdapterConfig
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.train import tasks
from gwkit_torch.train.trainer import TrainConfig, Trainer

ENC = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256, max_positions=64)
N_FRAMES = 128
LR = 3e-4
STEP_CFG = dict(learning_rate=LR, clip_norm=0.0, epochs=1, batch_size=4, optimizer="adamw")
CASES = {  # name -> (gwkit builder kwargs, port builder kwargs)
    "signal_2det": dict(n_detectors=2),
    "signal_1det": dict(n_detectors=1),
    "glitch": dict(),
    "glitch_full_finetune": dict(full_finetune=True),
}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _nonzero_b(adapters):
    """Non-zero LoRA B, so the low-rank path counts."""
    return jax.tree.map(lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07,
                        adapters)


def _pair(case):
    kw = CASES[case]
    acfg = dict(r=4, alpha=8, use_dora=True, targets="qkvo")
    if case.startswith("signal"):
        gw = gw_tasks.build_signal_vs_noise(jax.random.PRNGKey(0), encoder=GwW(**ENC),
                                            acfg=GwAdapterConfig(**acfg), n_frames=N_FRAMES, **kw)
        build = tasks.build_signal_vs_noise
    else:
        gw = gw_tasks.build_glitch(jax.random.PRNGKey(0), encoder=GwW(**ENC), acfg=GwAdapterConfig(**acfg),
                                   n_frames=N_FRAMES, **kw)
        build = tasks.build_glitch
    if "adapters" in gw.trainable:
        gw.trainable["adapters"] = _nonzero_b(gw.trainable["adapters"])
    params = from_gwkit_numpy(**{"encoder": _np(gw.frozen.get("encoder")), **_np(gw.trainable)})
    port = build(WhisperConfig(**ENC), params, acfg=AdapterConfig(**acfg), n_frames=N_FRAMES, device="cpu", **kw)
    return gw, port


def _batch(case, n=4, seed=0):
    rng = np.random.default_rng(seed)
    if case.startswith("signal"):
        return (rng.normal(size=(n, 2, 2048)).astype(np.float32),
                np.eye(2, dtype=np.float32)[rng.integers(0, 2, n)], np.full(n, 8.0, np.float32))
    return rng.normal(size=(n, 2048)).astype(np.float32), rng.integers(0, 11, n).astype(np.int32)


def _torch_batch(batch):
    return tuple(torch.from_numpy(np.asarray(b, np.int64 if b.dtype == np.int32 else b.dtype)) for b in batch)


def _close(got, want, frac=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_loss_match_gwkit(case):
    gw, port = _pair(case)
    x = _batch(case)
    want = gw.forward(gw.trainable, gw.frozen, jnp.asarray(x[0]))
    _close(port.forward(torch.from_numpy(x[0])).numpy(), want)
    tb = _torch_batch(x)
    got = port.apply(port.trainable, port.frozen, tb[0])  # the differentiable path
    _close(got.detach().numpy(), want)
    loss, aux = port.loss_fn(port.trainable, port.frozen, tb)
    want_loss, want_aux = gw.loss_fn(gw.trainable, gw.frozen, tuple(jnp.asarray(b) for b in x), None)
    assert abs(float(loss) - float(want_loss)) <= 1e-5
    assert set(aux) == set(want_aux)
    for k in aux:
        _close(aux[k].numpy(), want_aux[k])
    if case == "signal_2det":  # the pre-head embedding (InfoNCE surface)
        _close(port.embed(port.trainable, port.frozen, tb[0]).detach().numpy(),
               gw.embed(gw.trainable, gw.frozen, jnp.asarray(x[0])))


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_three_steps_match_gwkit(case, monkeypatch):
    monkeypatch.setitem(gw_heads.HEAD_DROPOUT, "glitch", 0.0)
    monkeypatch.setitem(heads.HEAD_DROPOUT, "glitch", 0.0)
    gw, port = _pair(case)
    start = to_gwkit_numpy(**port.trainable)
    gwt = GwTrainer(gw.loss_fn, gw.trainable, gw.frozen, GwTrainConfig(**STEP_CFG))
    pt = Trainer(port.loss_fn, port.trainable, port.frozen, TrainConfig(**STEP_CFG))
    for i in range(3):
        x = _batch(case, seed=10 + i)
        want, _ = gwt.run_epoch([tuple(jnp.asarray(b) for b in x)], jax.random.PRNGKey(i))
        got, _ = pt.run_epoch([_torch_batch(x)], torch.Generator().manual_seed(i))
        assert abs(got - want) <= 1e-5, (i, got, want)
    got, want = to_gwkit_numpy(**pt.trainable), _np(gwt.trainable)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        beyond = np.abs(a - b) > LR / 20 + 1e-4 * np.abs(b)
        assert beyond.sum() <= 1e-4 * a.size and np.abs(a - b).max() <= 3 * LR, (beyond.sum(), a.shape)
    moved = max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(start)))
    assert moved > 2 * LR
    # the trained task's search forward follows its trained trainables
    x = _batch(case, seed=20)
    _close(port.forward(torch.from_numpy(x[0])).numpy(), gw.forward(gwt.trainable, gw.frozen, jnp.asarray(x[0])))


def test_glitch_dropout_trains_and_evaluates_without():
    """The glitch head drops activations only when the trainer passes a
    generator: the same generator seed gives the same loss, another seed
    another, and no generator the dropout-free loss."""
    _, port = _pair("glitch")
    tb = _torch_batch(_batch("glitch", n=16))
    loss = lambda g: float(port.loss_fn(port.trainable, port.frozen, tb, g)[0])
    a, b = loss(torch.Generator().manual_seed(1)), loss(torch.Generator().manual_seed(1))
    assert a == b and a != loss(torch.Generator().manual_seed(2))
    plain = loss(None)
    assert plain != a
    heads_ = port.trainable["head"]
    emb = clf.encode_embedding(port.cfg, port.frozen["encoder"], port.log_mels(tb[0])[0], port.trainable["adapters"])
    torch.testing.assert_close(port.loss_fn(port.trainable, port.frozen, tb)[1]["logits"],
                               heads.mlp_head_apply(heads_, emb).detach())


def test_cnn_head_and_classifier_functions_match_gwkit():
    """The CNN head (weights carried by from_gwkit_numpy) alone and inside
    two_channel_apply, one_channel_apply, the *_from_audio forms at the full
    3000 frames, and the baseline MLP."""
    enc_cfg = GwW(**{**ENC, "max_positions": 1500})
    gw_enc = gw_tasks.init_encoder_params(jax.random.PRNGKey(1), enc_cfg)
    cnn = gw_heads.init_cnn_head(jax.random.PRNGKey(2), num_classes=3)
    port_enc = from_gwkit_numpy(encoder=_np(gw_enc))["encoder"]
    port_cnn = from_gwkit_numpy(head=_np(cnn))["head"]
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(4, 2, 128)).astype(np.float32)
    _close(heads.cnn_head_apply(port_cnn, torch.from_numpy(emb)).numpy(), gw_heads.cnn_head_apply(cnn, emb), 1e-5)
    init = heads.init_cnn_head(3, torch.Generator().manual_seed(0))
    assert [tuple(c["w"].shape) for c in init["convs"]] == [tuple(c["w"].shape) for c in cnn["convs"]]
    assert tuple(init["out"]["w"].shape) == tuple(cnn["out"]["w"].shape)

    mels = [rng.normal(size=(2, 80, 128)).astype(np.float32) for _ in range(2)]
    port_cfg = clf.ClassifierConfig(encoder=WhisperConfig(**{**ENC, "max_positions": 1500}), head="cnn",
                                    num_classes=3)
    gw_cfg = gw_clf.ClassifierConfig(encoder=enc_cfg, head="cnn", num_classes=3)
    got = clf.two_channel_apply(port_cfg, {"encoder": port_enc, "head": port_cnn}, *map(torch.from_numpy, mels))
    _close(got.numpy(), gw_clf.two_channel_apply(gw_cfg, {"encoder": gw_enc, "head": cnn}, *mels))
    assert clf.init_head(port_cfg, torch.Generator().manual_seed(0))["out"]["w"].shape == (256, 3)

    gw_head = gw_clf.init_head(jax.random.PRNGKey(3), gw_clf.ClassifierConfig(encoder=enc_cfg, head="one_channel"))
    ones = (gw_clf.ClassifierConfig(encoder=enc_cfg, head="one_channel"),
            clf.ClassifierConfig(encoder=port_cfg.encoder, head="one_channel"))
    head = from_gwkit_numpy(head=_np(gw_head))["head"]
    _close(clf.one_channel_apply(ones[1], {"encoder": port_enc, "head": head}, torch.from_numpy(mels[0])).numpy(),
           gw_clf.one_channel_apply(ones[0], {"encoder": gw_enc, "head": gw_head}, mels[0]))
    audio = [rng.normal(size=(2, 16000)).astype(np.float32) for _ in range(2)]
    _close(clf.one_channel_from_audio(ones[1], {"encoder": port_enc, "head": head}, torch.from_numpy(audio[0])).numpy(),
           gw_clf.one_channel_from_audio(ones[0], {"encoder": gw_enc, "head": gw_head}, audio[0]))
    _close(clf.two_channel_from_audio(port_cfg, {"encoder": port_enc, "head": port_cnn},
                                      *map(torch.from_numpy, audio)).numpy(),
           gw_clf.two_channel_from_audio(gw_cfg, {"encoder": gw_enc, "head": cnn}, *audio))

    small = [m[:, :, :8] for m in mels]
    base = gw_heads.init_mlp_head(jax.random.PRNGKey(4), 2 * 80 * 8, gw_heads.HEAD_WIDTHS["baseline"], 2)
    _close(clf.baseline_apply(from_gwkit_numpy(head=_np(base))["head"], *map(torch.from_numpy, small)).numpy(),
           gw_clf.baseline_apply(base, *small), 1e-5)


def test_encoder_state_dict_round_trips_and_matches_gwkit():
    from gwkit.models.hf_io import encoder_state_dict_from_params as gw_export
    from gwkit_torch.models.hf_io import encoder_params_from_state_dict, encoder_state_dict_from_params

    cfg = GwW(**ENC)
    gw_enc = _np(gw_tasks.init_encoder_params(jax.random.PRNGKey(7), cfg))
    port_enc = from_gwkit_numpy(encoder=gw_enc)["encoder"]
    state = encoder_state_dict_from_params(port_enc, WhisperConfig(**ENC))
    want = gw_export(gw_enc, cfg)
    assert set(state) == set(want)
    for k in want:
        np.testing.assert_array_equal(state[k], want[k])
    back = from_gwkit_numpy(encoder=encoder_params_from_state_dict(state, WhisperConfig(**ENC)))["encoder"]
    for a, b in zip(jax.tree.leaves(to_gwkit_numpy(encoder=back)), jax.tree.leaves(to_gwkit_numpy(encoder=port_enc))):
        np.testing.assert_array_equal(a, b)


def test_labeled_dataset_batches_and_augmentation_invariants():
    from gwkit.data.glitch import CLASS_TO_INDEX as GW_C2I
    from gwkit.data.glitch import GLITCH_CLASSES as GW_CLASSES
    from gwkit.train.datasets_util import epoch_indices as gw_epoch_indices
    from gwkit_torch.data.glitch import CLASS_TO_INDEX, GLITCH_CLASSES, LabeledDataset
    from gwkit_torch.train.datasets_util import epoch_indices

    assert GLITCH_CLASSES == GW_CLASSES and CLASS_TO_INDEX == GW_C2I
    for args in ((10, 4, 3, True, True), (10, 4, 3, True, False), (10, 4, 0, False, False)):
        for a, b in zip(epoch_indices(*args), gw_epoch_indices(*args), strict=True):
            np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(8)
    strain = rng.normal(size=(40, 200)).astype(np.float32)
    labels = rng.integers(0, 11, 40)
    plain = LabeledDataset(strain, labels, device="cpu")
    seen = np.concatenate([y.numpy() for _, y in plain.batches(torch.Generator().manual_seed(0), 8)])
    assert sorted(seen.tolist()) == sorted(labels.tolist())  # one epoch, every row once
    x0, y0 = next(plain.batches(torch.Generator().manual_seed(0), 8, shuffle=False))
    np.testing.assert_array_equal(x0.numpy(), strain[:8])
    np.testing.assert_array_equal(y0.numpy(), labels[:8])

    aug = LabeledDataset(strain, labels, augment=True, device="cpu")
    shifts, signs, amps = [], [], []
    for x, y in aug.batches(torch.Generator().manual_seed(1), 8, shuffle=False):
        start = len(shifts)  # no shuffle: the rows in order
        for j, row in enumerate(x.numpy()):
            src = strain[start + j]
            # the only (shift, factor) with row == factor * roll(src, shift)
            fits = [(s, float(row @ np.roll(src, s) / (np.roll(src, s) @ np.roll(src, s))))
                    for s in range(-20, 21)]
            s, f = max(fits, key=lambda sf: abs(sf[1]))
            np.testing.assert_allclose(row, f * np.roll(src, s), rtol=1e-5, atol=1e-5)
            shifts.append(s)
            signs.append(np.sign(f))
            amps.append(abs(f))
        np.testing.assert_array_equal(y.numpy(), labels[start:start + 8])
    assert max(abs(s) for s in shifts) <= 20 and len(set(shifts)) > 5
    assert min(amps) >= 0.7 - 1e-5 and max(amps) <= 1.4 + 1e-5
    assert set(signs) == {-1.0, 1.0}


def test_fit_callbacks_match_gwkit(tmp_path):
    """Two epochs of both trainers on the same fixed batches: each epoch the
    eval_callback sees the validation aux and its metrics reach the
    metrics_callback beside the losses; the values agree with gwkit's. A
    MetricsWriter is such a callback."""
    from gwkit_torch.utils.metrics_writer import MetricsWriter

    gw, port = _pair("signal_2det")
    train = [_batch("signal_2det", seed=30)]
    valid = [_batch("signal_2det", seed=31), _batch("signal_2det", seed=32)]
    seen = {"gw": [], "port": []}

    def callbacks(who):
        def on_eval(epoch, trainable, val_aux):
            assert isinstance(trainable, dict) and "head" in trainable and len(val_aux) == 2
            scores = np.concatenate([a["scores"] for a in val_aux])
            return {"val_mean_score": float(scores.mean()), "val_n": len(scores)}

        return on_eval, lambda epoch, metrics: seen[who].append((epoch, dict(metrics)))

    cfg = {**STEP_CFG, "epochs": 2}
    on_eval, on_metrics = callbacks("gw")
    GwTrainer(gw.loss_fn, gw.trainable, gw.frozen, GwTrainConfig(**cfg), metrics_callback=on_metrics).fit(
        lambda k: [tuple(jnp.asarray(b) for b in x) for x in train],
        lambda k: [tuple(jnp.asarray(b) for b in x) for x in valid], outdir=str(tmp_path / "gw"),
        eval_callback=on_eval)
    on_eval, on_metrics = callbacks("port")
    writer = MetricsWriter(str(tmp_path / "tb"), use_tensorboard=False)

    def both(epoch, metrics):
        on_metrics(epoch, metrics)
        writer(epoch, metrics)

    Trainer(port.loss_fn, port.trainable, port.frozen, TrainConfig(**cfg), metrics_callback=both).fit(
        lambda g: [_torch_batch(x) for x in train], lambda g: [_torch_batch(x) for x in valid],
        outdir=str(tmp_path / "port"), eval_callback=on_eval)
    writer.close()
    assert [e for e, _ in seen["port"]] == [e for e, _ in seen["gw"]] == [1, 2]
    for (_, got), (_, want) in zip(seen["port"], seen["gw"]):
        assert set(got) == set(want) == {"train_loss", "val_loss", "epoch_seconds", "val_mean_score", "val_n"}
        for k in ("train_loss", "val_loss", "val_mean_score"):
            assert abs(got[k] - want[k]) <= 1e-5, (k, got[k], want[k])
        assert got["val_n"] == want["val_n"] == 8
    rows = [ln.split("\t") for ln in open(tmp_path / "tb" / "scalars.tsv").read().splitlines()]
    assert [(r[0], r[1]) for r in rows[:5]] == [("1", k) for k in seen["port"][0][1]]
    assert abs(float(rows[0][2]) - seen["port"][0][1]["train_loss"]) < 1e-12


def test_whisper_switches_match_gwkit(monkeypatch):
    """use_flash_attention (T >= 1024) and fused_mlp on the unfused layer:
    gwkit's Pallas kernels in interpret mode against the port's plain
    versions on the CPU, forward and gradients."""
    import gwkit.ops.attention as gw_attention
    import gwkit.ops.fused_mlp as gw_fused_mlp
    from gwkit.models.whisper import encoder_apply as gw_encoder_apply
    from gwkit.models.whisper import init_encoder_params as gw_init
    from gwkit_torch.models.whisper import encoder_apply
    from gwkit_torch.ops import _cuda

    monkeypatch.setattr(gw_attention, "flash_attention",
                        functools.partial(gw_attention.flash_attention, interpret=True))
    monkeypatch.setattr(gw_fused_mlp, "fused_mlp_block",
                        functools.partial(gw_fused_mlp.fused_mlp_block, interpret=True))
    sw = dict(d_model=128, n_heads=2, n_layers=1, d_ff=256, max_positions=1024,
              use_flash_attention=True, fused_mlp=True)
    gw_enc = gw_init(jax.random.PRNGKey(9), GwW(**sw))
    port_enc = from_gwkit_numpy(encoder=_np(gw_enc))["encoder"]
    mel = np.random.default_rng(9).normal(size=(1, 80, 2048)).astype(np.float32)
    want = gw_encoder_apply(GwW(**sw), gw_enc, jnp.asarray(mel))
    _cuda.reset_counts()
    got = encoder_apply(WhisperConfig(**sw), port_enc, torch.from_numpy(mel))
    assert got.shape == (1, 1024, 128)
    assert _cuda.PLAIN_CALLS == {"attention": 1, "fused_mlp": 1}  # both switches took their kernels' route
    _close(got.detach().numpy(), want)
    # gradients of a scalar of the output reach the weights through both routes
    w = np.random.default_rng(10).normal(size=(1, 1024, 128)).astype(np.float32)
    gw_g = jax.grad(lambda p: jnp.sum(gw_encoder_apply(GwW(**sw), p, jnp.asarray(mel)) * w))(gw_enc)
    leaves = [port_enc["layers"][0]["q"]["w"], port_enc["layers"][0]["fc1"]["w"]]
    for t in leaves:
        t.requires_grad_(True)
    g = torch.autograd.grad((encoder_apply(WhisperConfig(**sw), port_enc, torch.from_numpy(mel))
                             * torch.from_numpy(w)).sum(), leaves)
    _close(g[0].numpy(), np.asarray(gw_g["layers"]["q"]["w"][0]), 1e-4)
    _close(g[1].numpy(), np.asarray(gw_g["layers"]["fc1"]["w"][0]), 1e-4)
