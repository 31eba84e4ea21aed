"""Port parity for the training slice: losses, the optimizer against optax,
the injection dataset, three Trainer steps of a tiny MLGWSC-1 model against
gwkit's Trainer (fused and unfused layers), checkpoints and exported
components crossing between the packages, one InfoNCE pretraining step, and
the training CLI on a tiny HDF5 dataset.

Tolerances (f32 on the CPU): losses 1e-5 absolute; the optimizer 1e-6;
parameters after three Adam steps rtol 1e-4 with atol lr/20, because Adam
moves every element by about the learning rate whatever its gradient's
size, so an element whose gradient nearly cancels (a dead ReLU's neighbour
in the head) may take a few per cent of a step more or less in one package.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gwkit.models.adapters import AdapterConfig as GwAdapterConfig
from gwkit.models.qadapter import QAdapterConfig as GwQ
from gwkit.models.whisper import WhisperConfig as GwW
from gwkit.train import losses as gw_losses
from gwkit.train.tasks import build_mlgwsc as gw_build
from gwkit.train.trainer import TrainConfig as GwTrainConfig
from gwkit.train.trainer import Trainer as GwTrainer
from gwkit.train.trainer import make_optimizer as gw_make_optimizer
from gwkit_torch.io import from_gwkit_numpy, to_gwkit_numpy, tree_leaves, tree_unflatten
from gwkit_torch.models.adapters import AdapterConfig
from gwkit_torch.models.qadapter import QAdapterConfig
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.train import losses
from gwkit_torch.train.tasks import build_mlgwsc
from gwkit_torch.train.trainer import TrainConfig, Trainer, make_optimizer

CAP = os.path.join(os.path.dirname(__file__), "..", "artifacts", "capstone_r5")
GEO = dict(spectrogram_shape=(32, 32), target_shape=(80, 64), channels=(4, 8, 8), median_stride=8)
ENC = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256, max_positions=32)
LR = 3e-4
STEP_CFG = dict(learning_rate=LR, clip_norm=100.0, epochs=1, batch_size=4, optimizer="adam")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reg_bce", "bce_with_logits", "cross_entropy", "info_nce"])
def test_losses_match_gwkit(name):
    rng = np.random.default_rng(0)
    if name == "reg_bce":
        p = rng.uniform(0.01, 0.99, size=(8, 2)).astype(np.float32)
        args = (p / p.sum(-1, keepdims=True), np.eye(2, dtype=np.float32)[rng.integers(0, 2, 8)])
    elif name == "bce_with_logits":
        args = (rng.normal(size=(16, 1)).astype(np.float32), rng.integers(0, 2, 16).astype(np.float32))
    elif name == "cross_entropy":
        args = (rng.normal(size=(16, 11)).astype(np.float32), rng.integers(0, 11, 16))
    else:
        args = (rng.normal(size=(8, 16)).astype(np.float32), rng.normal(size=(8, 16)).astype(np.float32))
    got = float(getattr(losses, name)(*(torch.from_numpy(a) for a in args)))
    want = float(getattr(gw_losses, name)(*(jnp.asarray(a) for a in args)))
    assert abs(got - want) <= 1e-5 * max(1.0, abs(want))


# --------------------------------------------------------------------------
# the optimizer against optax
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "adamw", "cosine"])
def test_optimizer_matches_optax(kind):
    """Five steps on the same gradients, the third with ||g|| = 500 > clip
    100: parameters and the state in optax's layout agree within 1e-6."""
    cfg = dict(learning_rate=1e-2, clip_norm=100.0, optimizer="adamw" if kind == "adamw" else "adam",
               weight_decay=0.05)
    if kind == "cosine":
        cfg.update(lr_schedule="cosine", total_steps=8, warmup_steps=2)
    rng = np.random.default_rng(1)
    params = {"b": rng.normal(size=(4,)).astype(np.float32), "w": rng.normal(size=(3, 4)).astype(np.float32)}
    grads = []
    for i in range(5):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
        if i == 2:
            norm = np.sqrt(sum((x.astype(np.float64) ** 2).sum() for x in g.values()))
            g = {k: (v * (500.0 / norm)).astype(np.float32) for k, v in g.items()}
        grads.append(g)
    opt = gw_make_optimizer(GwTrainConfig(**cfg))
    gw_p = jax.tree.map(jnp.asarray, params)
    state = opt.init(gw_p)
    for g in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, g), state, gw_p)
        gw_p = optax.apply_updates(gw_p, updates)
    port = make_optimizer(TrainConfig(**cfg))
    tp = {"head": [{k: torch.from_numpy(v.copy()) for k, v in params.items()}]}
    leaves = tree_leaves(tp)
    pstate = port.init(leaves)
    for g in grads:
        pstate = port.update(leaves, [torch.from_numpy(g[k]) for k in sorted(g)], pstate)
    np.testing.assert_allclose(tp["head"][0]["w"].numpy(), np.asarray(gw_p["w"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tp["head"][0]["b"].numpy(), np.asarray(gw_p["b"]), rtol=0, atol=1e-6)
    got_state = tree_leaves(port.state_to_gwkit(pstate, tp))
    want_state = jax.tree.leaves(state)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=1e-6, atol=1e-9)


# --------------------------------------------------------------------------
# the dataset
# --------------------------------------------------------------------------

def test_injection_dataset_mixing_semantics():
    from gwkit_torch.data.datasets import InjectionDataset

    rng = np.random.default_rng(0)
    noises = rng.normal(size=(10, 2, 64)).astype(np.float32)
    ds = InjectionDataset(noises=noises, waveforms=np.ones((4, 2, 64), np.float32), snr_range=(3.0, 3.0),
                          device="cpu")
    x, y, snr = ds.sample_batch(torch.Generator().manual_seed(0), torch.arange(10))
    np.testing.assert_allclose(x[:4].numpy(), noises[:4] + 3.0, rtol=1e-6)
    np.testing.assert_array_equal(x[4:].numpy(), noises[4:])
    np.testing.assert_array_equal(y.numpy(), [[1, 0]] * 4 + [[0, 1]] * 6)
    np.testing.assert_array_equal(snr.numpy(), [3.0] * 4 + [0.0] * 6)
    # U(lo, hi) draws, and the last batch wrap-padded
    ds.snrs(5.0, 15.0)
    batches = list(ds.batches(torch.Generator().manual_seed(1), 4, shuffle=False, drop_remainder=False))
    assert len(batches) == 3 and batches[-1][0].shape == (4, 2, 64)
    np.testing.assert_array_equal(batches[-1][0].numpy(), noises[[8, 9, 8, 9]])  # rows 8, 9, wrapped
    s = batches[0][2].numpy()
    assert ((s >= 5.0) & (s <= 15.0)).all() and len(set(s.tolist())) == 4
    # noise-only
    pure = InjectionDataset(noises=noises[:8], waveforms=np.zeros((0, 2, 64), np.float32), device="cpu")
    (x, y, snr), = list(pure.batches(torch.Generator().manual_seed(0), 8, shuffle=False))
    np.testing.assert_array_equal(x.numpy(), noises[:8])
    np.testing.assert_array_equal(y.numpy(), [[0, 1]] * 8)
    assert (snr.numpy() == 0).all()


def test_concat_keeps_injections_first(tmp_path):
    import h5py

    from gwkit.data.datasets import InjectionDataset as GwDataset
    from gwkit_torch.data.datasets import load_concat_datasets

    rng = np.random.default_rng(2)
    paths = []
    for i in range(2):
        path = str(tmp_path / f"d{i}.hdf")
        with h5py.File(path, "w") as f:
            for group, n in (("training", 6), ("validation", 4)):
                GwDataset(noises=rng.normal(size=(n, 2, 32)).astype(np.float32),
                          waveforms=rng.normal(size=(n // 2, 2, 32)).astype(np.float32)).save(f, group)
        paths.append(path)
    from gwkit.data.datasets import load_concat_datasets as gw_load

    got, want = load_concat_datasets(paths, device="cpu"), gw_load(paths)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.noises.numpy(), np.asarray(b.noises))
        np.testing.assert_array_equal(a.waveforms.numpy(), np.asarray(b.waveforms))


# --------------------------------------------------------------------------
# a tiny MLGWSC-1 model trained by both packages
# --------------------------------------------------------------------------

def _tasks(fused):
    gw_task = gw_build(jax.random.PRNGKey(0), encoder=GwW(**ENC, fused_block=fused), qcfg=GwQ(**GEO),
                       acfg=GwAdapterConfig(r=4, alpha=8, use_dora=True, targets="qkvo"))
    gw_task.trainable["adapters"] = jax.tree.map(  # non-zero B: the low-rank path counts
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07,
        gw_task.trainable["adapters"])
    params = from_gwkit_numpy(encoder=_np(gw_task.frozen["encoder"]), **_np(gw_task.trainable))
    task = build_mlgwsc(WhisperConfig(**ENC, fused_block=fused), QAdapterConfig(**GEO), params,
                        usr=False, device="cpu", acfg=AdapterConfig(r=4, alpha=8))
    return gw_task, task


def _batches(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(4, 2, 2048)).astype(np.float32),
             np.eye(2, dtype=np.float32)[rng.integers(0, 2, 4)]) for _ in range(n)]


def _assert_trainables_close(gw_tree, port_tree, **tol):
    want = _np(gw_tree)
    got = to_gwkit_numpy(**port_tree)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(a, b, **tol)


@pytest.fixture(scope="module", params=[False, True], ids=["unfused", "fused"])
def trained(request):
    """Both packages' trainers after the same three steps on the same
    batches, from the same weights, with the per-step losses."""
    gw_task, task = _tasks(request.param)
    start = to_gwkit_numpy(**task.trainable)
    gwt = GwTrainer(gw_task.loss_fn, gw_task.trainable, gw_task.frozen, GwTrainConfig(**STEP_CFG))
    pt = Trainer(task.loss_fn, task.trainable, task.frozen, TrainConfig(**STEP_CFG))
    losses_ = []
    for i, (x, y) in enumerate(_batches()):
        want, _ = gwt.run_epoch([(jnp.asarray(x), jnp.asarray(y))], jax.random.PRNGKey(i))
        got, aux = pt.run_epoch([(torch.from_numpy(x), torch.from_numpy(y))])
        assert aux[0]["scores"].shape == (4,)
        losses_.append((got, want))
    return dict(gw_task=gw_task, gwt=gwt, task=task, pt=pt, start=start, losses=losses_,
                fused=request.param)


def test_trainer_three_steps_match_gwkit(trained):
    for i, (got, want) in enumerate(trained["losses"]):
        assert abs(got - want) <= 1e-5, (i, got, want)
    pt = trained["pt"]
    _assert_trainables_close(trained["gwt"].trainable, pt.trainable, rtol=1e-4, atol=LR / 20)
    moved = max(np.abs(a - b).max() for a, b in zip(jax.tree.leaves(to_gwkit_numpy(**pt.trainable)),
                                                     jax.tree.leaves(trained["start"])))
    assert moved > 2 * LR  # three steps moved the parameters far beyond the tolerance


def test_checkpoints_cross_between_packages(trained, tmp_path):
    from gwkit.train.checkpoints import CheckpointManager as GwManager
    from gwkit_torch.train.checkpoints import CheckpointManager

    gwt, pt = trained["gwt"], trained["pt"]
    # port -> gwkit: gwkit's resume reads the port's last.ckpt and best.npz
    CheckpointManager(str(tmp_path / "p"), pt.optimizer).save_epoch(3, 0.5, pt.trainable, pt.opt_state, True)
    epoch, best, tr, state = GwManager(str(tmp_path / "p")).resume("latest", gwt.trainable, gwt.opt_state)
    assert (epoch, best) == (4, 0.5)
    _assert_trainables_close(tr, pt.trainable, rtol=0, atol=0)
    want = tree_leaves(pt.optimizer.state_to_gwkit(pt.opt_state, pt.trainable))
    for a, b in zip(jax.tree.leaves(state), want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    _, _, best_tr, _ = GwManager(str(tmp_path / "p")).resume("best", gwt.trainable, gwt.opt_state)
    _assert_trainables_close(best_tr, pt.trainable, rtol=0, atol=0)
    # gwkit -> port
    GwManager(str(tmp_path / "g")).save_epoch(5, 0.25, gwt.trainable, gwt.opt_state, False)
    epoch, best, tr, state = CheckpointManager(str(tmp_path / "g"), pt.optimizer).resume(
        "latest", pt.trainable, pt.opt_state)
    assert (epoch, best) == (6, 0.25) and state.count == 3
    _assert_trainables_close(gwt.trainable, tr, rtol=0, atol=0)
    for a, b in zip(jax.tree.leaves(gwt.opt_state), tree_leaves(pt.optimizer.state_to_gwkit(state, tr))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fit_writes_losses_checkpoints_and_resumes(tmp_path):
    _, task = _tasks(False)
    pt = Trainer(task.loss_fn, task.trainable, task.frozen,
                 TrainConfig(**{**STEP_CFG, "epochs": 2}), export_components=task.export_components)
    data = [(torch.from_numpy(x), torch.from_numpy(y)) for x, y in _batches(2, seed=5)]
    out = str(tmp_path / "run")
    pt.fit(lambda g: data[:1], lambda g: data[1:], outdir=out)
    lines = open(os.path.join(out, "losses.txt")).read().splitlines()
    assert [ln.split("\t")[0] for ln in lines] == ["0001", "0002"]
    assert all(len(ln.split("\t")[2]) == len("0.000000") for ln in lines)
    for name in ("last.ckpt", "state_e_0001.npz", "state_e_0002.npz", "best.npz", "train_config.json",
                 "best_dense_layers.npz", "best_adapter.npz", "best_lora_weights/adapter_model.safetensors"):
        assert os.path.isfile(os.path.join(out, name)), name
    with pytest.raises(RuntimeError, match="exists"):
        pt.fit(lambda g: data[:1], lambda g: data[1:], outdir=out)
    pt2 = Trainer(task.loss_fn, task.trainable, task.frozen, TrainConfig(**{**STEP_CFG, "epochs": 3}))
    pt2.fit(lambda g: data[:1], lambda g: data[1:], outdir=out, resume="latest")
    assert pt2.opt_state.count == 3
    assert open(os.path.join(out, "losses.txt")).read().splitlines()[-1].startswith("0003")


def test_full_finetune_trains_the_encoder_without_adapters():
    """full_finetune moves the encoder into the trainable tree and drops the
    adapters, as gwkit's build_mlgwsc does; a step changes the encoder."""
    gw_task, task = _tasks(False)
    gw_ft = gw_build(jax.random.PRNGKey(0), encoder=GwW(**ENC), qcfg=GwQ(**GEO), full_finetune=True)
    ft = build_mlgwsc(WhisperConfig(**ENC), QAdapterConfig(**GEO), task.params, usr=False, device="cpu",
                      full_finetune=True)
    assert sorted(ft.trainable) == sorted(gw_ft.trainable) == ["encoder", "head", "qadapter"]
    assert ft.frozen == {} and gw_ft.frozen == {}
    before = ft.trainable["encoder"]["layers"][0]["fc1"]["w"].clone()
    (x, y), = _batches(1, seed=8)
    Trainer(ft.loss_fn, ft.trainable, ft.frozen, TrainConfig(**STEP_CFG)).run_epoch(
        [(torch.from_numpy(x), torch.from_numpy(y))])
    assert not torch.equal(before, ft.trainable["encoder"]["layers"][0]["fc1"]["w"])


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_score_follows_the_trained_adapters(fused):
    """The search forward prepares its encoder from the adapters as they
    are (the fused layers fold them into copies): a train step (in-place
    updates) between two scores changes the scores to those of a task
    built fresh from the trained parameters."""
    _, task = _tasks(fused)
    (x, y), = _batches(1, seed=9)
    x, y = torch.from_numpy(x), torch.from_numpy(y)
    before = task.score(x)
    encoder = task._encoder
    assert torch.equal(task.score(x), before) and task._encoder is encoder  # unchanged: not prepared again
    Trainer(task.loss_fn, task.trainable, task.frozen, TrainConfig(**STEP_CFG)).run_epoch([(x, y)])
    after = task.score(x)
    assert not torch.equal(after, before)
    fresh = build_mlgwsc(task.cfg.encoder, task.qcfg, {k: tree_unflatten(v, [t.detach().clone() for t in
                                                                             tree_leaves(v)])
                                                        for k, v in task.params.items()},
                         usr=False, device="cpu", acfg=task.acfg)
    torch.testing.assert_close(after, fresh.score(x), rtol=0, atol=0)


def test_head_dropout_matches_gwkit_semantics():
    """Dropout after each hidden ReLU, survivors scaled by 1/(1 - rate); no
    generator is inference mode. Draws differ from gwkit's, so the test
    holds the semantics on a fixed mask."""
    from gwkit_torch.models.heads import init_mlp_head, mlp_head_apply

    head = init_mlp_head(16, (256,), 3, torch.Generator().manual_seed(0))
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(1))
    plain = mlp_head_apply(head, x)
    torch.testing.assert_close(mlp_head_apply(head, x, dropout_rate=0.3), plain)
    gen = torch.Generator().manual_seed(2)
    got = mlp_head_apply(head, x, dropout_rate=0.3, generator=gen)
    keep = torch.rand((64, 256), generator=torch.Generator().manual_seed(2)) < 0.7
    h = torch.relu(x @ head[0]["w"] + head[0]["b"])
    want = torch.where(keep, h / 0.7, torch.zeros_like(h)) @ head[1]["w"] + head[1]["b"]
    torch.testing.assert_close(got, want)


def test_exported_components_load_in_both_packages(tmp_path):
    """A full-width Whisper-tiny task (the capstone encoder, fresh trainables
    with non-zero B) exports its components. gwkit's
    load_task_from_components reads back exactly the exported arrays; the
    port's scores the same windows as the task itself."""
    from gwkit.cli.inference import load_task_from_components as gw_load
    from gwkit_torch.cli.inference import load_task_from_components
    from gwkit_torch.models.whisper import config_for

    enc = f"{CAP}/encoder_pretrained.npz"
    task = load_task_from_components(f"{CAP}/run/best_lora_weights", f"{CAP}/run/best_dense_layers.npz",
                                     f"{CAP}/run/best_adapter.npz", pretrained_encoder=enc,
                                     target_shape=(80, 64), device="cpu")
    fresh = build_mlgwsc(config_for("tiny", max_positions=32), QAdapterConfig(target_shape=(80, 64)),
                         {"encoder": task.frozen["encoder"]}, usr=True, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for layer in fresh.trainable["adapters"]:
            for entry in layer.values():
                entry["b"].normal_(0, 0.02, generator=gen)
    fresh.export_components(str(tmp_path), fresh.trainable)
    files = [str(tmp_path / n) for n in ("best_lora_weights", "best_dense_layers.npz", "best_adapter.npz")]
    gw = gw_load(*files, pretrained_encoder=enc, target_shape=(80, 64))
    want = to_gwkit_numpy(**fresh.trainable)
    for key in ("adapters", "head", "qadapter"):
        got = _np(gw.trainable[key])
        assert jax.tree.structure(got) == jax.tree.structure(want[key])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want[key])):
            np.testing.assert_array_equal(a, b)
    strain = np.random.default_rng(0).normal(size=(3, 2, 2048)).astype(np.float32)
    port = load_task_from_components(*files, pretrained_encoder=enc, target_shape=(80, 64), device="cpu")
    np.testing.assert_allclose(port.score(torch.from_numpy(strain)).numpy(),
                               fresh.score(torch.from_numpy(strain)).numpy(), rtol=1e-5, atol=1e-6)


def test_one_infonce_pretrain_step_matches_gwkit(tmp_path):
    from gwkit.train.pretrain import ContrastivePretrainer as GwPretrainer
    from gwkit_torch.train.pretrain import ContrastivePretrainer

    gw_task, task = _tasks(False)
    gwp = GwPretrainer(gw_task, proj_dim=32, lr=1e-3, seed=0)
    pp = ContrastivePretrainer(task, proj_dim=32, lr=1e-3, seed=0)
    pp.trainable["proj"] = from_gwkit_numpy(proj=_np(gwp.trainable["proj"]))["proj"]
    pp._set_params()
    rng = np.random.default_rng(6)
    x1, x2 = (rng.normal(size=(4, 2, 2048)).astype(np.float32) for _ in range(2))
    j1, j2 = jnp.asarray(x1), jnp.asarray(x2)
    # the gradients of the loss gwkit's step differentiates
    # (gwkit/train/pretrain.py:68-71), leaf by leaf
    from gwkit.models.heads import mlp_head_apply as gw_head

    def gw_loss(tr):
        z1 = gw_head(tr["proj"], gw_task.embed(tr, gwp.frozen, j1))
        z2 = gw_head(tr["proj"], gw_task.embed(tr, gwp.frozen, j2))
        return gw_losses.info_nce(z1, z2, temperature=0.1)

    want_g = to_gwkit_numpy(**from_gwkit_numpy(**_np(jax.jit(jax.grad(gw_loss))(gwp.trainable))))
    got_g = torch.autograd.grad(pp.loss(pp.trainable, torch.from_numpy(x1), torch.from_numpy(x2)), pp.params)
    got_g = to_gwkit_numpy(**tree_unflatten(pp.trainable, got_g))
    # InfoNCE over a random tiny model is nearly flat: its gradient (at most
    # ~1e-3 here) is the remainder of cancelling terms of order one, so the
    # two forwards' f32 differences reach it at ~1e-3 of its size. The
    # gradient vector is held to 1% of its norm, leaf by leaf
    for a, b in zip(jax.tree.leaves(got_g), jax.tree.leaves(want_g)):
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b)
    # one step each: the same loss, and the same loss after the step. The
    # parameters agree to rtol 1e-4 except where a gradient is at rounding
    # level: the first Adam step moves an element by lr * g / (|g| + 1e-8),
    # so such an element may move by up to lr more or less
    tr, state, want = gwp._step(gwp.trainable, gwp.opt_state, j1, j2)
    got = pp.step(torch.from_numpy(x1), torch.from_numpy(x2))
    assert abs(float(got) - float(want)) <= 1e-5
    _assert_trainables_close(tr, pp.trainable, rtol=1e-4, atol=1e-3)
    _, _, want2 = gwp._step(tr, state, j1, j2)
    assert abs(float(pp.step(torch.from_numpy(x1), torch.from_numpy(x2))) - float(want2)) <= 1e-5
    pp.train(x1, x1[:2], steps=1, batch_size=2, outdir=str(tmp_path))
    assert {"q_adapter_pretrained.npz", "adapters_pretrained.npz"} <= set(os.listdir(tmp_path))


def test_train_cli_on_a_gwkit_hdf5_dataset(tmp_path):
    """python -m gwkit_torch.cli.train_mlgwsc --cpu on a tiny dataset that
    gwkit's InjectionDataset.save wrote; the exports load back and score."""
    import h5py

    from gwkit.data.datasets import InjectionDataset as GwDataset
    from gwkit_torch.cli import train_mlgwsc
    from gwkit_torch.cli.inference import load_task_from_components

    rng = np.random.default_rng(7)
    os.makedirs(tmp_path / "data")
    with h5py.File(tmp_path / "data" / "ds.hdf", "w") as f:
        for group, n in (("training", 8), ("validation", 4)):
            GwDataset(noises=rng.normal(size=(n, 2, 2048)).astype(np.float32),
                      waveforms=rng.normal(size=(n // 2, 2, 2048)).astype(np.float32)).save(f, group)
    out = str(tmp_path / "run")
    enc = f"{CAP}/encoder_pretrained.npz"
    train_mlgwsc.main(["-d", str(tmp_path / "data"), "-o", out, "--cpu", "--epochs", "1", "--batch-size", "4",
                       "--target-shape", "80", "64", "--spectrogram-shape", "32", "32",
                       "--pretrained-encoder", enc, "--learning-rate", "3e-4"])
    assert open(os.path.join(out, "losses.txt")).read().startswith("0001\t")
    assert os.path.isfile(os.path.join(out, "config.json"))
    task = load_task_from_components(*(os.path.join(out, n) for n in ("best_lora_weights", "best_dense_layers.npz",
                                                                      "best_adapter.npz")),
                                     pretrained_encoder=enc, target_shape=(80, 64), device="cpu")
    assert np.isfinite(task.score(torch.from_numpy(rng.normal(size=(2, 2, 2048)).astype(np.float32))).numpy()).all()
