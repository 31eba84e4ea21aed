"""The port's parallel layer (``gwkit_torch.parallel``) against gwkit's
(``tests/test_parallel.py``): the sharding rules leaf for leaf against
gwkit's PartitionSpecs and device shards on the 8 virtual devices of
``tests/conftest.py``; a forward over 2 gloo processes with n_model=2
(unfused, and the fused chain's plain versions with the weights gathered
at its boundary) and the window-sharded search over 2 data ranks, against
gwkit's single-device results at gwkit's tolerances; ``Trainer(mesh=)``
over 4 gloo processes as 2x2 for two epochs against the port's unmeshed
trainer (1e-5) and gwkit's (gwkit's own rtol 2e-3, atol 2e-4); trigger
shards written by one package and merged by the other; and a two-process
``get_triggers`` on one HDF5 file against the single-process search; and,
with CUDA faked, that each CLI under torchrun sets its card to LOCAL_RANK
before it reads or places anything.

Every spawned process gets a free port and a wall limit of 120 s after
which it is killed, so a hang cannot eat the suite's time. Widths are
tiny (gwkit's ``ENC``: d 64, 2 heads, 2 layers) and nothing drops out.
"""
import os
import socket
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.models.adapters import AdapterConfig as GwAdapterConfig
from gwkit.models.whisper import WhisperConfig as GwW
from gwkit.parallel import distributed as gw_dist
from gwkit.parallel import mesh as gw_mesh
from gwkit.train import tasks as gw_tasks
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.models.adapters import AdapterConfig
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.parallel import distributed as pt_dist
from gwkit_torch.parallel import mesh as pt_mesh
from gwkit_torch.train import tasks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENC = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=64)
ACFG = dict(r=2, alpha=4, use_dora=True, targets="qkvo")
LIMIT_S = 120

_HEADER = f"""
import os, sys
sys.path.insert(0, {ROOT!r})
import numpy as np
import torch
torch.set_num_threads(1)
from gwkit_torch.parallel.distributed import initialize
from gwkit_torch.parallel.mesh import active, make_mesh
rank, world, port, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
initialize(f"127.0.0.1:{{port}}", world, rank, device="cpu")
"""

_TINY_TASK = """
from gwkit_torch.models.adapters import AdapterConfig
from gwkit_torch.models.whisper import WhisperConfig
from gwkit_torch.train.tasks import build_signal_vs_noise

def tiny_task(**enc):
    params = torch.load(os.path.join(tmp, "params.pt"))
    return build_signal_vs_noise(WhisperConfig(**ENC, **enc), params, acfg=AdapterConfig(**ACFG),
                                 input_sample_rate=256, n_frames=128, device="cpu")
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(tmp_path, world: int, body: str) -> None:
    """Run ``body`` in ``world`` gloo processes; each is killed after LIMIT_S."""
    child = tmp_path / "child.py"
    child.write_text(_HEADER + f"ENC, ACFG = {ENC!r}, {ACFG!r}\n" + _TINY_TASK + textwrap.dedent(body))
    port = _free_port()
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, str(child), str(r), str(world), str(port), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
             for r in range(world)]
    deadline = time.time() + LIMIT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(outs)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _gw_tiny_task(**enc):
    """gwkit's tiny task (tests/test_parallel.py) with a non-zero LoRA B, so
    the low-rank path and DoRA's norms count."""
    task = gw_tasks.build_signal_vs_noise(jax.random.PRNGKey(0), encoder=GwW(**ENC, **enc),
                                          acfg=GwAdapterConfig(**ACFG), input_sample_rate=256, n_frames=128)
    task.trainable["adapters"] = jax.tree.map(
        lambda a: a + 0.01 * (np.arange(a.size, dtype=np.float32).reshape(a.shape) % 7), task.trainable["adapters"])
    return task


def _save_params(tmp_path, gw):
    params = from_gwkit_numpy(**{"encoder": _np(gw.frozen["encoder"]), **_np(gw.trainable)})
    torch.save(params, tmp_path / "params.pt")
    return params


# ---------------------------------------------------------------------------
# The sharding rules
# ---------------------------------------------------------------------------

def _spec_of(named_sharding, ndim):
    spec = tuple(named_sharding.spec)
    return spec + (None,) * (ndim - len(spec))


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharding_rules_match_gwkit_leaf_for_leaf():
    """Every leaf of a task's frozen and trainable trees: the port's spec is
    gwkit's (its stacked layer axis dropped), and each of the 8 ranks of a
    4x2 mesh holds exactly gwkit's shard for that device."""
    gw = _gw_tiny_task()
    params = from_gwkit_numpy(**{"encoder": _np(gw.frozen["encoder"]), **_np(gw.trainable)})
    mesh = gw_mesh.make_mesh(n_model=2)
    gw_trees = {"encoder": (gw.frozen["encoder"], gw_mesh.encoder_sharding(mesh)),
                "adapters": (gw.trainable["adapters"], gw_mesh.adapter_sharding(mesh, gw.trainable["adapters"])),
                "head": (gw.trainable["head"], gw_mesh.replicated(mesh, gw.trainable["head"]))}
    pt_specs = {"encoder": pt_mesh.encoder_sharding(params["encoder"]),
                "adapters": pt_mesh.adapter_sharding(params["adapters"]),
                "head": pt_mesh.replicated(params["head"])}
    assert pt_mesh.task_shardings({"encoder": params["encoder"]})["encoder"] == pt_specs["encoder"]
    assert pt_mesh.task_shardings({k: params[k] for k in ("adapters", "head")}) == \
        {k: pt_specs[k] for k in ("adapters", "head")}
    devices = np.asarray(mesh.devices).reshape(-1)
    n_checked = 0
    for name, (gw_tree, gw_spec_tree) in gw_trees.items():
        placed = jax.device_put(gw_tree, gw_spec_tree)
        gw_leaves = jax.tree_util.tree_flatten_with_path(placed)[0]
        gw_specs = jax.tree.leaves(gw_spec_tree, is_leaf=lambda x: hasattr(x, "spec"))
        for (path, arr), ns in zip(gw_leaves, gw_specs):
            keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
            stacked = name in ("encoder", "adapters") and (name == "adapters" or keys[0] == "layers")
            layers = range(arr.shape[0]) if stacked else [None]
            want = _spec_of(ns, arr.ndim)
            for li in layers:
                node, spec = params[name], pt_specs[name]
                if name == "adapters":
                    node, spec = node[li], spec[li]
                elif stacked:
                    node, spec = node["layers"][li], spec["layers"][li]
                for k in (keys if name != "encoder" or not stacked else keys[1:]):
                    node, spec = node[k], spec[k]
                assert tuple(spec) == (want[1:] if stacked else want), (name, keys)
                for r, dev in enumerate(devices):
                    local = pt_mesh.shard_leaf(pt_mesh.Mesh(4, 2, r, torch.device("cpu")), node, spec)
                    shard = np.asarray([s.data for s in arr.addressable_shards if s.device == dev][0])
                    np.testing.assert_array_equal(local.numpy(), shard[li] if stacked else shard)
                n_checked += 1
    assert n_checked > 60


def test_make_mesh_without_process_group_is_one_by_one():
    mesh = pt_mesh.make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank, mesh.data_group, mesh.model_group) == ((1, 1), 0, None, None)
    with pytest.raises(ValueError, match="not divisible by model parallelism 2"):
        pt_mesh.make_mesh(n_model=2, device="cpu")
    x = torch.arange(6.0).reshape(3, 2)
    assert pt_mesh.gather_rows(x, mesh) is x and pt_mesh.data_mean_(x, mesh) is x
    assert pt_mesh.shard_leaf(mesh, x, (None, pt_mesh.MODEL_AXIS)) is x
    assert pt_dist.process_count() == 1 and pt_dist.process_index() == 0
    assert pt_dist.gather_trigger_lists({"s": [[1.0, 2.0]]}) == {"s": [[1.0, 2.0]]}


# ---------------------------------------------------------------------------
# Forward and search over gloo processes
# ---------------------------------------------------------------------------

def test_sharded_forward_matches_gwkit_single_device(tmp_path):
    """n_model=2 over 2 processes: the unfused layer as Megatron tensor
    parallelism (each rank one head and half of fc1; o and fc2 reduced, o's
    DoRA norms reduced before the square root), the fused chain's plain
    versions on weights gathered at the kernel boundary, and the unfused
    layer with gwkit's fused_mlp switch (kernel C's plain version on the
    gathered MLP weights), against gwkit's
    single-device forward at its rtol 1e-4, atol 1e-5. The unfused forward's
    input gradient and adapter gradients match the unsharded port's."""
    gw = _gw_tiny_task()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(8, 2, 256)).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    want = np.asarray(gw.forward(gw.trainable, gw.frozen, jnp.asarray(x)))
    _save_params(tmp_path, gw)
    _spawn(tmp_path, 2, """
        from gwkit_torch.io import tree_leaves
        from gwkit_torch.parallel.mesh import shard_task_tree
        mesh = make_mesh(n_model=2, device="cpu")
        x = torch.from_numpy(np.load(os.path.join(tmp, "x.npy")))
        out = {}
        for name, enc in (("unfused", {}), ("fused", {"fused_block": True}), ("fused_mlp", {"fused_mlp": True})):
            calls = dict(mesh.calls)
            task = tiny_task(**enc)
            tr, fr = shard_task_tree(mesh, task.trainable), shard_task_tree(mesh, task.frozen)
            assert fr["encoder"]["layers"][0]["q"]["w"].shape == (64, 32)
            assert tr["adapters"][0]["o"]["a"].shape == (32, 2)
            xs = x.clone().requires_grad_(name == "unfused")
            for t in tree_leaves(tr):
                t.requires_grad_(True)
            with active(mesh):
                y = task.apply(tr, fr, xs)
            out[name] = y.detach().numpy()
            if name == "unfused":
                grads = torch.autograd.grad(y.sum(), [xs, tr["adapters"][1]["q"]["a"],
                                                      tr["adapters"][1]["o"]["b"], tr["adapters"][1]["o"]["m"]])
                for i, g in enumerate(grads):
                    out[f"grad{i}"] = g.numpy()
            out[name + "_calls"] = [mesh.calls[k] - calls.get(k, 0) for k in ("all_reduce/model", "all_gather/model")]
        np.savez(os.path.join(tmp, f"out_{rank}.npz"), **out)
    """)
    port = tasks.build_signal_vs_noise(WhisperConfig(**ENC), torch.load(tmp_path / "params.pt"),
                                       acfg=AdapterConfig(**ACFG), input_sample_rate=256, n_frames=128,
                                       device="cpu")
    xs = torch.from_numpy(x).requires_grad_(True)
    leaves = [port.trainable["adapters"][1]["q"]["a"], port.trainable["adapters"][1]["o"]["b"],
              port.trainable["adapters"][1]["o"]["m"]]
    for t in leaves:
        t.requires_grad_(True)
    ref_grads = torch.autograd.grad(port.apply(port.trainable, port.frozen, xs).sum(), [xs, *leaves])
    specs = pt_mesh.task_shardings({"encoder": port.frozen["encoder"], "adapters": port.trainable["adapters"]})
    n_split = sum(pt_mesh.MODEL_AXIS in spec for spec in pt_mesh.spec_leaves(specs))
    for r in range(2):
        with np.load(tmp_path / f"out_{r}.npz") as out:
            for name in ("unfused", "fused", "fused_mlp"):
                np.testing.assert_allclose(out[name], want, rtol=1e-4, atol=1e-5)
            for i, g in enumerate(ref_grads):
                np.testing.assert_allclose(out[f"grad{i}"], g.numpy(), rtol=1e-4,
                                           atol=1e-5 * float(g.abs().max()))
            # the unfused forward reduces o, o's norms and fc2 in each layer;
            # its backward sums the gradients of the two replicated LayerNorm
            # outputs of each layer and of the two replicated adapter leaves
            # asked for (q's a, o's b). The fused layers gather each split
            # leaf once; with fused_mlp kernel C's plain version takes fc1's
            # weight and bias and fc2's weight gathered, and only o reduces
            assert out["unfused_calls"].tolist() == [2 * 3 + 2 * 2 + 2, 0]
            assert out["fused_calls"].tolist() == [0, n_split]
            assert out["fused_mlp_calls"].tolist() == [2 * 2, 2 * 3]


def test_window_sharded_search_matches_gwkit(tmp_path):
    """score_segments(mesh=) over 2 data ranks: each scores its half of every
    batch, the scores gathered back into batch order, against gwkit's
    single-device all_vals (rtol 1e-5, atol 1e-6)."""
    from gwkit.search.engine import score_segments
    from gwkit.search.slicer import Segment, SlicerConfig

    gw = _gw_tiny_task()
    score_fn = jax.jit(lambda w: gw.forward(gw.trainable, gw.frozen, w).reshape(-1))
    strain = np.random.default_rng(1).normal(size=(2, 256 * 30)).astype(np.float32)
    np.save(tmp_path / "strain.npy", strain)
    cfg = dict(step_size=0.5, slice_length=256, batch_size=16, segment_duration=2.0,
               max_filter_duration=0.5, low_frequency_cutoff=10.0)
    single = score_segments(score_fn, [Segment(key="s", strain=strain, start_time=0.0, delta_t=1.0 / 256)],
                            SlicerConfig(**cfg), trigger_threshold=-1e9, white=True)
    _save_params(tmp_path, gw)
    _spawn(tmp_path, 2, f"""
        from gwkit_torch.search.engine import score_segments
        from gwkit_torch.search.slicer import Segment, SlicerConfig
        mesh = make_mesh(device="cpu")
        assert mesh.shape == (2, 1)
        task = tiny_task()
        seg = Segment(key="s", strain=np.load(os.path.join(tmp, "strain.npy")), start_time=0.0,
                      delta_t=1.0 / 256)
        res = score_segments(lambda w: task.forward(w).reshape(-1), [seg], SlicerConfig(**{cfg!r}),
                             trigger_threshold=-1e9, white=True, device="cpu", mesh=mesh)
        np.savez(os.path.join(tmp, f"out_{{rank}}.npz"), all_vals=res.all_vals, n=res.n_windows,
                 gathers=mesh.calls["all_gather/data"])
    """)
    n_batches = -(-single.n_windows // 16)
    for r in range(2):
        with np.load(tmp_path / f"out_{r}.npz") as out:
            np.testing.assert_allclose(out["all_vals"], single.all_vals, rtol=1e-5, atol=1e-6)
            assert int(out["n"]) == single.n_windows and int(out["gathers"]) == n_batches


# ---------------------------------------------------------------------------
# The trainer on a 2x2 mesh
# ---------------------------------------------------------------------------

def _train_data():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(16, 2, 256)).astype(np.float32)
    y = np.tile(np.eye(2, dtype=np.float32), (8, 1))
    return x, y, np.zeros((16,), np.float32)


# clip 0.01 binds: the first step's global gradient norm is about 0.034, so
# the norm over the sharded and replicated leaves decides every update
TRAIN_CFG = dict(learning_rate=1e-3, clip_norm=0.01, epochs=2, batch_size=8, early_stop_patience=10, seed=0)


def test_trainer_mesh_2x2_matches_unmeshed_and_gwkit(tmp_path):
    """Trainer(mesh=make_mesh(n_model=2)) over 4 processes: batch rows over
    "data", heads and fc1 over "model", one flattened all_reduce of the loss
    and gradients a step, the clip's global norm over the whole tree. Two
    epochs of two steps; losses against the unmeshed port (1e-5) and gwkit's
    trainer (rtol 2e-3, atol 2e-4)."""
    from gwkit.train.trainer import TrainConfig as GwTrainConfig
    from gwkit.train.trainer import Trainer as GwTrainer
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    x, y, snr = _train_data()
    np.savez(tmp_path / "data.npz", x=x, y=y, snr=snr)
    gw = _gw_tiny_task()
    _save_params(tmp_path, gw)
    gwt = GwTrainer(gw.loss_fn, gw.trainable, gw.frozen, GwTrainConfig(**TRAIN_CFG))
    key, gw_losses = jax.random.PRNGKey(0), []
    for _ in range(2):
        key, k = jax.random.split(key)
        batches = [tuple(jnp.asarray(a[i:i + 8]) for a in (x, y, snr)) for i in (0, 8)]
        gw_losses.append(gwt.run_epoch(batches, k)[0])

    port = tasks.build_signal_vs_noise(WhisperConfig(**ENC), torch.load(tmp_path / "params.pt"),
                                       acfg=AdapterConfig(**ACFG), input_sample_rate=256, n_frames=128,
                                       device="cpu")
    pt = Trainer(port.loss_fn, port.trainable, port.frozen, TrainConfig(**TRAIN_CFG))
    batches = [tuple(torch.from_numpy(a[i:i + 8]) for a in (x, y, snr)) for i in (0, 8)]
    _, _, grads, _ = pt._gradients(batches[0])
    grads = [g.numpy().copy() for g in grads]
    norm = float(torch.sqrt(sum(torch.sum(torch.from_numpy(g) ** 2) for g in grads)))
    unmeshed = [pt.run_epoch(batches, torch.Generator().manual_seed(e))[0] for e in range(2)]

    _spawn(tmp_path, 4, f"""
        from gwkit_torch.train.trainer import TrainConfig, Trainer
        mesh = make_mesh(n_model=2, device="cpu")
        assert mesh.shape == (2, 2)
        task = tiny_task()
        trainer = Trainer(task.loss_fn, task.trainable, task.frozen, TrainConfig(**{TRAIN_CFG!r}), mesh=mesh)
        assert trainer.frozen["encoder"]["layers"][0]["q"]["w"].shape == (64, 32)
        assert trainer.trainable["adapters"][0]["q"]["b"].shape == (2, 32)
        d = np.load(os.path.join(tmp, "data.npz"))
        batches = [tuple(torch.from_numpy(d[k][i:i + 8]) for k in ("x", "y", "snr")) for i in (0, 8)]
        # the first step's gradients and global norm, without an update
        from gwkit_torch.io import tree_leaves, tree_unflatten
        from gwkit_torch.parallel.mesh import gather_tree
        _, _, grads, norm = trainer._gradients(batches[0])
        full = tree_leaves(gather_tree(mesh, tree_unflatten(trainer.trainable, grads), trainer._specs))
        before = mesh.calls["all_reduce/data"]
        losses = [trainer.run_epoch(batches, torch.Generator().manual_seed(e))[0] for e in range(2)]
        np.savez(os.path.join(tmp, f"out_{{rank}}.npz"), losses=losses, norm=float(norm),
                 data_reduces=mesh.calls["all_reduce/data"] - before,
                 **{{f"g{{i}}": g.numpy() for i, g in enumerate(full)}})
    """)
    for r in range(4):
        with np.load(tmp_path / f"out_{r}.npz") as out:
            np.testing.assert_allclose(out["losses"], unmeshed, rtol=0, atol=1e-5)
            np.testing.assert_allclose(out["losses"], gw_losses, rtol=2e-3, atol=2e-4)
            assert int(out["data_reduces"]) == 4  # one a step
            # Adam is nearly blind to the clip's scale, so hold the norm and the
            # gathered gradients (replicated leaves' sums over "model" included)
            np.testing.assert_allclose(float(out["norm"]), norm, rtol=1e-5)
            for i, g in enumerate(grads):
                np.testing.assert_allclose(out[f"g{i}"], g, rtol=0, atol=1e-4 * max(np.abs(g).max(), 1e-30))


def test_mesh_fit_writes_full_checkpoints_and_resumes(tmp_path):
    """fit on a 1x2 mesh over 2 processes: rank 0 writes losses.txt, the
    checkpoints and the exports from full leaves (gather_tree), rank 1 waits;
    a second fit resumes from last.ckpt for epoch 2. The files equal the
    unmeshed port's two straight epochs (losses to the printed 6 decimals,
    leaves within 1e-4 of each leaf's size)."""
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    x, y, snr = _train_data()
    np.savez(tmp_path / "data.npz", x=x, y=y, snr=snr)
    _save_params(tmp_path, _gw_tiny_task())
    cfg = {**TRAIN_CFG, "epochs": 1}
    _spawn(tmp_path, 2, f"""
        from gwkit_torch.train.trainer import TrainConfig, Trainer
        mesh = make_mesh(n_model=2, device="cpu")
        d = np.load(os.path.join(tmp, "data.npz"))
        batches = [tuple(torch.from_numpy(d[k][i:i + 8]) for k in ("x", "y", "snr")) for i in (0, 8)]
        out = os.path.join(tmp, "mesh")
        for epochs, resume in ((1, None), (2, "latest")):
            task = tiny_task()
            trainer = Trainer(task.loss_fn, task.trainable, task.frozen, TrainConfig(**{{**{cfg!r}, "epochs": epochs}}),
                              export_components=task.export_components, mesh=mesh)
            trainer.fit(lambda g: batches, lambda g: batches[:1], out, resume=resume)
    """)
    port = tasks.build_signal_vs_noise(WhisperConfig(**ENC), torch.load(tmp_path / "params.pt"),
                                       acfg=AdapterConfig(**ACFG), input_sample_rate=256, n_frames=128,
                                       device="cpu")
    batches = [tuple(torch.from_numpy(a[i:i + 8]) for a in (x, y, snr)) for i in (0, 8)]
    Trainer(port.loss_fn, port.trainable, port.frozen, TrainConfig(**{**TRAIN_CFG, "epochs": 2}),
            export_components=port.export_components).fit(lambda g: batches, lambda g: batches[:1],
                                                          str(tmp_path / "single"))
    mesh_dir, single_dir = tmp_path / "mesh", tmp_path / "single"
    assert sorted(os.listdir(mesh_dir)) == sorted(os.listdir(single_dir))
    rows = [np.loadtxt(d / "losses.txt") for d in (mesh_dir, single_dir)]
    assert rows[0].shape == (2, 3)
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=2e-6)
    for name in ("last.ckpt", "best.npz", "state_e_0002.npz", "best_dense_layers.npz"):
        with np.load(mesh_dir / name) as got, np.load(single_dir / name) as want:
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                if k != "__meta__":
                    ref = want[k]
                    np.testing.assert_allclose(got[k], ref, rtol=0, atol=1e-4 * max(np.abs(ref).max(), 1e-30))


# ---------------------------------------------------------------------------
# Trigger shards and the two-process search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["port", "gwkit"])
def test_trigger_shards_cross_between_packages(tmp_path, writer):
    """One package writes triggers_{pid}.npz, the other merges them."""
    write, merge = ((pt_dist.write_trigger_shard, gw_dist.merge_trigger_shards) if writer == "port"
                    else (gw_dist.write_trigger_shard, pt_dist.merge_trigger_shards))
    host0 = {"s1": [[0.5, 1.2], [0.9, 3.4]], "s3": []}
    host1 = {"s2": [[7.0, 0.1]]}
    write(host0, str(tmp_path), 0)
    write(host1, str(tmp_path), 1)
    merged = merge(str(tmp_path), 2)
    assert list(merged) == ["s1", "s2", "s3"]
    assert merged == {**host0, **host1}
    segs = [f"seg{i:02d}" for i in range(11)]
    for p in range(4):
        assert pt_dist.shard_segments_across_hosts(segs, p, 4) == gw_dist.shard_segments_across_hosts(segs, p, 4)


def test_two_process_get_triggers_matches_single_process(tmp_path):
    """Two processes run get_triggers over one HDF5 file: the key-level
    round-robin split (2 segments and 1), the C++ prefetch reader, and the
    gather through shard_dir. Every process holds the merged triggers, equal
    to the single-process search: times bit for bit, scores within 1e-5."""
    import h5py

    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.search.engine import get_triggers

    path = str(tmp_path / "strain.hdf")
    rng = np.random.default_rng(3)
    with h5py.File(path, "w") as f:
        for det in ("H1", "L1"):
            g = f.create_group(det)
            for key, dur in (("100", 4), ("200", 6), ("300", 4)):
                ds = g.create_dataset(key, data=rng.normal(size=2048 * dur).astype(np.float32))
                ds.attrs["start_time"] = float(key)
                ds.attrs["delta_t"] = 1.0 / 2048
    build = """
        from gwkit_torch.models.qadapter import QAdapterConfig
        from gwkit_torch.models.whisper import WhisperConfig
        from gwkit_torch.train.tasks import build_mlgwsc
        search_task = build_mlgwsc(WhisperConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=256),
                                   QAdapterConfig(spectrogram_shape=(64, 64), target_shape=(80, 512)),
                                   seed=0, device="cpu")
    """
    _spawn(tmp_path, 2, build + f"""
        import json
        from gwkit_torch.search.engine import get_triggers
        triggers, _, _ = get_triggers(search_task, {path!r}, trigger_threshold=-1e9, white=True, batch_size=32,
                                      shard_dir=os.path.join(tmp, "shards"))
        with open(os.path.join(tmp, f"triggers_{{rank}}.json"), "w") as f:
            json.dump(triggers, f)
    """)
    from gwkit_torch.models.whisper import WhisperConfig as W  # noqa: F401 (the build source's names)

    ns = {"QAdapterConfig": QAdapterConfig}
    exec(textwrap.dedent(build), ns)
    want, _, _ = get_triggers(ns["search_task"], path, trigger_threshold=-1e9, white=True, batch_size=32)
    assert sorted(os.listdir(tmp_path / "shards")) == ["triggers_0.npz", "triggers_1.npz"]
    import json

    for r in range(2):
        with open(tmp_path / f"triggers_{r}.json") as f:
            merged = json.load(f)
        assert sorted(merged) == sorted(want) == ["100", "200", "300"]
        for key in want:
            got, ref = np.asarray(merged[key], np.float64), np.asarray(want[key], np.float64)
            assert got.shape == ref.shape, key
            np.testing.assert_array_equal(got[:, 0], ref[:, 0])
            np.testing.assert_allclose(got[:, 1], ref[:, 1], rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# The CLIs under torchrun
# ---------------------------------------------------------------------------

class _Stop(Exception):
    """Ends a CLI's main at the first recorded call that would start work."""


@pytest.mark.parametrize("cli", ["train", "train_glitch", "train_mlgwsc", "inference"])
def test_cli_sets_the_ranks_card_before_anything_is_placed(cli, tmp_path, monkeypatch):
    """Under torchrun (WORLD_SIZE, RANK, LOCAL_RANK set) each CLI sets the
    card to LOCAL_RANK before the process group starts and before any
    dataset or task is read or placed; otherwise every rank of a host lands
    on card 0. CUDA is faked: ``set_device`` is recorded, the group's start
    and the first load are recorded and end main."""
    import h5py
    import torch.distributed as dist

    import gwkit_torch.cli.inference as inference
    import gwkit_torch.data.datasets as datasets
    import gwkit_torch.data.glitch as glitch

    events = []

    def recorder(name):
        def call(*a, **kw):
            events.append(name)
            raise _Stop(name)
        return call

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda i: events.append(f"set_device {int(i)}"))
    monkeypatch.setattr(dist, "init_process_group", recorder("init_process_group"))
    for module, name in ((datasets, "load_concat_datasets"), (glitch, "LabeledDataset"), (h5py, "File"),
                         (inference, "load_task_from_components")):
        monkeypatch.setattr(module, name, recorder("load"))
    for key, val in dict(WORLD_SIZE="2", RANK="1", LOCAL_RANK="1", MASTER_ADDR="127.0.0.1",
                         MASTER_PORT="29500").items():
        monkeypatch.setenv(key, val)
    out = str(tmp_path / "out")
    argv = (["in.hdf", str(tmp_path / "out.hdf"), "--lora-weights", "l", "--dense-weights", "d.npz",
             "--adapter-weights", "a.npz"] if cli == "inference"
            else ["-d", str(tmp_path / "data.hdf"), "-o", out, "--model-parallel", "1"])
    main = __import__(f"gwkit_torch.cli.{cli}", fromlist=["main"]).main
    with pytest.raises(_Stop):
        main(argv)
    assert events == ["set_device 1", "init_process_group"]
