"""The port stands alone: every module of gwkit_torch imports with jax,
gwkit, h5py, safetensors, transformers, matplotlib and tensorboard
blocked, and its entry points, the parallel layer's included, refuse to run
on the CPU unless asked to. It is whole: every gwkit console script has a
gwkit-torch one, and every public name of gwkit has a counterpart but for
the JAX plumbing ROADMAP.md lists with its reasons."""
import ast
import importlib
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKER = r"""
import importlib.abc, importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "gwkit", "h5py", "safetensors", "transformers", "matplotlib", "tensorboard")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import: {name}")
        return None

sys.meta_path.insert(0, Block())
import gwkit_torch
names = [m.name for m in pkgutil.walk_packages(gwkit_torch.__path__, "gwkit_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED))
assert not leaked, leaked
print(len(names), "modules")
"""


def test_every_module_imports_with_jax_gwkit_and_hdf5_blocked():
    out = subprocess.run([sys.executable, "-c", _BLOCKER], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.split()[0]) >= 20
    for name in ("ops.stft", "ops.resample", "ops.mel", "data.glitch", "train.datasets_util",
                 "utils.metrics_writer", "utils.plotting", "cli.train", "cli.train_glitch",
                 "cli.evaluate_classifier",  # the mel workloads' modules are among them
                 "evaluation.efficiency", "evaluation.stream", "search.bulk", "search.realevents",
                 "cli.train_efficiency", "cli.calculate_efficiencies", "cli.evaluate_stream", "cli.real_events",
                 "cli.preprocess",  # and the efficiency test's
                 "native.hostio", "parallel.mesh", "parallel.distributed",  # and the parallel layer's
                 "ops.snr", "ops.psd", "ops.whiten", "data.noise", "data.detector", "data.waveforms",
                 "data.imrphenomd", "data.imrphenomp", "data.higher_modes", "data.precession_ode",  # data generation's
                 "data.segments", "data.population", "data.generate", "data.fetch", "utils.hdf5",
                 "cli.generate_data",  # and its pipeline
                 "utils.progress", "utils.tracing"):  # and the last of gwkit's utilities
        assert os.path.isfile(os.path.join(ROOT, "gwkit_torch", *name.split(".")) + ".py"), name


def test_every_gwkit_script_has_a_gwkit_torch_script():
    """pyproject.toml: each gwkit-<name> has a gwkit-torch-<name> on the
    same CLI module of gwkit_torch, and that module has a main."""
    import tomllib

    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    ours = {k for k in scripts if k.startswith("gwkit-torch-")}
    theirs = {k for k in scripts if k not in ours}
    assert len(theirs) == 13 and {"gwkit-torch-" + k[len("gwkit-"):] for k in theirs} == ours
    for name in theirs:
        module, func = scripts["gwkit-torch-" + name[len("gwkit-"):]].split(":")
        assert (module, func) == (scripts[name].split(":")[0].replace("gwkit.", "gwkit_torch.", 1), "main"), name
        assert os.path.isfile(os.path.join(ROOT, *module.split(".")) + ".py"), module
        assert callable(getattr(importlib.import_module(module), func)), module


# gwkit's public names the port leaves out on purpose (ROADMAP.md, "what is
# unported"): None for a whole file
LEFT_OUT = {"gwkit/utils/platform.py": None, "gwkit/utils/prng.py": None,
            "gwkit/train/checkpoints.py": {"orbax_save", "orbax_load"}, "gwkit/cli/common.py": {"setup"}}
# gwkit files whose names live in another file of the port
MOVED = {"gwkit/utils/config.py": "gwkit_torch/cli/common.py", "gwkit/utils/logging.py": "gwkit_torch/cli/common.py"}


def _public_names(path, with_imports):
    names = set()
    with open(path) as f:
        body = ast.parse(f.read()).body
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names.update(t.id for t in targets if isinstance(t, ast.Name))
        elif with_imports and isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}


def test_port_covers_gwkit_public_surface():
    """The mechanical diff of the packages: each file of gwkit/ has its
    counterpart under gwkit_torch/ (or in MOVED), and each public name a
    gwkit file defines is defined or re-exported there, but for LEFT_OUT."""
    missing = {}
    for root, _, files in os.walk(os.path.join(ROOT, "gwkit")):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, name), ROOT)
            left_out = LEFT_OUT.get(rel, set())
            if left_out is None:
                continue
            port = MOVED.get(rel, "gwkit_torch" + rel[len("gwkit"):])
            if not os.path.isfile(os.path.join(ROOT, port)):
                missing[rel] = "no counterpart"
                continue
            gone = (_public_names(os.path.join(ROOT, rel), False) - left_out
                    - _public_names(os.path.join(ROOT, port), True))
            if gone:
                missing[rel] = sorted(gone)
    assert not missing, missing


def test_blocker_tells_gwkit_torch_from_gwkit():
    """The blocker must refuse gwkit itself (so the pass above means something)."""
    code = _BLOCKER.split("import gwkit_torch")[0] + "import gwkit\n"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and "blocked import: gwkit" in out.stderr


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    import dataclasses

    import numpy as np

    from gwkit_torch.cli import inference
    from gwkit_torch.data.datasets import InjectionDataset, concat_datasets
    from gwkit_torch.device import resolve_device
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.search.engine import get_triggers, score_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment
    from gwkit_torch.train.tasks import build_mlgwsc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    run = os.path.join(ROOT, "artifacts", "capstone_r5", "run")
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.load_task_from_components(
            os.path.join(run, "best_lora_weights"), os.path.join(run, "best_dense_layers.npz"),
            os.path.join(run, "best_adapter.npz"), target_shape=(80, 512))
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["in.hdf", str(tmp_path / "out.hdf"), "--lora-weights", "l",
                        "--dense-weights", "d", "--adapter-weights", "a"])
    seg = Segment("seg", np.zeros((2, 4096), np.float32), 0.0, 1 / 2048)
    with pytest.raises(RuntimeError, match="CUDA"):
        score_segments(lambda w: w[:, 0, 0], [seg])

    class StreamTask:  # a search task on the default device
        device = None
        qcfg = QAdapterConfig()
        score = score_spec = staticmethod(lambda x: x[:, 0, 0])

    with pytest.raises(RuntimeError, match="CUDA"):
        get_triggers(StreamTask(), "in.hdf", qscan_stream=True)
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceSlicer(seg)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_mlgwsc(WhisperConfig(), QAdapterConfig(), {})
    rows = np.zeros((2, 2, 8), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        InjectionDataset(rows, rows)
    with pytest.raises(RuntimeError, match="CUDA"):
        concat_datasets([InjectionDataset(rows, rows, device="cpu")])
    from gwkit_torch.cli import train_mlgwsc

    with pytest.raises(RuntimeError, match="CUDA"):
        train_mlgwsc.main(["-d", str(tmp_path), "-o", str(tmp_path / "run")])
    # the Signal_vs_Noise and glitch workloads
    from gwkit_torch.cli import evaluate_classifier, train, train_glitch
    from gwkit_torch.data.glitch import LabeledDataset
    from gwkit_torch.train.tasks import build_glitch, build_signal_vs_noise

    with pytest.raises(RuntimeError, match="CUDA"):
        build_signal_vs_noise(WhisperConfig(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_glitch(WhisperConfig(), {})
    with pytest.raises(RuntimeError, match="CUDA"):
        LabeledDataset(np.zeros((2, 8), np.float32), np.zeros(2, np.int64))
    for cli, args in ((train, ["-d", str(tmp_path), "-o", str(tmp_path / "svn")]),
                      (train_glitch, ["-d", str(tmp_path / "g.hdf"), "-o", str(tmp_path / "glitch")]),
                      (evaluate_classifier, ["-d", "in.hdf", "--checkpoint", "best.npz", "-o", str(tmp_path / "ev")]),
                      (evaluate_classifier, ["-d", "in.hdf", "--checkpoint", "best.npz", "-o", str(tmp_path / "ev"),
                                             "--task", "glitch"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
    # the efficiency test, real events and the bulk scorer
    from gwkit_torch.cli import calculate_efficiencies, preprocess, real_events, train_efficiency
    from gwkit_torch.data.datasets import PartitionedDataset
    from gwkit_torch.search.bulk import score_files
    from gwkit_torch.search.realevents import score_event_segments

    with pytest.raises(RuntimeError, match="CUDA"):
        PartitionedDataset(rows[:, 0], rows[:, 0], (5.0, 5.0), (0, 2), (0, 2), (2, 2))

    class MelTask:  # a task on the default device
        device = None
        forward = staticmethod(lambda x: x[:, :1, 0])

    with pytest.raises(RuntimeError, match="CUDA"):
        score_event_segments(MelTask(), {"GW150914": np.zeros((2, 4096), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        score_files(MelTask(), ["in.hdf"], str(tmp_path / "scores.hdf"))
    for cli, args in ((train_efficiency, ["-d", "in.hdf", "-o", str(tmp_path / "eff")]),
                      (calculate_efficiencies, ["-d", "in.hdf", "--checkpoint-dir", str(tmp_path),
                                                "-o", str(tmp_path / "sweep")]),
                      (real_events, ["-d", "in.hdf", "--checkpoint", "best.npz", "-o", str(tmp_path / "ev.hdf")]),
                      (preprocess, ["resample", "in.hdf", str(tmp_path / "out.hdf")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(args)
    # the parallel layer: a process group, a mesh and a mesh trainer
    from gwkit_torch.parallel.distributed import initialize
    from gwkit_torch.parallel.mesh import make_mesh
    from gwkit_torch.train.trainer import Trainer

    with pytest.raises(RuntimeError, match="CUDA"):
        initialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        initialize("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(lambda *a: None, {"head": [torch.zeros(2)]}, {}, mesh=make_mesh())
    assert initialize(device="cpu") is None  # one process, no coordinator: nothing to start
    with pytest.raises(ValueError, match="buffers on cuda"):  # CPU parameters on a card's mesh
        Trainer(lambda *a: None, {"head": [torch.zeros(2)]}, {},
                mesh=dataclasses.replace(make_mesh(device="cpu"), device=torch.device("cuda", 0)))
    # host code: the stream evaluation and the windowing need no card
    from gwkit_torch.cli import evaluate_stream

    with pytest.raises(SystemExit, match="--data-dir is required"):
        evaluate_stream.main(["--injection-file", "inj.hdf"])
    with pytest.raises(FileNotFoundError):
        preprocess.main(["events", str(tmp_path / "missing.hdf"), str(tmp_path / "w.hdf")])
    # data generation: the waveform synthesis and both noise generators
    from gwkit_torch.data.noise import NoiseGenerator, WhiteNoiseGenerator
    from gwkit_torch.data.waveforms import td_polarizations

    params = {"mass1": np.array([30.0]), "mass2": np.array([20.0]), "distance": np.array([400.0])}
    with pytest.raises(RuntimeError, match="CUDA"):
        td_polarizations(params, 1.0, 512.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        NoiseGenerator()
    with pytest.raises(RuntimeError, match="CUDA"):
        WhiteNoiseGenerator()
    assert td_polarizations(params, 1.0, 512.0, device="cpu")[0].shape == (1, 512)
    # data generation's pipeline: the challenge files, the corpus, the glitch corpora, the CLI
    from gwkit_torch.cli import generate_data
    from gwkit_torch.data.generate import (ChallengeSynthesis, generate_challenge_data, generate_training_set,
                                           synthesize_training_set)
    from gwkit_torch.data.glitch import preprocess_glitch_strain, realistic_glitch_dataset

    files = [str(tmp_path / n) for n in ("fg.hdf", "bg.hdf", "inj.hdf")]
    for call in (lambda: generate_challenge_data(*files, duration=100.0),
                 lambda: ChallengeSynthesis(duration=100.0),
                 lambda: generate_training_set(str(tmp_path / "train.hdf"), n_train=2, n_valid=0),
                 lambda: synthesize_training_set(n_train=2, n_valid=0),
                 lambda: realistic_glitch_dataset(1),
                 lambda: preprocess_glitch_strain(np.zeros((1, 4096), np.float32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    for args in (["challenge", "-f", files[0], "-b", files[1], "-i", files[2], "--duration", "100"],
                 ["training", "-o", str(tmp_path / "train.hdf")],
                 ["glitch", "-o", str(tmp_path / "glitch.hdf")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            generate_data.main(args)
    assert not any(os.path.exists(f) for f in files + [str(tmp_path / "train.hdf"), str(tmp_path / "glitch.hdf")])
    assert ChallengeSynthesis(duration=100.0, device="cpu").segment(0)[1]["H1"].device.type == "cpu"
    assert NoiseGenerator(sample_rate=512.0, device="cpu").get(1, 1.0).device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_refuse_mixed_devices():
    """A wrapper given a CPU tensor takes the plain version; it never builds
    or launches anything, and it refuses operands it cannot launch on."""
    from gwkit_torch.ops import _cuda
    from gwkit_torch.ops.fused_block import ln_gemm

    _cuda.reset_counts()
    x = torch.randn(4, 32)
    y = ln_gemm(x, torch.randn(32, 8), torch.zeros(8))
    assert y.shape == (4, 8)
    assert _cuda.LAUNCHES == {"attention": 0, "attention_bwd": 0, "ln_gemm": 0, "fused_mlp": 0,
                              "int8_gemm": 0}
    assert _cuda.PLAIN_CALLS == {"ln_gemm": 1}
    with pytest.raises(ValueError, match="CUDA"):
        _cuda.require_cuda("ln_gemm", x)


def test_require_bf16_names_the_kernel_and_the_plain_route():
    """On the card the kernel chain takes bfloat16 only: ``require_bf16``
    passes bfloat16 tensors and ``None``, and refuses any other dtype with a
    ``TypeError`` that names the kernel and the plain route."""
    from gwkit_torch.ops import _cuda

    bf = torch.zeros(4, dtype=torch.bfloat16)
    _cuda.require_bf16("ln_gemm", bf, None, bf)
    for dt in (torch.float32, torch.float16):
        with pytest.raises(TypeError, match=r"^int8_gemm: dtype .*bfloat16.*fused_block=False"):
            _cuda.require_bf16("int8_gemm", bf, torch.zeros(4, dtype=dt))


def test_int8_gemm_refuses_mixed_devices():
    """Kernel E's wrapper: CPU operands take the plain version; an operand
    on another device is refused, on either path."""
    from gwkit_torch.ops import _cuda
    from gwkit_torch.ops.int8_gemm import QuantProj, int8_gemm

    proj = QuantProj.of(torch.randn(64, 16), torch.zeros(16))
    _cuda.reset_counts()
    assert int8_gemm(torch.randn(4, 64), proj).shape == (4, 16)
    assert _cuda.PLAIN_CALLS == {"int8_gemm": 1} and _cuda.LAUNCHES["int8_gemm"] == 0
    elsewhere = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="more than one device"):
        int8_gemm(torch.randn(4, 64), proj, residual=torch.empty(4, 16, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        int8_gemm(elsewhere, proj)
    with pytest.raises(ValueError, match="GELU or a residual"):
        int8_gemm(torch.randn(4, 64), proj, act="tanh", residual=torch.randn(4, 16))


def test_serve_cli_needs_cuda_unless_cpu(monkeypatch, tmp_path):
    """Server mode of python -m gwkit_torch.cli.serve runs on the card and
    raises without one unless --cpu is given."""
    from gwkit_torch.cli import serve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = os.path.join(ROOT, "artifacts", "capstone_r5", "run")
    args = ["--socket", str(tmp_path / "s.sock"), "--int8",
            "--lora-weights", os.path.join(run, "best_lora_weights"),
            "--dense-weights", os.path.join(run, "best_dense_layers.npz"),
            "--adapter-weights", os.path.join(run, "best_adapter.npz"), "--target-shape", "80", "512"]
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(args)
    with pytest.raises(SystemExit, match="requires --dense-weights"):
        serve.main(["--socket", str(tmp_path / "s.sock"), "--lora-weights", "l"])
