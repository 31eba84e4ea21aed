"""``--config`` files cross between the packages: for every CLI both have,
the same argv parsed by gwkit and by the port dumps equal ``config.json``
trees (gwkit's sections, no key exempted), and each package's file loads
through the other's ``--config`` to the same resolved config."""
import importlib
import json
import os

import pytest

from gwkit.utils import config as gw_config
from gwkit_torch.cli import common

# argv with some values off their defaults; output paths are relative, so
# each package dumps into its own working directory
ARGV = {
    "calculate_efficiencies": ["-d", "x.hdf", "--checkpoint-dir", "c", "-o", "out", "--batch-size", "16"],
    "evaluate": ["--injection-file", "i.hdf", "--foreground-events", "f.hdf", "--foreground-files", "ff.hdf",
                 "--background-events", "b.hdf", "--output-file", "stats.hdf"],
    "evaluate_classifier": ["-d", "x.hdf", "--checkpoint", "b.npz", "-o", "out", "--task", "glitch"],
    "evaluate_stream": ["--injection-file", "i.hdf", "--data-dir", "scores"],
    "inference": ["in.hdf", "out.hdf", "--lora-weights", "l", "--dense-weights", "d", "--adapter-weights", "a",
                  "--target-shape", "80", "512", "--stream", "1", "--shard-dir", "shards"],
    "preprocess": ["resample", "in.hdf", "out.hdf"],
    "real_events": ["-d", "e.hdf", "--checkpoint", "b.npz", "-o", "scores.hdf", "--whiten"],
    "serve": ["--socket", "s.sock"],
    "train": ["-d", "x.hdf", "-o", "out", "--model-parallel", "2", "--snr", "8", "12"],
    "train_efficiency": ["-d", "x.hdf", "-o", "out", "--epochs", "3"],
    "train_glitch": ["-d", "x.hdf", "-o", "out", "--model-parallel", "1", "--augment"],
    "train_mlgwsc": ["-d", "data", "-o", "out", "--model-parallel", "4", "--target-shape", "80", "512"],
}
COMMON = ["--seed", "7", "--verbose"]
PACKAGES = {"gwkit": ("gwkit.cli", gw_config), "port": ("gwkit_torch.cli", common)}


def _parse(package: str, cli: str, argv):
    return importlib.import_module(f"{PACKAGES[package][0]}.{cli}").parse_args(argv)


def _dump(package: str, args, cli: str, workdir, monkeypatch) -> str:
    """Write ``args``' config.json as ``package``'s CLI does; its path."""
    os.makedirs(workdir, exist_ok=True)
    monkeypatch.chdir(workdir)
    output = {"calculate_efficiencies": "output_dir", "evaluate": "output_file", "evaluate_classifier": "output_dir",
              "evaluate_stream": "data_dir", "inference": "outputfile", "preprocess": "output", "real_events": "output",
              "serve": "socket", "train": "output", "train_efficiency": "output", "train_glitch": "output",
              "train_mlgwsc": "output_training"}[cli]
    path = PACKAGES[package][1].dump_config(args, getattr(args, output))
    return os.path.join(workdir, path)


@pytest.mark.parametrize("cli", sorted(ARGV))
def test_config_files_equal_and_cross_load(cli, tmp_path, monkeypatch):
    argv = COMMON + ARGV[cli]
    paths = {pkg: _dump(pkg, _parse(pkg, cli, argv), cli, str(tmp_path / pkg), monkeypatch) for pkg in PACKAGES}
    trees = {}
    for pkg, path in paths.items():
        with open(path) as f:
            trees[pkg] = json.load(f)
    assert trees["port"] == trees["gwkit"]
    assert {"data", "model", "train", "search", "eval", "run"} >= set(trees["gwkit"])
    # each file through the other package's --config: the flags it sets come
    # from the file, so the resolved config is the file's
    for writer, reader in (("gwkit", "port"), ("port", "gwkit")):
        args = _parse(reader, cli, ["--config", paths[writer]] + ARGV[cli])
        resolved = json.loads(json.dumps(PACKAGES[reader][1].config_tree(args), sort_keys=True, default=str))
        assert resolved == trees[writer], (writer, reader)


def test_config_rejects_unknown_keys_and_explicit_flags_win(tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"train": {"no_such_key": 1}}))
    with pytest.raises(SystemExit, match="no_such_key"):
        _parse("port", "train", ["--config", str(bad)] + ARGV["train"])
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"run": {"seed": 3}, "train": {"epochs": 9, "batch_size": 4}}))
    args = _parse("port", "train", ["--config", str(cfg), "--epochs", "2"] + ARGV["train"])
    assert (args.seed, args.epochs, args.batch_size) == (3, 2, 4)
    # a subcommand's flag given on the command line wins too
    cfg.write_text(json.dumps({"input": "from_file.hdf"}))
    args = _parse("port", "preprocess", ["--config", str(cfg), "resample", "in.hdf", "out.hdf"])
    assert args.input == "in.hdf"
