"""The port's scoring server (gwkit_torch.serve, gwkit_torch.cli.serve)
against tests/test_serve.py's cases on a tiny port task on the CPU, and
against gwkit's server on the same weights and strain file.

The tiny task's weights are gwkit's (build_mlgwsc, PRNGKey(0)) bridged with
from_gwkit_numpy, so the cross-package case compares like with like."""
import json
import logging
import os
import shutil
import threading

import h5py
import numpy as np
import pytest
import torch

import jax

from gwkit_torch.search.engine import get_triggers, write_search_output
from gwkit_torch.serve import ScoringServer, request, watch_directory

CAP = os.path.join(os.path.dirname(__file__), "..", "artifacts", "capstone_r5")
ENC = dict(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=256)
QGEO = dict(spectrogram_shape=(64, 64), target_shape=(80, 512))


@pytest.fixture(scope="module")
def tasks():
    """(gwkit's tiny task, the port's task on the same weights)."""
    from gwkit.models.qadapter import QAdapterConfig as GwQ
    from gwkit.models.whisper import WhisperConfig as GwW
    from gwkit.train.tasks import build_mlgwsc as gw_build
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import WhisperConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    gw_task = gw_build(jax.random.PRNGKey(0), encoder=GwW(**ENC), qcfg=GwQ(**QGEO), usr=True)
    tr = jax.tree.map(np.asarray, gw_task.trainable)
    params = from_gwkit_numpy(jax.tree.map(np.asarray, gw_task.frozen["encoder"]), tr["adapters"],
                              tr["head"], tr["qadapter"])
    return gw_task, build_mlgwsc(WhisperConfig(**ENC), QAdapterConfig(**QGEO), params, device="cpu")


@pytest.fixture(scope="module")
def tiny_task(tasks):
    return tasks[1]


@pytest.fixture(scope="module")
def strain_file(tmp_path_factory):
    """A minimal searchable two-detector file (pre-whitened layout), as tests/test_serve.py's."""
    path = str(tmp_path_factory.mktemp("serve") / "strain.hdf")
    fs = 2048
    rng = np.random.default_rng(7)
    with h5py.File(path, "w") as f:
        for det in ("H1", "L1"):
            ds = f.create_group(det).create_dataset("1000000", data=rng.normal(size=fs * 8).astype(np.float32))
            ds.attrs["start_time"] = 1000000.0
            ds.attrs["delta_t"] = 1.0 / fs
    return path


def _serve_in_thread(server):
    server.bind()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def test_handle_request_matches_direct_engine(tiny_task, strain_file, tmp_path):
    server = ScoringServer(tiny_task, str(tmp_path / "unused.sock"), trigger_threshold=-1e9, batch_size=32)
    out = str(tmp_path / "events.hdf")
    resp = server.handle_request({"input": strain_file, "output": out, "white": True})
    assert resp["ok"], resp
    assert os.path.isfile(out)
    assert resp["n_windows"] > 0 and resp["n_triggers"] > 0

    ref_out = str(tmp_path / "ref_events.hdf")
    triggers, all_vals, _ = get_triggers(tiny_task, strain_file, trigger_threshold=-1e9, batch_size=32,
                                         white=True)
    write_search_output(ref_out, triggers, all_vals)
    with h5py.File(out) as a, h5py.File(ref_out) as b:
        for key in ("time", "stat", "var"):
            np.testing.assert_allclose(a[key][()], b[key][()])


def test_handle_request_guards(tiny_task, strain_file, tmp_path):
    server = ScoringServer(tiny_task, str(tmp_path / "unused.sock"), trigger_threshold=-1e9, batch_size=32)
    out = str(tmp_path / "events.hdf")
    assert not server.handle_request({"output": out})["ok"]
    assert not server.handle_request({"input": "/nope.hdf", "output": out})["ok"]
    bad = server.handle_request({"input": strain_file, "output": out, "white": True, "wat": 1})
    assert not bad["ok"] and "unknown option" in bad["error"]

    assert server.handle_request({"input": strain_file, "output": out, "white": True})["ok"]
    again = server.handle_request({"input": strain_file, "output": out, "white": True})
    assert not again["ok"] and "exists" in again["error"]
    assert server.handle_request({"input": strain_file, "output": out, "white": True, "force": True})["ok"]


def test_warmup_prepares_the_request_path(tiny_task, strain_file, tmp_path):
    """warmup() leaves the task's prepared encoder in place and the first
    request scores on that same object: it does not fold again."""
    server = ScoringServer(tiny_task, str(tmp_path / "unused.sock"), trigger_threshold=-1e9, batch_size=32)
    tiny_task._encoder = None
    assert server.warmup(seconds=4.0) > 0
    warm = tiny_task._encoder
    assert warm is not None
    resp = server.handle_request({"input": strain_file, "output": str(tmp_path / "warm_events.hdf")})
    assert resp["ok"], resp
    assert tiny_task._encoder is warm


def test_rejects_unknown_default():
    with pytest.raises(ValueError):
        ScoringServer(object(), "/tmp/x.sock", nonsense=1)


def test_socket_round_trip(tiny_task, strain_file, tmp_path):
    sock_path = str(tmp_path / "gw.sock")
    thread = _serve_in_thread(ScoringServer(tiny_task, sock_path, trigger_threshold=-1e9, batch_size=32,
                                            white=True))
    try:
        pong = request(sock_path, {"cmd": "ping"})
        assert pong["ok"] and pong["pong"]
        out = str(tmp_path / "sock_events.hdf")
        resp = request(sock_path, {"input": strain_file, "output": out})
        assert resp["ok"], resp
        assert os.path.isfile(out)
        assert request(sock_path, {"cmd": "ping"})["n_served"] == 1
        assert not request(sock_path, {"input": str(tmp_path / "missing.hdf"), "output": out})["ok"]
    finally:
        bye = request(sock_path, {"cmd": "shutdown"})
    assert bye["ok"] and bye["bye"]
    thread.join(timeout=30)
    assert not thread.is_alive()
    assert not os.path.exists(sock_path)


def test_watch_directory(tiny_task, strain_file, tmp_path):
    """Online mode: new files are scored once settled; failures leave a
    tombstone instead of wedging the watcher; outputs make restarts no-ops."""
    watch = tmp_path / "incoming"
    watch.mkdir()
    server = ScoringServer(tiny_task, str(tmp_path / "unused.sock"), trigger_threshold=-1e9, batch_size=32,
                           white=True)
    shutil.copy(strain_file, watch / "b_good.hdf")
    (watch / "a_bad.hdf").write_bytes(b"not an hdf5 file")
    assert watch_directory(server, str(watch), poll_seconds=0.05, settle_seconds=0.05, stop_after=1) == 1
    assert (watch / "b_good_events.hdf").is_file()
    assert (watch / "a_bad_events.hdf.failed").is_file()
    assert not (watch / "a_bad_events.hdf").exists()

    first_mtime = (watch / "b_good_events.hdf").stat().st_mtime_ns
    shutil.copy(strain_file, watch / "c_new.hdf")
    assert watch_directory(server, str(watch), poll_seconds=0.05, settle_seconds=0.05, stop_after=1) == 1
    assert (watch / "c_new_events.hdf").is_file()
    assert (watch / "b_good_events.hdf").stat().st_mtime_ns == first_mtime


def test_cli_client_roundtrip(tiny_task, strain_file, tmp_path, capsys):
    """The CLI's client mode speaks the same protocol (server run in-thread)."""
    from gwkit_torch.cli.serve import main

    sock_path = str(tmp_path / "cli.sock")
    thread = _serve_in_thread(ScoringServer(tiny_task, sock_path, trigger_threshold=-1e9, batch_size=32,
                                            white=True))
    out = str(tmp_path / "cli_events.hdf")
    try:
        with pytest.raises(SystemExit) as exc:
            main(["--socket", sock_path, "--ping"])
        assert exc.value.code == 0
        with pytest.raises(SystemExit) as exc:
            main(["--socket", sock_path, "--score", strain_file, out, "--white"])
        assert exc.value.code == 0
        resp = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert resp["ok"] and os.path.isfile(out)
    finally:
        request(sock_path, {"cmd": "shutdown"})
    thread.join(timeout=30)
    assert not thread.is_alive()


def test_port_and_gwkit_servers_agree(tasks, strain_file, tmp_path):
    """The same tiny weights and white strain file through gwkit's server
    and the port's: time, stat and var within the tiny search's tolerance
    (tests/test_torch_search.py: rtol 1e-4, atol 1e-6)."""
    from gwkit.serve import ScoringServer as GwServer

    gw_task, port_task = tasks
    outs = {}
    for name, server in (("gw", GwServer(gw_task, str(tmp_path / "gw.sock"), trigger_threshold=-1e9,
                                         batch_size=32)),
                         ("pt", ScoringServer(port_task, str(tmp_path / "pt.sock"), trigger_threshold=-1e9,
                                              batch_size=32))):
        out = str(tmp_path / f"{name}_events.hdf")
        assert server.handle_request({"input": strain_file, "output": out, "white": True})["ok"]
        with h5py.File(out) as f:
            outs[name] = {k: f[k][()] for k in ("time", "stat", "var", "all_vals")}
    assert len(outs["pt"]["all_vals"]) == len(outs["gw"]["all_vals"]) > 0
    for key in ("time", "stat", "var", "all_vals"):
        assert outs["pt"][key].shape == outs["gw"][key].shape
        np.testing.assert_allclose(outs["pt"][key], outs["gw"][key], rtol=1e-4, atol=1e-6)


def test_cli_cpu_int8_builds_and_warns(monkeypatch, caplog, tmp_path):
    """Server mode with --cpu --int8 loads the task on the CPU without int8
    (as gwkit off the TPU) and says so."""
    from gwkit_torch import serve
    from gwkit_torch.cli.serve import main

    served = []
    monkeypatch.setattr(serve.ScoringServer, "bind", lambda self: None)
    monkeypatch.setattr(serve.ScoringServer, "serve_forever", lambda self: served.append(self))
    run = os.path.join(CAP, "run")
    with caplog.at_level(logging.WARNING):
        main(["--socket", str(tmp_path / "s.sock"), "--cpu", "--int8",
              "--lora-weights", os.path.join(run, "best_lora_weights"),
              "--dense-weights", os.path.join(run, "best_dense_layers.npz"),
              "--adapter-weights", os.path.join(run, "best_adapter.npz"),
              "--pretrained-encoder", os.path.join(CAP, "encoder_pretrained.npz"),
              "--target-shape", "80", "512"])
    (server,) = served
    enc = server.task.cfg.encoder
    assert server.task.device == torch.device("cpu")
    assert not enc.quant_int8 and not enc.fused_block and enc.compute_dtype == torch.float32
    assert "int8" in caplog.text


def test_cli_client_never_touches_cuda(tiny_task, tmp_path, monkeypatch):
    """Client mode only sends JSON: it runs where CUDA is absent and asks
    nothing of torch.cuda."""
    from gwkit_torch.cli.serve import main

    sock_path = str(tmp_path / "c.sock")
    thread = _serve_in_thread(ScoringServer(tiny_task, sock_path))

    def no_cuda(*a, **k):
        raise AssertionError("client mode touched torch.cuda")

    for name in ("is_available", "device_count", "current_device", "init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    for flag in ("--ping", "--shutdown"):
        with pytest.raises(SystemExit) as exc:
            main(["--socket", sock_path, flag])
        assert exc.value.code == 0
    thread.join(timeout=30)
    assert not thread.is_alive()
