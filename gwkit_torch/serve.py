"""Long-lived scoring server (counterpart of ``gwkit/serve.py``): load the
model once, score many strain files from one resident process.

A fresh search process pays the model load, the kernel libraries' load (and
on a fresh checkout their build) and the encoder's folding (DoRA, the query
scale and, with int8, the weights' quantization) before its first window.
The server keeps one process alive: the first request (or :meth:`warmup`)
pays them, and every later request reuses the task's prepared encoder
(``Task.forward`` keeps it until a weight changes), so steady-state requests
run at the warm-search throughput from request one.

Protocol: newline-delimited JSON over a Unix domain socket (local,
filesystem-permissioned; nothing is exposed on the network).

Request  ``{"input": "/a.hdf", "output": "/a_events.hdf", ...options}``
Response ``{"ok": true, "n_triggers": N, "n_windows": N,
            "x_realtime": x, "seconds": s}``
Control  ``{"cmd": "ping"}`` -> ``{"ok": true, "pong": true}``;
         ``{"cmd": "shutdown"}`` -> reply, then the server loop exits.

Allowed per-request options mirror the inference CLI: ``step_size``,
``trigger_threshold``, ``white``, ``batch_size``, ``cluster_threshold``,
``stream``, ``force``. Errors come back as ``{"ok": false, "error": msg}``;
the server never dies on a bad request.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import time
from typing import Optional

_REQUEST_OPTS = {
    "step_size": float,
    "trigger_threshold": float,
    "white": bool,
    "batch_size": int,
    "cluster_threshold": float,
    "stream": bool,
    "force": bool,
}


class ScoringServer:
    """Serve continuous-search requests for one resident task/weights pair.

    ``task`` is a port Task whose ``score`` scores strain windows (usually
    as built by ``gwkit_torch.cli.inference.load_task_from_components``).
    """

    def __init__(self, task, socket_path: str, **defaults):
        unknown = set(defaults) - set(_REQUEST_OPTS)
        if unknown:
            raise ValueError(f"unknown server defaults: {sorted(unknown)}")
        self.task = task
        self.socket_path = socket_path
        self.defaults = defaults
        self._sock: Optional[socket.socket] = None
        self.n_served = 0

    # -- scoring ----------------------------------------------------------
    def warmup(self, seconds: float = 272.0, sample_rate: int = 2048) -> float:
        """Run the request path once on synthetic strain; returns wall s.

        Goes through ``get_triggers`` on a throwaway file, the code path real
        requests take, so it loads the kernel libraries and leaves the
        task's prepared (folded, and with int8 quantized) encoder in place
        for the first real request. The default 272 s is longer than the
        256 s whitening block, so the blocked path runs too."""
        import tempfile

        import h5py
        import numpy as np

        from gwkit_torch.search.engine import get_triggers

        t0 = time.time()
        rng = np.random.default_rng(0)
        opts = {k: v for k, v in self.defaults.items()
                if k in ("step_size", "trigger_threshold", "white", "batch_size", "stream")}
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "warmup.hdf")
            with h5py.File(path, "w") as f:
                for det in ("H1", "L1"):
                    strain = rng.normal(size=int(seconds * sample_rate)) * 1e-21
                    ds = f.create_group(det).create_dataset("0", data=strain.astype(np.float64))
                    ds.attrs["start_time"] = 0.0
                    ds.attrs["delta_t"] = 1.0 / sample_rate
            get_triggers(self.task, path, **opts)
        return time.time() - t0

    def handle_request(self, req: dict) -> dict:
        """Score one file; pure dict -> dict (no socket) for direct use/tests."""
        from gwkit_torch.search.engine import get_triggers, write_search_output

        if req.get("cmd") == "ping":
            return {"ok": True, "pong": True, "n_served": self.n_served}
        inputfile, outputfile = req.get("input"), req.get("output")
        if not inputfile or not outputfile:
            return {"ok": False, "error": "request needs 'input' and 'output' paths"}
        if not os.path.isfile(inputfile):
            return {"ok": False, "error": f"no such input file: {inputfile}"}
        opts = dict(self.defaults)
        for key, val in req.items():
            if key in ("input", "output", "cmd"):
                continue
            if key not in _REQUEST_OPTS:
                return {"ok": False, "error": f"unknown option: {key}"}
            opts[key] = _REQUEST_OPTS[key](val)
        force = bool(opts.pop("force", False))
        if os.path.isfile(outputfile):
            if not force:
                return {"ok": False, "error": f"output exists (pass force): {outputfile}"}
            os.remove(outputfile)
        cluster_threshold = float(opts.pop("cluster_threshold", 0.35))
        t0 = time.time()
        try:
            triggers, all_vals, result = get_triggers(self.task, inputfile, **opts)
            write_search_output(outputfile, triggers, all_vals, cluster_threshold=cluster_threshold)
        except Exception as exc:  # noqa: BLE001 -- report, keep serving
            logging.exception("request failed for %s", inputfile)
            return {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        self.n_served += 1
        return {
            "ok": True,
            "n_triggers": int(sum(len(v) for v in triggers.values())),
            "n_windows": int(result.n_windows),
            "x_realtime": round(result.throughput_x_realtime, 2),
            "seconds": round(time.time() - t0, 3),
        }

    # -- socket loop -------------------------------------------------------
    def bind(self) -> None:
        if os.path.exists(self.socket_path):
            os.remove(self.socket_path)
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.bind(self.socket_path)
        self._sock.listen(4)

    def serve_forever(self) -> None:
        """Accept loop: one request per connection, newline-delimited JSON.

        Requests are served serially: the card is a serial resource and the
        prepared encoder belongs to the one task."""
        if self._sock is None:
            self.bind()
        logging.info("gwkit_torch serve listening on %s", self.socket_path)
        try:
            while True:
                conn, _ = self._sock.accept()
                with conn:
                    line = _recv_line(conn)
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError as exc:
                        _send(conn, {"ok": False, "error": f"bad JSON: {exc}"})
                        continue
                    if req.get("cmd") == "shutdown":
                        _send(conn, {"ok": True, "bye": True, "n_served": self.n_served})
                        return
                    _send(conn, self.handle_request(req))
        finally:
            self._sock.close()
            self._sock = None
            if os.path.exists(self.socket_path):
                os.remove(self.socket_path)


def watch_directory(
    server: ScoringServer,
    watch_dir: str,
    output_dir: Optional[str] = None,
    poll_seconds: float = 2.0,
    suffix: str = ".hdf",
    stop_after: Optional[int] = None,
    settle_seconds: float = 1.0,
) -> int:
    """Online mode: score strain files as they appear in ``watch_dir``.

    Each new ``*.hdf`` file is scored into ``<output_dir>/<stem>_events.hdf``
    once its size has been stable for ``settle_seconds`` (writers are not
    atomic). Files already processed (an output or a ``.failed`` tombstone
    exists) are skipped, so the watcher is restart-safe. ``stop_after``
    bounds the number of files scored (None = run forever); returns the
    number scored."""
    out_dir = output_dir or watch_dir
    os.makedirs(out_dir, exist_ok=True)
    sizes: dict = {}
    n_scored = 0
    while stop_after is None or n_scored < stop_after:
        ready = []
        seen = set()
        for name in sorted(os.listdir(watch_dir)):
            if not name.endswith(suffix) or name.endswith("_events" + suffix):
                continue
            path = os.path.join(watch_dir, name)
            out = os.path.join(out_dir, name[: -len(suffix)] + "_events" + suffix)
            if os.path.exists(out) or os.path.exists(out + ".failed"):
                continue
            try:
                size = os.path.getsize(path)
            except OSError:  # deleted or renamed between listdir and stat
                continue
            seen.add(path)
            prev = sizes.get(path)
            if prev is None or prev[0] != size:  # first sight, or still growing
                sizes[path] = (size, time.time())
                continue
            if time.time() - prev[1] >= settle_seconds:
                ready.append((path, out))
        # forget files that disappeared or were scored, so a long-running
        # watcher's memory stays bounded by the directory's contents
        for stale in set(sizes) - seen:
            del sizes[stale]
        for path, out in ready:
            resp = server.handle_request({"input": path, "output": out})
            if resp.get("ok"):
                n_scored += 1
                logging.info("watch: %s -> %s (%d triggers, %.1fx realtime)",
                             path, out, resp["n_triggers"], resp["x_realtime"])
            else:
                logging.error("watch: %s failed: %s", path, resp.get("error"))
                # a tombstone, so a permanently bad file is not retried
                with open(out + ".failed", "w") as f:
                    f.write(str(resp.get("error")))
            if stop_after is not None and n_scored >= stop_after:
                return n_scored
        if not ready:
            time.sleep(poll_seconds)
    return n_scored


def _recv_line(conn: socket.socket) -> bytes:
    chunks = []
    while True:
        chunk = conn.recv(65536)
        if not chunk:
            break
        chunks.append(chunk)
        if b"\n" in chunk:
            break
    return b"".join(chunks).split(b"\n", 1)[0]


def _send(conn: socket.socket, obj: dict) -> None:
    conn.sendall(json.dumps(obj).encode() + b"\n")


def request(socket_path: str, req: dict, timeout: float = 3600.0) -> dict:
    """Client side: send one JSON request, return the decoded response."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
        sock.settimeout(timeout)
        sock.connect(socket_path)
        sock.sendall(json.dumps(req).encode() + b"\n")
        buf = b""
        while b"\n" not in buf:
            chunk = sock.recv(65536)
            if not chunk:
                break
            buf += chunk
    if not buf:
        raise ConnectionError("server closed the connection without a response")
    return json.loads(buf.split(b"\n", 1)[0])
