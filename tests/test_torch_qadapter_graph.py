"""The Q-scan and Q-adapter front end as one CUDA graph per input
(``gwkit_torch.models.qadapter``).

On the CPU: ``qadapter_apply`` runs eagerly with gradients on and off and
gives the output of the pooling by host matrices it replaced, bit for bit;
the pooling matrices are built once per (n_in, n_out, device) and equal
``_adaptive_pool_matrix``'s; the three front-end counters exist and start at
0; the graph cache's rules (capture on a key's second call, replay after,
a new key for replaced parameters, eager past the cache's size) with the
graph stood in by the eager function; the benchmark's reader of the replays'
share.

On a card (``-m card``; each skips without CUDA): graphed against eager
bit for bit at two batch shapes and ``time_decimation`` 1 and 4, an in-place
parameter update seen by the next replay, replaced parameters captured
anew, a returned output untouched by the next call, a repeated shape adding
no capture and no build, gradients on running eagerly. The file imports no
JAX, so the card tests run where there is none::

    python -m pytest --noconftest tests/test_torch_qadapter_graph.py -m card
"""
import subprocess
import sys

import pytest
import torch

from gwkit_torch.models import qadapter as qa
from gwkit_torch.models.qadapter import QAdapterConfig, init_qadapter, qadapter_apply, qadapter_apply_spec
from gwkit_torch.ops.qtransform import make_qplan, qscan
from gwkit_torch.utils.tracing import COUNTERS

FRONT = ("qadapter_graph_captures", "qadapter_graph_replays", "qadapter_eager_calls")
SMALL = dict(spectrogram_shape=(32, 32), target_shape=(80, 128), channels=(4, 8, 8), median_stride=8)


def _params(cfg, device="cpu", seed=0):
    p = init_qadapter(cfg, torch.Generator().manual_seed(seed))
    # non-trivial affine and FiLM, so a missed update shows
    p["scale"], p["bias"] = torch.tensor([1.7]), torch.tensor([-0.3])
    p["film_gamma"], p["film_beta"] = torch.tensor([0.8, 1.25]), torch.tensor([0.1, -0.2])
    return {k: ({kk: vv.to(device) for kk, vv in v.items()} if isinstance(v, dict) else v.to(device))
            for k, v in p.items()}


def _strain(batch, device="cpu", seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(batch, 2, 2048, generator=g).to(device)


def _with_host_pool(cfg, params, strain):
    """The front end as it was before the pooling matrices were kept on the
    device: each matrix copied from the host on every call."""
    B, D, _ = strain.shape
    plan = make_qplan(cfg.kernel_length, float(cfg.sample_rate), cfg.q_range, cfg.spectrogram_shape)
    qspec = qscan(strain.reshape(B * D, -1), plan, norm=cfg.qscan_norm, median_stride=cfg.median_stride,
                  time_decimation=cfg.time_decimation)
    x = qspec.reshape(B * D, 1, *qspec.shape[1:])
    x = torch.nn.functional.max_pool2d(torch.relu(qa._conv2d(x, params["conv1"], 1)), 2)
    x = torch.nn.functional.max_pool2d(torch.relu(qa._conv2d(x, params["conv2"], 1)), 2)
    x = torch.relu(qa._conv2d(x, params["conv3"], 1))
    x = qa._conv2d(x, params["conv4"], 0)[:, 0]
    mh = torch.from_numpy(qa._adaptive_pool_matrix(x.shape[-2], cfg.target_shape[0])).to(x.device)
    mw = torch.from_numpy(qa._adaptive_pool_matrix(x.shape[-1], cfg.target_shape[1])).to(x.device)
    x = params["scale"] * torch.einsum("oh,...hw,pw->...op", mh, x, mw) + params["bias"]
    x = x.reshape(B, D, *cfg.target_shape)
    return x * params["film_gamma"][None, :, None, None] + params["film_beta"][None, :, None, None]


@pytest.fixture
def fresh_cache(monkeypatch):
    """An empty graph cache for the test, the process's own left as it was."""
    monkeypatch.setattr(qa, "_GRAPHS", {})
    monkeypatch.setattr(qa, "_SEEN", type(qa._SEEN)())


# ---------------------------------------------------------------------------
# On the CPU
# ---------------------------------------------------------------------------


def test_front_end_counters_exist_and_start_at_zero():
    code = ("from gwkit_torch.models import qadapter; from gwkit_torch.utils.tracing import COUNTERS; "
            f"print([COUNTERS[k] for k in {FRONT!r}])")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300, check=True)
    assert out.stdout.strip() == "[0, 0, 0]"


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
@pytest.mark.parametrize("time_decimation", [1, 4])
def test_qadapter_apply_on_cpu_is_eager_and_unchanged(fresh_cache, grad, time_decimation):
    cfg = QAdapterConfig(**SMALL, time_decimation=time_decimation)
    params = _params(cfg)
    for leaf in (t for v in params.values() for t in (v.values() if isinstance(v, dict) else [v])):
        leaf.requires_grad_(grad)
    strain = _strain(3)
    before = {k: COUNTERS[k] for k in FRONT}
    with torch.set_grad_enabled(grad):
        got = qadapter_apply(cfg, params, strain)
        want = _with_host_pool(cfg, params, strain)
    assert got.requires_grad == grad
    assert torch.equal(got.detach(), want.detach())
    assert {k: COUNTERS[k] for k in FRONT} == before and not qa._GRAPHS and not qa._SEEN


@pytest.mark.parametrize("n_in,n_out", [(16, 80), (32, 128), (128, 512), (37, 5)])
def test_pool_matrices_on_the_device_built_once_per_key(monkeypatch, n_in, n_out):
    monkeypatch.setattr(qa, "_POOL_MATRICES", {})
    before = COUNTERS["builds"]
    m = qa._pool_matrix(n_in, n_out, torch.device("cpu"))
    assert COUNTERS["builds"] == before + 1
    assert torch.equal(m, torch.from_numpy(qa._adaptive_pool_matrix(n_in, n_out)))
    assert qa._pool_matrix(n_in, n_out, torch.device("cpu")) is m and COUNTERS["builds"] == before + 1
    x = torch.randn(2, 3, n_in, n_in)
    want = torch.einsum("oh,...hw,pw->...op", m, x, m)
    assert torch.equal(qa.adaptive_avg_pool2d(x, (n_out, n_out)), want)
    assert COUNTERS["builds"] == before + 1
    torch.testing.assert_close(want, torch.nn.functional.adaptive_avg_pool2d(x, (n_out, n_out)),
                               rtol=1e-5, atol=1e-6)


class _EagerStandIn:
    """A captured graph stood in by the eager front end (the CPU has no
    graphs): records what it was built for."""

    built = []

    def __init__(self, cfg, params, strain):
        self.cfg, self.params = cfg, params
        _EagerStandIn.built.append(tuple(strain.shape))

    def __call__(self, strain):
        return qa._qadapter_eager(self.cfg, self.params, strain)


def test_graph_cache_rules(fresh_cache, monkeypatch):
    """Capture on a key's second call, replays after; an in-place update
    keeps the key; replaced parameters, another shape or dtype, and
    inference mode are new keys; past the cache's size calls stay eager."""
    monkeypatch.setattr(qa, "_FrontGraph", _EagerStandIn)
    monkeypatch.setattr(_EagerStandIn, "built", [])
    cfg = QAdapterConfig(**SMALL)
    params = _params(cfg)
    x = _strain(2)

    def call(p=params, s=x):
        before = {k: COUNTERS[k] for k in (*FRONT, "builds")}
        with torch.no_grad():
            out = qa._front_end_on_card(cfg, p, s)
        return out, tuple(COUNTERS[k] - before[k] for k in (*FRONT, "builds"))

    want = qa._qadapter_eager(cfg, params, x)
    # (captures, replays, eager calls, builds)
    assert call()[1] == (0, 0, 1, 0)
    out, d = call()
    assert d == (1, 1, 0, 1) and torch.equal(out, want)
    assert call()[1] == (0, 1, 0, 0) and call()[1] == (0, 1, 0, 0)
    params["film_beta"].add_(0.5)  # a trainer's step: same tensors, same addresses
    out, d = call()
    assert d == (0, 1, 0, 0) and torch.equal(out, qa._qadapter_eager(cfg, params, x))
    replaced = {k: ({kk: vv.clone() for kk, vv in v.items()} if isinstance(v, dict) else v.clone())
                for k, v in params.items()}
    assert call(replaced)[1] == (0, 0, 1, 0) and call(replaced)[1] == (1, 1, 0, 1)
    assert call(s=_strain(3))[1] == (0, 0, 1, 0) and call(s=_strain(3))[1] == (1, 1, 0, 1)
    with torch.inference_mode():
        assert call(s=x.double())[1] == (0, 0, 1, 0)
    assert call(s=x.double())[1] == (0, 0, 1, 0)
    assert call(s=x.double())[1] == (1, 1, 0, 1)  # the fourth key: the cache is full
    assert len(qa._GRAPHS) == qa._GRAPH_CACHE_SIZE
    for _ in range(2):
        assert call(s=_strain(5))[1] == (0, 0, 1, 0)
    assert _EagerStandIn.built == [(2, 2, 2048), (2, 2, 2048), (3, 2, 2048), (2, 2, 2048)]
    assert call()[1] == (0, 1, 0, 0)


def test_seen_keys_are_bounded(fresh_cache):
    cfg = QAdapterConfig(**SMALL)
    params = _params(cfg)
    with torch.no_grad():
        for b in range(1, 2 * qa._GRAPH_CACHE_SIZE + 2):
            qa._front_end_on_card(cfg, params, _strain(b))
    assert len(qa._SEEN) == qa._GRAPH_CACHE_SIZE and not qa._GRAPHS
    assert [k[1][0] for k in qa._SEEN] == list(range(qa._GRAPH_CACHE_SIZE + 2, 2 * qa._GRAPH_CACHE_SIZE + 2))


def test_replay_share_reader(monkeypatch):
    from gwbench import files

    read = files.metric_reader("qadapter_graph_replays.search").read
    monkeypatch.setitem(COUNTERS, "qadapter_graph_replays", 751)
    monkeypatch.setitem(COUNTERS, "qadapter_eager_calls", 1)
    assert read(None) == pytest.approx(100 * 751 / 752, rel=1e-12)
    monkeypatch.setitem(COUNTERS, "qadapter_graph_replays", 0)
    monkeypatch.setitem(COUNTERS, "qadapter_eager_calls", 0)
    assert read(None) is None  # no front-end call on the card
    monkeypatch.delitem(COUNTERS, "qadapter_graph_replays")
    assert read(None) is None  # a program without the counter
    monkeypatch.setitem(sys.modules, "gwkit_torch.utils.tracing", None)  # a program without the counters
    assert read(None) is None


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

CARD = dict(target_shape=(80, 512))  # the search's geometry: 128 x 128 spectrograms, channels 32, 64, 128


@pytest.fixture
def card(fresh_cache):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _eager(cfg, params, strain):
    with torch.no_grad():
        return qa._qadapter_eager(cfg, params, strain)


def _front(cfg, params, strain):
    with torch.no_grad():
        return qadapter_apply(cfg, params, strain)


def _counts():
    return {k: COUNTERS[k] for k in (*FRONT, "builds")}


@pytest.mark.card
@pytest.mark.parametrize("time_decimation", [1, 4])
def test_graphed_equals_eager_bitwise(card, time_decimation):
    cfg = QAdapterConfig(**CARD, time_decimation=time_decimation)
    params = _params(cfg, card)
    for batch in (8, 5):
        xs = [_strain(batch, card, seed=s) for s in (1, 2, 3, 4)]
        before = _counts()
        outs = [_front(cfg, params, x) for x in xs]  # eager, capture, replay, replay
        after = _counts()
        assert after["qadapter_graph_captures"] - before["qadapter_graph_captures"] == 1
        assert after["qadapter_graph_replays"] - before["qadapter_graph_replays"] == 3
        for x, out in zip(xs, outs):
            want = _eager(cfg, params, x)
            assert torch.equal(out, want), (batch, float((out - want).abs().max()))


@pytest.mark.card
def test_in_place_update_is_seen_and_replacement_recaptures(card):
    cfg = QAdapterConfig(**CARD)
    params = _params(cfg, card)
    x = _strain(4, card)
    for _ in range(3):
        _front(cfg, params, x)
    with torch.no_grad():
        params["conv2"]["w"].mul_(1.5)
        params["bias"].add_(0.25)
    before = _counts()
    assert torch.equal(_front(cfg, params, x), _eager(cfg, params, x))
    assert _counts()["qadapter_graph_captures"] == before["qadapter_graph_captures"]
    replaced = _params(cfg, card, seed=7)
    outs = [_front(cfg, replaced, x) for _ in range(3)]
    assert _counts()["qadapter_graph_captures"] == before["qadapter_graph_captures"] + 1
    for out in outs:
        assert torch.equal(out, _eager(cfg, replaced, x))


@pytest.mark.card
def test_returned_output_survives_the_next_call(card):
    cfg = QAdapterConfig(**CARD)
    params = _params(cfg, card)
    for _ in range(2):
        _front(cfg, params, _strain(4, card, seed=9))
    first = _front(cfg, params, _strain(4, card, seed=1))
    kept = first.clone()
    second = _front(cfg, params, _strain(4, card, seed=2))
    torch.cuda.synchronize()
    assert torch.equal(first, kept) and not torch.equal(first, second)


@pytest.mark.card
def test_repeated_shape_adds_no_capture_and_no_build(card):
    cfg = QAdapterConfig(**CARD)
    params = _params(cfg, card)
    for _ in range(2):
        _front(cfg, params, _strain(4, card))
    before = _counts()
    for s in range(5):
        _front(cfg, params, _strain(4, card, seed=s))
    after = _counts()
    assert {k: after[k] - before[k] for k in after} == {
        "qadapter_graph_captures": 0, "qadapter_graph_replays": 5, "qadapter_eager_calls": 0, "builds": 0}


@pytest.mark.card
def test_gradients_on_the_card_run_eagerly(card):
    cfg = QAdapterConfig(**CARD)
    params = _params(cfg, card)
    x = _strain(2, card)
    before = _counts()
    outs = [qadapter_apply(cfg, params, x) for _ in range(3)]
    assert {k: _counts()[k] - before[k] for k in FRONT} == dict.fromkeys(FRONT, 0) and not qa._SEEN
    assert all(torch.equal(o, outs[0]) for o in outs)
    # the spectrogram half alone is never graphed
    qspec = torch.rand(2, 2, 128, 128, device=card)
    with torch.no_grad():
        qadapter_apply_spec(cfg, params, qspec)
    assert {k: _counts()[k] - before[k] for k in FRONT} == dict.fromkeys(FRONT, 0)
