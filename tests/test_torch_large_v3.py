"""whisper-large-v3's encoder on the port's kernel chain.

On the CPU, at a small size that takes the wide route (d_model 640, 10
heads, 2 layers, d_ff 2560, 128 mel bins, 400 frames; kernel C's widest
instantiation is 512): the ``large-v3`` preset and the HF reader at 128
bins; the 128-bin log-mel against ``WhisperFeatureExtractor(feature_size=128)``
and the benchmark's plain reference; the encoder against ``transformers``'
``WhisperEncoder``; the Signal_vs_Noise task against the benchmark's plain
reference (``gwbench/reference/classify_bins.py``) on seeded HF-layout
weights, with ``fused_block=True`` (each stage's plain version, the MLP as
two launches of kernel B) and with the CLIs' CPU config; the MLP's route
and its counters at 640 and 384; what the wide route refuses; the fold of
LayerNorm into kernel B's streamed path and its row statistics, emulated;
the counts of the new cell's launches; the split share's reader.

On a card (``-m card``; each skips without CUDA): kernel B's streamed path
at each of a 1280-wide layer's four launches against its plain version,
with ragged M, and at its edges (ragged N, one slice, a GELU with a
residual, unequal warpgroup tiles, a row mean of 30 sigma); the panel path at K = 384 and 512 unchanged; one large-v3
layer on the chain against ``_reference_block``; the planted faults failing
the new cell's check; kernels B, C, A and E refusing float32. The file
imports no JAX, so the card tests run where there is none::

    python -m pytest --noconftest tests/test_torch_large_v3.py -m card

Tolerances, where the two sides are float32 on the CPU: the log-mel 2e-3
absolute against the float64 extractor and the reference's full STFT
(tests/test_torch_mel.py's bound: f32 FFT rounding near the max - 8
clamp); encoder outputs and embeddings 1e-5 of their largest value (float32
sums in another order through two layers; measured 4e-7); logits 1e-6
absolute (measured 5e-8 against logits of about 1e-2).
"""
import argparse
import copy
import time

import numpy as np
import pytest
import torch

from gwbench import counts, counts_split, faults, files, generate, harness, hf_weights
from gwbench.reference import hf_encoder
from gwbench.reference import mel as ref_mel
from gwbench.reference import mel_bins as ref_mel_bins
from gwbench.reference.classify_bins import ClassifierReference
from gwbench.weights import adapters_and_head, copy_tree
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.models import whisper
from gwkit_torch.models.adapters import AdapterConfig
from gwkit_torch.models.hf_io import load_hf_encoder
from gwkit_torch.ops import _cuda, mel
from gwkit_torch.ops import fused_block as fb
from gwkit_torch.train.tasks import build_signal_vs_noise
from gwkit_torch.utils.tracing import COUNTERS

SMALL = dict(d_model=640, n_heads=10, n_layers=2, d_ff=2560, max_positions=200)
SMALL_CFG = dict(d_model=640, encoder_layers=2, encoder_attention_heads=10, encoder_ffn_dim=2560, n_frames=400,
                 max_source_positions=200, gelu="erf")
ACFG = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo")


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).abs().max() / b.abs().max())


def _small_config():
    cfg = copy.deepcopy(files.config("svn-mel-large-v3"))
    cfg.update(SMALL_CFG)
    return cfg


def _state(cfg, seed=3):
    """Seeded HF-layout weights with LayerNorm and biases moved off 1 and 0,
    so that every parameter counts."""
    state = hf_weights.encoder_state(cfg, seed, torch.device("cpu"))
    g = torch.Generator().manual_seed(seed + 1)
    for k, v in state.items():
        if k.endswith("bias") or "layer_norm" in k:
            v.add_(0.1 * torch.randn(v.shape, generator=g))
    return state


@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


# ---------------------------------------------------------------------------
# preset, reader, log-mel
# ---------------------------------------------------------------------------

def test_large_v3_preset_and_hf_reader():
    cfg = whisper.config_for("large-v3")
    assert (cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff, cfg.n_mels) == (1280, 20, 32, 5120, 128)
    assert whisper.config_for("large").n_mels == 80  # large-v1 and v2
    state = _state(_small_config())
    got_cfg, params = load_hf_encoder(state, size="large-v3", **SMALL)
    assert params["conv1"]["w"].shape == (3, 128, 640) and got_cfg.n_mels == 128
    np.testing.assert_array_equal(params["conv1"]["w"], state["conv1.weight"].numpy().transpose(2, 1, 0))
    with pytest.raises(ValueError, match="mel bins"):
        load_hf_encoder(state, size="large", **SMALL)


def test_log_mel_128_bins_matches_feature_extractor_and_reference(transformers):
    audio = np.random.default_rng(0).normal(size=(2, 16000)).astype(np.float32)
    hf = transformers.WhisperFeatureExtractor(feature_size=128)
    np.testing.assert_allclose(mel.mel_filter_bank(num_mel_filters=128), hf.mel_filters, rtol=0, atol=1e-12)
    # the extractor's own feature function on the audio zero-padded to 30 s, as its __call__ pads it
    # (the __call__ itself imports TensorFlow where it is installed, about 10 s)
    padded = np.zeros((2, mel.N_SAMPLES), np.float32)
    padded[:, :16000] = audio
    want = hf._np_extract_fbank_features(padded, "cpu")
    got = mel.whisper_log_mel(torch.from_numpy(audio), n_mels=128).numpy()
    assert got.shape == want.shape == (2, 128, 3000)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3)
    ref = ref_mel_bins.log_mel(torch.from_numpy(audio), 128).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3)
    # the bank is built once per (n_mels, dtype, device)
    before = COUNTERS["builds"]
    mel.whisper_log_mel(torch.from_numpy(audio), n_mels=128)
    assert COUNTERS["builds"] == before


def test_reference_mel_bins_at_80_is_the_80_bin_reference():
    strain = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 2048)).astype(np.float32))
    np.testing.assert_array_equal(ref_mel_bins.mel_bank(80), ref_mel.mel_bank())
    assert torch.equal(ref_mel_bins.features(strain, 2048, 80, 400), ref_mel.features(strain, 2048, 400))


# ---------------------------------------------------------------------------
# the encoder and the task against HF and the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused_block", [False, True])
def test_encoder_matches_hf_whisper_encoder(transformers, fused_block):
    from transformers.models.whisper.modeling_whisper import WhisperEncoder as HFEncoder

    hcfg = transformers.WhisperConfig(d_model=640, encoder_layers=2, encoder_attention_heads=10,
                                      encoder_ffn_dim=2560, num_mel_bins=128, max_source_positions=200,
                                      activation_function="gelu")
    torch.manual_seed(0)
    model = HFEncoder(hcfg).eval()
    with torch.no_grad():
        for name, t in model.named_parameters():
            if name.endswith("bias") or "layer_norm" in name:
                t.add_(0.1 * torch.randn_like(t))
    cfg, params = load_hf_encoder(model, size="large-v3", fused_block=fused_block, **SMALL)
    enc = whisper.WhisperEncoder(cfg, from_gwkit_numpy(encoder=params)["encoder"])
    feats = torch.from_numpy(np.random.default_rng(2).normal(size=(2, 128, 400)).astype(np.float32))
    with torch.no_grad():
        want = model(feats).last_hidden_state
    assert _rel(enc(feats), want) < 1e-5


@pytest.mark.parametrize("fused_block", [False, True])
def test_task_matches_plain_reference_on_seeded_weights(fused_block):
    cfg = _small_config()
    state = _state(cfg)
    base = hf_encoder.encoder(state)
    norms = {"layers": [{n: {"w": layer[n]["w"].numpy()} for n in "qkvo"} for layer in base["layers"]]}
    params = adapters_and_head(cfg, 5, torch.device("cpu"), norms)
    ref = ClassifierReference(cfg, {**copy_tree(params), "encoder": base}, torch.device("cpu"))
    mix = dict(files.traffic("windows-1s-chirps-b8"), batch=4, pool_batches=1)
    x = torch.from_numpy(generate.windows(mix, 7)["strain"][0])
    _, enc = load_hf_encoder(state, size="large-v3", **SMALL)
    enc_cfg = whisper.config_for("large-v3", fused_block=fused_block, **SMALL)
    task = build_signal_vs_noise(enc_cfg, {**copy_tree(params), "encoder": from_gwkit_numpy(encoder=enc)["encoder"]},
                                 ACFG, num_classes=1, n_frames=400, device="cpu")
    before = dict(COUNTERS)
    got = task.forward(x)
    split = COUNTERS["mlp_split_layers"] - before["mlp_split_layers"]
    assert split == (2 if fused_block else 0) and COUNTERS["mlp_fused_layers"] == before["mlp_fused_layers"]
    assert _rel(task.embed(task.trainable, task.frozen, x), ref.embed(x)) < 1e-5
    np.testing.assert_allclose(got.numpy(), ref.forward(x).numpy(), rtol=0, atol=1e-6)


def test_new_cell_runs_on_the_cpu(monkeypatch):
    """The cell's driver end to end at the small size (the preset's widths
    cut to it), on the CLIs' CPU config: correct."""
    monkeypatch.setitem(whisper.PRESETS, "large-v3", {**whisper.PRESETS["large-v3"], **{
        k: SMALL[k] for k in ("d_model", "n_heads", "n_layers", "d_ff")}})
    over = {"traffic": {"batch": 2, "pool_batches": 2}, "check": {"sample_batches": 2},
            "config": {**SMALL_CFG, "weights": {**files.config("svn-mel-large-v3")["weights"],
                                                "head_calibration_samples": 4}}}
    args = argparse.Namespace(workload="classify-svn-large-v3-b8", seed=2 ** 31 + 11, seconds=0.0, trace=0)
    res = harness.run_cell(args, time.perf_counter(), over, torch.device("cpu"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"setup_s", "classify_samples_per_s", "classify_batch_p95_ms"}


# ---------------------------------------------------------------------------
# the MLP's route, refusals, the fold and its statistics
# ---------------------------------------------------------------------------

def _layer(D, F, H, seed=0):
    g = torch.Generator().manual_seed(seed)
    n = lambda *s, std=0.05: torch.randn(*s, generator=g) * std
    lin = lambda i, o, bias=True: {"w": n(i, o), **({"b": n(o)} if bias else {})}
    ln = lambda: {"g": 1 + n(D, std=0.1), "b": n(D, std=0.1)}
    p = {"attn_ln": ln(), "q": lin(D, D), "k": lin(D, D, False), "v": lin(D, D), "o": lin(D, D),
         "mlp_ln": ln(), "fc1": lin(D, F), "fc2": lin(F, D)}
    return p, torch.randn(2, 24, D, generator=g)


@pytest.mark.parametrize("D,F,H", [(640, 2560, 10), (384, 1536, 6)])
def test_mlp_route_and_counters(D, F, H):
    p, x = _layer(D, F, H)
    layer = fb.fold_layer(p, None, H, torch.float32)
    before = dict(COUNTERS)
    _cuda.reset_counts()
    got = fb.fused_layer_apply(x, layer, approx=False)
    split = COUNTERS["mlp_split_layers"] - before["mlp_split_layers"]
    fused = COUNTERS["mlp_fused_layers"] - before["mlp_fused_layers"]
    assert (split, fused) == ((1, 0) if D > 512 else (0, 1))
    # each stage's plain version: kernel B four times past 512, twice beside C's plain MLP at 384
    assert _cuda.PLAIN_CALLS.get("ln_gemm") == (4 if D > 512 else 2)
    assert _cuda.PLAIN_CALLS.get("fused_mlp", 0) == (0 if D > 512 else 1)
    assert _rel(got, fb._reference_block(x, p, None, H, approx=False)) < 1e-5


def test_wide_route_refusals():
    p, x = _layer(640, 2560, 10)
    with pytest.raises(ValueError, match="skip_mlp"):
        fb.fused_layer_apply(x, fb.fold_layer(p, None, 10, torch.float32), skip_mlp=True)
    with pytest.raises(ValueError, match="int8"):
        fb.fused_layer_apply(x, fb.fold_layer(p, None, 10, torch.float32, quant=True))
    with pytest.raises(ValueError, match="act"):
        fb.ln_gemm(x[0], p["fc1"]["w"], p["fc1"]["b"], act="relu")


def _pairwise(p: torch.Tensor) -> torch.Tensor:
    """The kernel's sum of 16 values: adjacent pairs, then p[e] + p[e + k]
    for k = 4, 2, 1."""
    p = p[..., 0::2] + p[..., 1::2]
    for k in (4, 2, 1):
        p = p[..., :k] + p[..., k:2 * k]
    return p[..., 0]


def _kernel_stats(x: torch.Tensor):
    """The streamed kernel's row statistics, emulated: each of a quad's four
    lanes (of the statistics warpgroup) takes 16 columns of every 64-column
    slice, sums them and their squared deviations pairwise, updates a
    running mean and sum of squared deviations by Chan's rule (float32),
    then the lanes combine pairwise."""
    M, K = x.shape
    lanes = x.float().view(M, K // 64, 4, 16)
    mean = torch.zeros(M, 4)
    m2 = torch.zeros(M, 4)
    for s in range(K // 64):
        v = lanes[:, s]
        mb = _pairwise(v) * (1.0 / 16.0)
        q = _pairwise((v - mb[..., None]).square())
        n = 16.0 * s
        delta = mb - mean
        mean = mean + delta * (16.0 / (n + 16.0))
        m2 = m2 + q + delta * delta * (n * 16.0 / (n + 16.0))
    n = 16.0 * (K // 64)
    for o in (1, 2):
        idx = torch.arange(4) ^ o
        mo, qo = mean[:, idx], m2[:, idx]
        d = mo - mean
        m2 = m2 + qo + d * d * (0.5 * n)
        mean = 0.5 * (mean + mo)
        n *= 2
    return mean[:, 0], torch.rsqrt(m2[:, 0] / K + 1e-5)


@pytest.mark.parametrize("offset", [0.0, 30.0])
def test_streamed_kernel_ln_fold_emulated(offset):
    """LN(x) @ W + bias as the streamed kernel computes it: rstd * (x @ W' -
    mean * colsum) + bias', with W' = g (.) W in bf16 and the row statistics
    of ``_kernel_stats``: against LN(x) @ W + bias in float64 within the
    rounding of W' (2^-9 of each term, summed over K at random), at a row
    mean of 0 and of 30 standard deviations."""
    g = torch.Generator().manual_seed(4)
    K, N = 1280, 96
    x = (torch.randn(64, K, generator=g) + offset).bfloat16()
    w = (torch.randn(K, N, generator=g) / K ** 0.5).bfloat16()
    bias = torch.randn(N, generator=g)
    ln = ((1 + 0.1 * torch.randn(K, generator=g)).bfloat16(), (0.1 * torch.randn(K, generator=g)).bfloat16())
    fold = fb.ln_fold(w, bias, *ln)
    mean, rstd = _kernel_stats(x)
    x64 = x.double()
    np.testing.assert_allclose(mean.double(), x64.mean(-1), rtol=0, atol=1e-5 * (1 + offset))
    np.testing.assert_allclose(rstd.double(), torch.rsqrt(x64.var(-1, unbiased=False) + 1e-5), rtol=2e-5)
    got = rstd.double()[:, None] * (x64 @ fold.w.double() - mean.double()[:, None] * fold.colsum.double()[None]) \
        + fold.bias.double()
    h = (x64 - x64.mean(-1, keepdim=True)) * torch.rsqrt(x64.var(-1, unbiased=False, keepdim=True) + 1e-5)
    want = (h * ln[0].double() + ln[1].double()) @ w.double() + bias.double()
    err = (got - want).abs().max()
    plain = (fb._ln_gemm_reference(x, w, bias, ln).double() - want).abs().max()
    assert err < 2 ** -8 * want.abs().max() and err < 2 * plain


def test_streamed_launch_counter(monkeypatch):
    """Each launch of the streamed kernel adds one to
    ``COUNTERS["ln_gemm_streamed_launches"]`` beside ``LAUNCHES["ln_gemm"]``
    (a stand-in library that accepts the call, as the card's does)."""
    calls = []

    class Lib:
        def gw_ln_gemm_wide(self, *args):
            calls.append(args)
            return 0

    monkeypatch.setitem(COUNTERS, "ln_gemm_streamed_launches", 7)
    _cuda.reset_counts()
    x, w, bias = torch.zeros(3, 64).bfloat16(), torch.zeros(64, 8).bfloat16(), torch.zeros(8)
    y = torch.empty(3, 8).bfloat16()
    fb._launch_ln_gemm_wide(Lib(), 0, x, w, None, bias, None, y, "tanh")
    assert COUNTERS["ln_gemm_streamed_launches"] == 8 and _cuda.LAUNCHES["ln_gemm"] == 1
    assert calls[0][6:10] == (3, 8, 64, fb.ACTS["tanh"]) and calls[0][2] is None and calls[0][4] is None


def test_plain_gelu_epilogue_rounds_as_kernel_c():
    g = torch.Generator().manual_seed(6)
    x = torch.randn(5, 64, generator=g).bfloat16()
    w = (torch.randn(64, 128, generator=g) / 8).bfloat16()
    bias = torch.randn(128, generator=g)
    for act in ("tanh", "erf"):
        pre = (x.float() @ w.float() + bias).bfloat16()
        want = torch.nn.functional.gelu(pre.float(), approximate="tanh" if act == "tanh" else "none").bfloat16()
        assert torch.equal(fb.ln_gemm(x, w, bias, act=act), want)


# ---------------------------------------------------------------------------
# the benchmark's counts and reader
# ---------------------------------------------------------------------------

def test_split_launch_counts_sum_to_the_layer():
    per = counts_split.layer_launches(16, 1500, 1280, 5120, 20, 2)
    assert sum(f for v in per.values() for _, f in v) == 16 * counts.encoder_layer_flops(1500, 1280, 5120)
    assert len(per["ln_gemm"]) == 4 and len(per["attention"]) == 1
    cfg = files.config("svn-mel-large-v3")
    assert round(counts.classify_sample_flops(cfg) / 1e12, 2) == 4.55


def test_new_cells_checks_read_the_bf16_error_and_the_spread():
    """``logit_rms_vs_bf16`` as the classify driver's; ``logit_rms_vs_spread``
    the error's rms over the reference logits' rms about their mean: a
    batch half answered by its mean reads about 0.8 of the spread whatever
    the bfloat16 error, a sound answer its error over the spread."""
    checks = files.driver("classify_seeded").logit_checks
    rng = np.random.default_rng(8)
    want = rng.normal(size=64) * 0.02 + 0.1
    want_bf16 = want + rng.normal(size=64) * 1e-3
    limits = {"logit_rms_vs_bf16": 3.4, "logit_rms_vs_spread": 0.42}
    sound = {c["name"]: c["value"] for c in checks(want + rng.normal(size=64) * 1e-3, want, want_bf16, limits)}
    assert sound["logit_rms_vs_bf16"] < 2 and sound["logit_rms_vs_spread"] < 0.1
    half = half_batch_of(want)
    got = {c["name"]: c["value"] for c in checks(half, want, want_bf16, limits)}
    assert 0.6 < got["logit_rms_vs_spread"] < 1.0 and got["logit_rms_vs_bf16"] > 10
    assert {c["value"] for c in checks(np.full(64, np.nan), want, want_bf16, limits)} == {float("inf")}


def half_batch_of(logits):
    return np.concatenate([faults.half_batch(torch.from_numpy(b.reshape(8, 1))).numpy().reshape(-1)
                           for b in logits.reshape(-1, 8)])


def test_mlp_split_share_reader(monkeypatch):
    read = files.metric_reader("mlp_split_share.classify_large").read
    monkeypatch.setitem(COUNTERS, "mlp_split_layers", 96)
    monkeypatch.setitem(COUNTERS, "mlp_fused_layers", 0)
    monkeypatch.setattr(_cuda, "PLAIN_CALLS", {})
    assert read(None) == 100.0
    monkeypatch.setitem(COUNTERS, "mlp_fused_layers", 32)
    assert read(None) == pytest.approx(75.0)
    monkeypatch.setitem(COUNTERS, "mlp_split_layers", 0)
    monkeypatch.setitem(COUNTERS, "mlp_fused_layers", 0)
    assert read(None) is None
    monkeypatch.delitem(COUNTERS, "mlp_split_layers")
    assert read(None) is None  # a program without the counter


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


WIDE_M = 16 * 1500 + 17  # a batch of 8 two-detector samples at 1500 tokens, and a ragged panel
# (name, M, K, N, LayerNorm, residual, GELU, row mean in standard deviations):
# a 1280-wide layer's four launches of kernel B, then the streamed kernel's
# edges: N of no tile width, K of one slice and of ten, a GELU with a
# residual, a grid that leaves the two consumer
# warpgroups unequal numbers of tiles (M from the card's cluster count: None),
# and a row mean of 30 standard deviations
WIDE_LAUNCHES = [("qkv", WIDE_M, 1280, 3840, True, False, None, 0.0),
                 ("o", WIDE_M, 1280, 1280, False, True, None, 0.0),
                 ("fc1_tanh", WIDE_M, 1280, 5120, True, False, "tanh", 0.0),
                 ("fc1_erf", WIDE_M, 1280, 5120, True, False, "erf", 0.0),
                 ("fc2", WIDE_M, 5120, 1280, False, True, None, 0.0),
                 ("ragged_one_slice", 200, 64, 136, True, False, "tanh", 0.0),
                 ("ragged", 333, 640, 200, False, True, None, 0.0),
                 ("ragged_gelu_residual", 333, 640, 200, True, True, "erf", 0.0),
                 ("unequal_tiles", None, 1280, 1280, False, False, "tanh", 0.0),
                 ("mean_30_sigma", 4000, 1280, 1280, True, False, "tanh", 30.0)]


def _unequal_rows(K, N):
    """Rows that give every cluster of the streamed kernel three items (of
    one tile a block: no LayerNorm), so that in each block the first
    consumer warpgroup takes two tiles and the second one, with a ragged
    last panel."""
    import ctypes

    v = [ctypes.c_int() for _ in range(4)]
    _cuda.check(_cuda.library("ln_gemm").gw_ln_gemm_wide_clusters(*(ctypes.byref(c) for c in v)), "ln_gemm")
    cluster, rows, cols, clusters = (c.value for c in v)
    groups = -(-3 * clusters // -(-N // cols))  # cluster items along M
    return groups * cluster * rows - 37


def _operands(M, K, N, ln, res, dev, seed=0, offset=0.0):
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, device=dev) * std
    x = (r(M, K) + offset).bfloat16()
    w = r(K, N, std=K ** -0.5).bfloat16()
    bias = r(N, std=0.1)
    lnp = ((1 + r(K, std=0.1)).bfloat16(), r(K, std=0.1).bfloat16()) if ln else None
    return x, w, bias, lnp, (r(M, N).bfloat16() if res else None)


def _exact(x, w, bias, ln, res, act):
    """The launch's function in float64 from the same bf16 operands, nothing rounded."""
    h = x.double()
    if ln is not None:
        mean = h.mean(-1, keepdim=True)
        h = (h - mean) * torch.rsqrt((h - mean).square().mean(-1, keepdim=True) + 1e-5)
        h = h * ln[0].double() + ln[1].double()
    y = h @ w.double() + bias.double()
    if act is not None:
        y = torch.nn.functional.gelu(y, approximate="tanh" if act == "tanh" else "none")
    return y if res is None else y + res.double()


def _rms(t):
    return float(t.double().square().mean().sqrt())


@pytest.mark.card
@pytest.mark.parametrize("name,M,K,N,ln,res,act,offset", WIDE_LAUNCHES, ids=[c[0] for c in WIDE_LAUNCHES])
def test_streamed_kernel_b_at_a_wide_layers_launches(card, name, M, K, N, ln, res, act, offset):
    """One launch of the streamed kernel; its error against the float64
    function no larger than the plain bf16 version's own: rms within 1.1x,
    largest within 1.5x (measured 0.70-1.00x and 0.76-1.00x on an H100).
    Without LayerNorm both round the same f32 sum once; with it the kernel
    keeps x exact and rounds g (.) W, where the plain version rounds LN(x)
    three times, so it reads lower."""
    x, w, bias, lnp, r = _operands(M if M is not None else _unequal_rows(K, N), K, N, ln, res, card, offset=offset)
    before, streamed = _cuda.LAUNCHES["ln_gemm"], COUNTERS["ln_gemm_streamed_launches"]
    y = fb.ln_gemm(x, w, bias, ln=lnp, residual=r, act=act)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["ln_gemm"] - before == 1 and COUNTERS["ln_gemm_streamed_launches"] - streamed == 1
    assert bool(torch.isfinite(y).all())
    want = _exact(x, w, bias, lnp, r, act)
    err, plain = y.double() - want, fb._ln_gemm_reference(x, w, bias, lnp, r, act).double() - want
    assert _rms(err) <= 1.1 * _rms(plain), (_rms(err), _rms(plain))
    assert float(err.abs().max()) <= 1.5 * float(plain.abs().max())


def _kernel_names(fn):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if "ln_gemm_kernel" in e.name}


@pytest.mark.card
@pytest.mark.parametrize("K", [384, 512])
@pytest.mark.parametrize("ln,res", [(True, False), (False, True)])
def test_panel_kernel_b_unchanged_at_384_and_512(card, K, ln, res):
    """K <= 512 without a GELU keeps the panel kernel, at its existing
    tolerance (the card smoke run's: max and mean |error| within 2e-2 of
    the plain version's)."""
    x, w, bias, lnp, r = _operands(3 * 200, K, 3 * K if ln else K, ln, res, card)
    names = _kernel_names(lambda: fb.ln_gemm(x, w, bias, ln=lnp, residual=r))
    assert names and all("hopper_ln_gemm_kernel" in n and "wide" not in n for n in names), names
    got, want = fb.ln_gemm(x, w, bias, ln=lnp, residual=r).float(), fb._ln_gemm_reference(x, w, bias, lnp, r).float()
    diff = (got - want).abs()
    assert float(diff.max()) <= 2e-2 * float(want.abs().max())
    assert float(diff.mean()) <= 2e-2 * float(want.abs().mean())


@pytest.mark.card
def test_large_v3_layer_on_the_chain(card):
    """One 1280-wide layer with DoRA, tanh GELU, on 4 x 1500 tokens: B, A,
    B, B, B and no plain call; its error against the layer in float32 no
    larger than the plain bf16 block's own: rms within 1.25x, largest
    within 1.5x (measured 0.89x and 0.96x on an H100)."""
    D, F, H = 1280, 5120, 20
    g = torch.Generator(device=card).manual_seed(5)
    n = lambda *s, std: torch.randn(*s, generator=g, device=card) * std
    lin = lambda i, o, bias=True: {"w": n(i, o, std=0.02), **({"b": n(o, std=0.02)} if bias else {})}
    ln = lambda: {"g": 1 + n(D, std=0.1), "b": n(D, std=0.1)}
    p = {"attn_ln": ln(), "q": lin(D, D), "k": lin(D, D, False), "v": lin(D, D), "o": lin(D, D), "mlp_ln": ln(),
         "fc1": lin(D, F), "fc2": lin(F, D)}
    ad = {k: {"a": n(D, 8, std=D ** -0.5), "b": n(8, D, std=0.02), "m": p[k]["w"].norm(dim=0) * 1.01,
              "scaling": torch.tensor(4.0, device=card)} for k in "qkvo"}
    x = n(4, 1500, D, std=1.0)
    with torch.no_grad():
        _cuda.reset_counts()
        streamed = COUNTERS["ln_gemm_streamed_launches"]
        got = fb.fused_layer_apply(x.bfloat16(), fb.fold_layer(p, ad, H, torch.bfloat16), approx=True)
        torch.cuda.synchronize()
        launches, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        streamed = COUNTERS["ln_gemm_streamed_launches"] - streamed
        want = fb._reference_block(x, p, ad, H, approx=True)
        plain = fb._reference_block(x.bfloat16(), p, ad, H, approx=True)
    assert (launches["ln_gemm"], launches["attention"], launches["fused_mlp"]) == (4, 1, 0) and not plain_calls
    assert streamed == 4  # all four of B's launches on its streamed kernel
    err, perr = got.float() - want, plain.float() - want
    assert _rms(err) <= 1.25 * _rms(perr) and float(err.abs().max()) <= 1.5 * float(perr.abs().max())


@pytest.mark.card
def test_kernels_refuse_float32_before_any_launch(card):
    """On the card the kernel chain takes bfloat16 only: kernels B, C, A
    and E refuse float32 operands with a TypeError before any launch
    (float32 runs the plain layer, ``fused_block=False``)."""
    from gwkit_torch.ops import attention, fused_mlp, int8_gemm

    f = lambda *s: torch.randn(*s, device=card)
    x, g, b = f(64, 384), f(384), f(384)
    calls = {"ln_gemm": lambda: fb.ln_gemm(x, f(384, 1152), f(1152), ln=(g, b)),
             "fused_mlp_block": lambda: fused_mlp.fused_mlp_block(x.view(1, 64, 384), g, b, f(384, 1536), f(1536),
                                                                  f(1536, 384), f(384)),
             "attention_from_qkv": lambda: attention.attention_from_qkv(f(1, 64, 3 * 384), 6),
             "flash_attention": lambda: attention.flash_attention(f(1, 64, 6, 64), f(1, 64, 6, 64), f(1, 64, 6, 64)),
             "int8_gemm": lambda: int8_gemm.int8_gemm(x, int8_gemm.QuantProj.of(f(384, 384), f(384)), ln=(g, b))}
    before = dict(_cuda.LAUNCHES)
    for name, call in calls.items():
        with pytest.raises(TypeError, match=f"^{name}: dtype torch.float32.*bfloat16"):
            call()
    assert _cuda.LAUNCHES == before


@pytest.mark.card
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_planted_faults_fail_the_new_cells_check(card, fault):
    """A fault planted under ``Task.forward``, the entry the cell's driver
    times (``gwbench.faults``; ``control.py`` cannot name this driver), is
    not correct at the cell's own size, on two seeds."""
    for seed in (2 ** 31 + 201, 2 ** 31 + 202):
        with faults.planted("classify", fault):
            args = argparse.Namespace(workload="classify-svn-large-v3-b8", seed=seed, seconds=1.0, trace=0)
            res = harness.run_cell(args, time.perf_counter())
        assert not res["correct"], (seed, res["checks"])
        torch.cuda.empty_cache()
