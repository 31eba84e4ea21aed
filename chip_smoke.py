"""Smoke run of the PyTorch/CUDA port (gwkit_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1 device   the card, its power limit, torch/CUDA versions, TF32 flags
             (both turned off for the f32 phases);
  2 build    nvcc for sm_90a of every kernel source, all at once;
  3 parity   each hand-written kernel against its plain PyTorch version on
             the card, f32 and bf16, at the main path's shapes (one
             whisper-tiny layer over 256 sequences x 256 tokens), at the
             strict attention geometry (T = 1500, score scales 1e-3..1e3)
             and at whisper-base width (D = 512, T = 1500), with times;
  4 search   the MLGWSC-1 search on the capstone weights at (80, 512): a
             300 s dual-detector segment (blocked whitening), batch 128,
             bf16 on the kernels; launch counters prove every encoder layer
             ran on them; the first 4 batches are then rescored in f32 on
             the plain path and compared;
  5 kernels  one line per the kernel table (times, bound, launches);
then the card's name and power limit, and the result line last.
Fails (non-zero exit, no result line) on any disagreement, and without CUDA.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from gwkit_torch.ops import _cuda
from gwkit_torch.ops import attention as A
from gwkit_torch.ops import fused_block as FB
from gwkit_torch.ops import fused_mlp as FM

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores: the f32 kernels use FMA, not TF32
H100_BYTES = 3.35e12      # HBM3
CAPSTONE = "artifacts/capstone_r5"
SOURCES = {"attention": "gwkit_torch/csrc/attention.cu", "ln_gemm": "gwkit_torch/csrc/ln_gemm.cu",
           "fused_mlp": "gwkit_torch/csrc/fused_mlp.cu"}
REPLACES = {"attention": "gwkit/ops/attention.py:30", "ln_gemm": "gwkit/ops/fused_block.py:112",
            "fused_mlp": "gwkit/ops/fused_mlp.py:31"}
# tolerances, as max |kernel - plain| <= tol * max |plain| and
# mean |kernel - plain| <= tol * mean |plain| (the mean term holds small
# outputs, e.g. attention over 1500 keys at score scale 1e-3, to their size):
# f32 kernels run plain f32 FMA, so only summation order differs;
# bf16 differs by rounding points (a few bf16 ulps of the largest value).
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# bf16 vs f32 search scores, as fractions of the f32 score span: gwkit's own
# bf16 parity report at (80, 512) read max |delta| 0.1469 = 0.71% of the span
# and mean |delta| 0.0115 = 0.056% (docs/results/bf16_parity.md)
SEARCH_BF16_TOL = {"max": 0.0075, "mean": 0.0015}


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def median_ms(fn, reps=15):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(n_bytes, flops, dtype):
    peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Checks:
    def __init__(self):
        self.failed = []

    def compare(self, name, got, want, tol, **extra):
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ref, mean_ref = float(want.float().abs().max()), float(want.float().abs().mean())
        err, mean_err = float(diff.max()), float(diff.mean())
        rel = float((diff / want.float().abs().clamp_min(1e-6)).median())
        ok = (bool(torch.isfinite(got.float()).all()) and err <= tol * ref
              and mean_err <= tol * mean_ref)
        emit("parity", check=name, max_abs_err=err, mean_abs_err=mean_err, median_rel_err=rel,
             max_abs_ref=ref, mean_abs_ref=mean_ref, tol={"max": tol * ref, "mean": tol * mean_ref},
             ok=ok, **extra)
        if not ok:
            self.failed.append(name)
        return err


def device_phase():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit("device", nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase():
    t0 = time.time()
    paths = _cuda.build()
    ptxas = {}
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(".log").is_file() else ""
        ptxas[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.time() - t0, libraries=[p.name for p in paths.values()], ptxas=ptxas)


def _layer(D, F, H, rng, dora):
    """Random layer params (gwkit layout, init scales like gwkit's) and DoRA adapters."""
    u = lambda *s, fan: torch.from_numpy(rng.uniform(-1, 1, size=s).astype(np.float32) / np.sqrt(fan))
    lin = lambda i, o, bias=True: {"w": u(i, o, fan=i), **({"b": u(o, fan=i)} if bias else {})}
    ln = lambda: {"g": torch.from_numpy(1 + 0.1 * rng.normal(size=D).astype(np.float32)),
                  "b": torch.from_numpy(0.1 * rng.normal(size=D).astype(np.float32))}
    p = {"attn_ln": ln(), "q": lin(D, D), "k": lin(D, D, bias=False), "v": lin(D, D),
         "o": lin(D, D), "mlp_ln": ln(), "fc1": lin(D, F), "fc2": lin(F, D)}
    ad = None
    if dora:
        ad = {}
        for name in "qkvo":
            w0 = p[name]["w"]
            ad[name] = {"a": u(D, 8, fan=D), "b": torch.from_numpy(0.05 * rng.normal(size=(8, D)).astype(np.float32)),
                        "m": w0.norm(dim=0) * torch.from_numpy(1 + 0.05 * rng.normal(size=D).astype(np.float32)),
                        "scaling": 4.0}
    to = lambda t: {k: to(v) for k, v in t.items()} if isinstance(t, dict) else (
        t.cuda() if isinstance(t, torch.Tensor) else t)
    return to(p), (to(ad) if ad else None)


def _plain_chain(x, layer, approx, skip_mlp=False):
    """The layer chain with every stage on its plain version (the CPU path's math)."""
    B, T, D = x.shape
    x2 = x.reshape(B * T, D)
    qkv = FB._ln_gemm_reference(x2, layer.wqkv, layer.bqkv, (layer.ln1_g, layer.ln1_b))
    q, k, v = (t.reshape(B, T, layer.n_heads, -1) for t in qkv.split(D, dim=-1))
    att = A.reference_attention(q, k, v).reshape(B * T, D)
    x1 = FB._ln_gemm_reference(att, layer.wo, layer.bo, None, x2).view(B, T, D)
    if skip_mlp:
        return x1
    return FM._unfused(x1, layer.ln2_g, layer.ln2_b, layer.w1, layer.b1.to(x.dtype), layer.w2,
                       layer.b2.to(x.dtype), approx)


def parity_phase(checks):
    """Kernels vs plain versions; returns the main-path kernel records (bf16)."""
    rng = np.random.default_rng(0)
    D, F, H, Bs, T = 384, 1536, 6, 256, 256
    records = {}
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        tag = "f32" if dt == torch.float32 else "bf16"
        # K3: the whole main-path layer, chain vs gwkit's unfused math
        for dora in (False, True):
            p, ad = _layer(D, F, H, rng, dora)
            x = torch.from_numpy(rng.normal(size=(Bs, T, D)).astype(np.float32)).cuda().to(dt)
            for approx in (True, False):
                got = FB.fused_encoder_block(x, p, H, ad, approx=approx)
                want = FB._reference_block(x, p, ad, H, approx)
                checks.compare(f"K3 layer {tag} dora={dora} {'tanh' if approx else 'erf'}", got, want, tol,
                               shape=[Bs, T, D])
        # each kernel at the main path's shapes (last layer: with DoRA, tanh)
        layer = FB.fold_layer(p, ad, H, dt)
        x2 = x.reshape(Bs * T, D)
        ln1 = (layer.ln1_g, layer.ln1_b)
        qkv = FB.ln_gemm(x2, layer.wqkv, layer.bqkv, ln=ln1)
        e_qkv = checks.compare(f"B ln1+qkv {tag}", qkv, FB._ln_gemm_reference(x2, layer.wqkv, layer.bqkv, ln1), tol)
        att = A.attention_from_qkv(qkv.view(Bs, T, 3 * D), H)
        q, k, v = (t.reshape(Bs, T, H, -1) for t in qkv.view(Bs, T, 3 * D).split(D, dim=-1))
        e_att = checks.compare(f"A attention {tag}", att, A.reference_attention(q, k, v).reshape(Bs, T, D), tol)
        att2 = att.view(Bs * T, D)
        x1 = FB.ln_gemm(att2, layer.wo, layer.bo, residual=x2)
        e_o = checks.compare(f"B o-proj {tag}", x1, FB._ln_gemm_reference(att2, layer.wo, layer.bo, None, x2), tol)
        mlp_args = (x1.view(Bs, T, D), layer.ln2_g, layer.ln2_b, layer.w1, layer.b1, layer.w2, layer.b2)
        out = FM.fused_mlp_block(*mlp_args, approx=True)
        e_mlp = checks.compare(f"C mlp {tag}", out, FM._unfused(
            x1.view(Bs, T, D), layer.ln2_g, layer.ln2_b, layer.w1, layer.b1.to(dt), layer.w2, layer.b2.to(dt), True), tol)

        it = torch.tensor([], dtype=dt).element_size()
        M = Bs * T
        qkv_b, qkv_f = it * (M * D + D * 3 * D + 2 * D + M * 3 * D) + 4 * 3 * D, 2 * M * 3 * D * D
        o_b, o_f = it * (M * D + D * D + 2 * M * D) + 4 * D, 2 * M * D * D
        att_b, att_f = it * 4 * M * D, 4 * Bs * H * T * T * (D // H)
        mlp_b, mlp_f = it * (2 * M * D + 2 * D + 2 * D * F) + 4 * (F + D), 4 * M * D * F
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        timing = {
            "ln_gemm": dict(
                ms=median_ms(lambda: FB.ln_gemm(x2, layer.wqkv, layer.bqkv, ln=ln1))
                + median_ms(lambda: FB.ln_gemm(att2, layer.wo, layer.bo, residual=x2)),
                plain_ms=median_ms(lambda: FB._ln_gemm_reference(x2, layer.wqkv, layer.bqkv, ln1))
                + median_ms(lambda: FB._ln_gemm_reference(att2, layer.wo, layer.bo, None, x2)),
                bound=[bound_ms(qkv_b, qkv_f, dt), bound_ms(o_b, o_f, dt)], library_ms=None,
                max_abs_err=max(e_qkv, e_o)),
            "attention": dict(
                ms=median_ms(lambda: A.attention_from_qkv(qkv.view(Bs, T, 3 * D), H)),
                plain_ms=median_ms(lambda: A.reference_attention(q, k, v)),
                bound=[bound_ms(att_b, att_f, dt)], library_ms=median_ms(sdpa), max_abs_err=e_att),
            "fused_mlp": dict(
                ms=median_ms(lambda: FM.fused_mlp_block(*mlp_args, approx=True)),
                plain_ms=median_ms(lambda: FM._unfused(x1.view(Bs, T, D), layer.ln2_g, layer.ln2_b, layer.w1,
                                                       layer.b1.to(dt), layer.w2, layer.b2.to(dt), True)),
                bound=[bound_ms(mlp_b, mlp_f, dt)], library_ms=None, max_abs_err=e_mlp),
        }
        for name, t in timing.items():
            b_ms = sum(b for b, _ in t["bound"])
            by = t["bound"][0][1]
            rec = dict(name=name, dtype=tag, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
                       bound_by=by, library_ms=t["library_ms"], max_abs_err=t["max_abs_err"])
            emit("timing", shapes="main path layer (256 seq x 256 tokens, D=384, H=6, F=1536)", **rec)
            if dt == torch.bfloat16:
                records[name] = rec

        # K1 at the strict geometry, adversarial score scales
        Bq, Tq = 64, 1500
        for scale in (1e-3, 1.0, 60.0, 1e3):
            q = torch.from_numpy(rng.normal(size=(Bq, Tq, H, 64)).astype(np.float32) * scale / 8).cuda().to(dt)
            k, v = (torch.from_numpy(rng.normal(size=(Bq, Tq, H, 64)).astype(np.float32)).cuda().to(dt)
                    for _ in range(2))
            got = A.flash_attention(q, k, v)
            t_tol = tol if dt == torch.bfloat16 else max(tol, 4e-6 * scale)
            checks.compare(f"K1 attention T=1500 scale={scale:g} {tag}", got, A.reference_attention(q, k, v), t_tol)
            if scale == 1.0:
                qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
                emit("timing", name="attention", dtype=tag, shapes="strict: 64 seq x 6 heads x T=1500",
                     ms=median_ms(lambda: A.flash_attention(q, k, v), 5),
                     plain_ms=median_ms(lambda: A.reference_attention(q, k, v), 5),
                     bound_ms=bound_ms(4 * Bq * Tq * H * 64 * q.element_size(), 4 * Bq * H * Tq * Tq * 64, dt)[0],
                     library_ms=median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                         qh, kh, vh, scale=1.0), 5))
                del qh, kh, vh
            del q, k, v, got

        # K2 and K4 at whisper-base width (D=512, H=8, F=2048, T=1500)
        pb, adb = _layer(512, 2048, 8, rng, True)
        xb = torch.from_numpy(rng.normal(size=(16, 1500, 512)).astype(np.float32)).cuda().to(dt)
        lb = FB.fold_layer(pb, adb, 8, dt)
        checks.compare(f"K4 attention block base T=1500 {tag}", FB.fused_layer_apply(xb, lb, skip_mlp=True),
                       _plain_chain(xb, lb, False, skip_mlp=True), tol)
        for approx in (True, False):
            args = (xb, lb.ln2_g, lb.ln2_b, lb.w1, lb.b1, lb.w2, lb.b2)
            checks.compare(f"K2 mlp base T=1500 {'tanh' if approx else 'erf'} {tag}",
                           FM.fused_mlp_block(*args, approx=approx),
                           FM._unfused(xb, lb.ln2_g, lb.ln2_b, lb.w1, lb.b1.to(dt), lb.w2, lb.b2.to(dt), approx), tol)
        Mb, Db, Fb = 16 * 1500, 512, 2048
        emit("timing", name="fused_mlp", dtype=tag, shapes="base: 16 seq x T=1500, D=512, F=2048",
             ms=median_ms(lambda: FM.fused_mlp_block(*args, approx=True), 5),
             plain_ms=median_ms(lambda: FM._unfused(xb, lb.ln2_g, lb.ln2_b, lb.w1, lb.b1.to(dt), lb.w2,
                                                    lb.b2.to(dt), True), 5),
             bound_ms=bound_ms(xb.element_size() * (2 * Mb * Db + 2 * Db + 2 * Db * Fb) + 4 * (Fb + Db),
                               4 * Mb * Db * Fb, dt)[0])
        del xb, pb, adb, lb
        torch.cuda.empty_cache()
    return records


def _kernel_group(name):
    low = name.lower()
    for key in ("attention_kernel", "ln_gemm_kernel", "fused_mlp_kernel"):
        if key in low:
            return key
    if "fft" in low:
        return "fft (whitening, Q-scan)"
    if "conv" in low or "cudnn" in low or "xmma" in low or "implicit" in low:
        return "convolution (stem, Q-adapter)"
    if "gemm" in low or "cutlass" in low:
        return "library gemm (head, pooling)"
    if "sort" in low or "radix" in low:
        return "sort (medians)"
    return "other (elementwise, gathers, reductions)"


def profile_search(score, seg, cfg, threshold, dev):
    """One more pass of the search under torch.profiler: device time by
    kernel group, and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from gwkit_torch.search.engine import score_segments

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        score_segments(score, [seg], cfg, trigger_threshold=threshold, device=dev)
        wall_ms = (time.time() - t0) * 1e3
    groups, top = {}, []
    for evt in prof.key_averages():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        top.append((us / 1e3, evt.key[:80], evt.count))
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    emit("profile", wall_ms_profiled=wall_ms, device_ms=device_ms if device_ms else "not measured",
         device_busy_share=device_ms / wall_ms if device_ms else "not measured",
         device_ms_by_group={k: v for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"ms": t, "name": n, "count": c} for t, n, c in top[:12]])


def search_phase(checks, smi):
    from gwkit_torch.cli.inference import load_task_from_components
    from gwkit_torch.search.cluster import get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    files = (f"{CAPSTONE}/run/best_lora_weights", f"{CAPSTONE}/run/best_dense_layers.npz",
             f"{CAPSTONE}/run/best_adapter.npz")
    kw = dict(pretrained_encoder=f"{CAPSTONE}/encoder_pretrained.npz", target_shape=(80, 512))
    t0 = time.time()
    task = load_task_from_components(*files, **kw)  # device=None: the card, bf16, kernels
    load_s = time.time() - t0
    enc = task.cfg.encoder
    assert enc.fused_block and enc.compute_dtype == torch.bfloat16 and enc.gelu_approx

    fs, seconds = 2048, 300.0
    strain = (np.random.default_rng(0).normal(size=(2, int(seconds * fs))) * 1e-21).astype(np.float32)
    seg = Segment(key="smoke", strain=strain, start_time=0.0, delta_t=1.0 / fs)
    cfg = SlicerConfig(batch_size=128)
    dev = torch.device("cuda")
    n_batches = [0]

    def score(windows):
        n_batches[0] += 1
        return task.score(windows)

    warm = score_segments(score, [seg], cfg, trigger_threshold=10.0, device=dev)
    threshold = float(np.quantile(warm.all_vals, 0.95))
    n_batches[0] = 0
    _cuda.reset_counts()
    res = score_segments(score, [seg], cfg, trigger_threshold=threshold, device=dev)
    launches = dict(_cuda.LAUNCHES)
    plain = dict(_cuda.PLAIN_CALLS)
    times, stats, _ = get_clusters(res.triggers)
    n_trig = sum(len(v) for v in res.triggers.values())
    nb, nl = n_batches[0], enc.n_layers
    expect = {"attention": nl * nb, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb}
    ok = launches == expect and not plain
    emit("search", card=smi, seconds=seconds, windows=res.n_windows, batches=nb, triggers=n_trig,
         clusters=int(len(times)), threshold=threshold, wall_s=res.wall_seconds,
         strain_seconds_per_second=res.throughput_x_realtime,
         warm_strain_seconds_per_second=warm.throughput_x_realtime, load_s=load_s,
         launches=launches, expected_launches=expect, plain_calls=plain, ok=ok,
         scores_finite=bool(np.isfinite(res.all_vals).all()))
    if not ok:
        checks.failed.append("launch counters")
    assert res.n_windows == 3000 and len(res.all_vals) == 3000 and np.isfinite(res.all_vals).all()
    assert 0 < n_trig < res.n_windows and 0 < len(times) <= n_trig
    profile_search(score, seg, cfg, threshold, dev)

    # the first 4 batches again: f32 plain path (the reference) and f32 on the kernels
    batches = []
    for windows, _, valid in DeviceSlicer(seg, cfg, device=dev).batches():
        assert valid.all()
        batches.append(windows)
        if len(batches) == 4:
            break
    bf16_scores = torch.from_numpy(res.all_vals[: 4 * 128])
    with torch.no_grad():
        # the same loaded weights, rebuilt in f32: on the plain path (the
        # reference) and on the kernels
        ref, k32 = (torch.cat([build_mlgwsc(dataclasses.replace(enc, compute_dtype=torch.float32,
                                                                fused_block=fused),
                                            task.qcfg, task.params, device=dev).score(w)
                               for w in batches]).float().cpu()
                    for fused in (False, True))
    span = float(ref.max() - ref.min())
    # f32 kernels vs f32 plain: summation order only
    checks.compare("search scores: f32 kernels vs f32 plain (first 4 batches)", k32, ref, 1e-3)
    d = (bf16_scores - ref).abs()
    tol = {k: v * span for k, v in SEARCH_BF16_TOL.items()}
    ok_bf16 = float(d.max()) <= tol["max"] and float(d.mean()) <= tol["mean"]
    corr = float(np.corrcoef(bf16_scores.numpy(), ref.numpy())[0, 1])
    emit("parity", check="search scores: bf16 kernels vs f32 plain (first 4 batches)",
         max_abs_err=float(d.max()), mean_abs_err=float(d.mean()), f32_score_span=span,
         correlation=corr, tol_of_span=SEARCH_BF16_TOL, tol=tol, ok=ok_bf16)
    if not ok_bf16:
        checks.failed.append("bf16 search scores")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    checks = Checks()
    smi = device_phase()
    build_phase()
    records = parity_phase(checks)
    launches = search_phase(checks, smi)
    kernels = []
    for name in ("attention", "ln_gemm", "fused_mlp"):
        r = records[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    if checks.failed:
        print("chip_smoke: FAILED " + ", ".join(checks.failed), file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
