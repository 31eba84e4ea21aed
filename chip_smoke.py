"""Smoke run of the PyTorch/CUDA port (gwkit_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1 device   the card, its power limit, torch/CUDA versions, TF32 flags
             (both turned off for the f32 phases);
  2 build    nvcc for sm_90a of every kernel source, all at once; each
             kernel's registers and spill bytes (the bf16 kernels of A, B,
             C, D and E must be there, must not spill and must run on
             wgmma: HGMMA in their SASS, IGMMA, the integer form, in E's);
  3 parity   kernel A's K3 exp against expf on every bf16 input and its
             K1 division against the IEEE quotient; kernel E's row
             quantization against the IEEE division, bit for bit, on every
             bf16 value at 117 row maxima; each
             hand-written kernel against its plain PyTorch version on
             the card, f32 and bf16, at the main path's shapes (one
             whisper-tiny layer over 256 sequences x 256 tokens), B and C
             with the profiler's device time and cuBLAS's bare products of
             the same operands beside them (gemm_ms), and again on 3 x 200
             rows (B with and without LN and residual, C under both GELUs,
             at D = 384 and 512); kernel A
             on its one-pass (T = 200, 256) and two-pass paths (T = 300,
             1500) under both contracts, in place and contiguous, score
             scales 1 and 60 (1e-3..1e3 at T = 1500), and at the training
             forward's shapes (64 and 128 x 6 x T = 256, K1), with times
             (CUDA events around a call, and the profiler's device time,
             the median of repeated calls) at T = 1500 and at the training
             forward, and A's, B's and C's host work a call; whisper-base width
             (D = 512, T = 1500), with times; the attention backward
             (kernel D) at the training shapes (128 sequences x 6 heads x
             T = 256) and at T = 1500, score scales 1e-3..1e3, in bf16
             from the row state kernel A saves and standalone (A's output
             bits unchanged by saving it, its m, l and o against the
             plain forward's), contiguous and from a fused QKV, reruns
             bit-identical, times beside SDPA's backward; the layer's gradients through
             FusedBlock (kernels) against autograd of the plain layer;
             kernel E (int8) in each of its modes at the main shapes (with
             zero rows and exact .5 ties; fc1 handing each row's maximum
             to fc2, checked exactly), with CUDA-event and profiler device
             times beside torch._int_mm's bare int8 products timed both
             ways, and on 3 x 200 rows at D = 384 and 512 (fc2 at
             K = 2048); the int8 layer in gwkit's three regimes against the
             same chain on plain versions, int8 against the unquantized
             layer;
  4 search   the MLGWSC-1 search on the capstone weights at (80, 512): a
             300 s dual-detector segment (blocked whitening), batch 128,
             bf16 on the kernels; launch counters prove every encoder layer
             ran on them; the first 4 batches are then rescored in f32 on
             the plain path and compared;
  4c stream  phase 4's task and threshold on 300 s of noise independent
             of phase 4's, with 20 chirps added (SNR 8-30): the exact
             search, then the streaming Q-scan search (each block
             Q-transformed once, every window cropped from it), each a
             warm and a timed pass; the streaming pass's launch
             counters; its first 4 batches against the f32 plain path;
             stream-vs-exact correlation and trigger Jaccard (printed: the
             two differ near window edges by design); the device time of
             the streaming pass by group; the MLGWSC-1 statistics
             (get_stats) of both searches against phase 4's noise-only
             clusters, with the sensitive distance at FAR <= 1e3 and 1e2
             a month (gated: keys, finite, FAR non-increasing, found
             injections and sensitive fractions equal to a plain count);
  4b int8    the same search with int8 projections (kernel E), launch
             counters, throughput, its scores against the f32 plain int8
             path and against phase 4's bf16 scores; then a ScoringServer on
             the int8 task answers ping, a missing file and shutdown;
  5 train    the capstone recipe through Trainer.fit for 2 short epochs
             (the capstone encoder frozen, fresh adapters, head and
             Q-adapter, batch 64, bf16 on the kernels, Adam 3e-4, clip 100)
             on a synthetic injection set; launch counters per step, the
             losses, the exports loaded back and scored, steps/s (median
             of three 8-step windows), and the device time of a step by
             kernel group;
  6 mel      the Signal_vs_Noise and glitch workloads at Whisper-tiny's
             full context (3000 mel frames, T = 1500), bf16 on the kernel
             chain, random weights from a torch seed, 1 s two-detector
             strain with chirps at SNR 5-15 in half the samples: (6a)
             Signal_vs_Noise forward at batch 64, the card's log-mel
             against the CPU path (2e-3), exactly 4 A, 8 B and 4 C a
             batch, samples/s and a profiled pass, every token of the
             encoder output and the logits against the f32 plain path;
             gwkit's use_flash_attention and fused_mlp switches on the
             unfused layer (A and C, then D), forward and gradients;
             (6b) cli/train.py's recipe at batch 16: the step's gradients
             (f32 loss and bf16 summed logits) against the plain layer,
             8 A, 4 D, 8 B and 4 C a step, samples/s and a 3-step profile;
             (6c) glitch (one detector, 11 classes) under 6a's gates, a
             step with dropout and a full fine-tuning step with the
             encoder's gradients through the kernels;
  7 eff      the efficiency workload at the same width and context,
             through the CLIs' recipes without their HDF5 reading: (7a)
             train_efficiency (batch 32, AdamW 1e-5, the epoch scheduler
             over the ladder 30 20 10 with a rung an epoch,
             --reset-optimizer): each epoch's SNR range equals its rung,
             Adam's state is zero with count 0 after each reset, exactly
             8 A, 4 D, 8 B and 4 C a step (4 A, 8 B, 4 C a validation
             batch) and no plain call, finite losses, the checkpoints;
             (7b) calculate_efficiencies --epochs all on 7a's checkpoints
             (128 injections, 512 noises, the CLI's SNRs, FAPs and batch
             16): 4 A, 8 B, 4 C a batch, the tables read back, the best
             checkpoint's bf16 logits under BF16_VS_PLAIN and its table in
             f32 on the kernels against the f32 plain path (equal but for
             entries decided within 1e-3 x max |score| of a threshold,
             counted), the bf16 table printed; (7c) real-event scoring of
             two 32 s events, one raw (whitened by the slicer, --whiten),
             one pre-whitened: window counts, 4 A, 8 B, 4 C a batch,
             scores in [0, 1], the first batch's logits under
             BF16_VS_PLAIN; samples/s, windows/s, the phase's wall time;
  8 parallel the host-IO library built (g++) and bit-exact: ArrayPrefetch
             and ChunkLoader on a raw f64 file of 2 x 4096 s at 2048 Hz
             (134 MB, written with numpy) against np.fromfile, MB/s for
             both; a one-rank NCCL process group on 127.0.0.1; phase 4's
             bf16 search (the capstone task loaded anew) with
             make_mesh(1): scores bit-identical to phase 4's, the same
             launch counts, one all_gather a batch; 8 steps of phase 5's
             recipe with Trainer(mesh=make_mesh(1)) against the unmeshed
             trainer from the same trainables and batches (cuDNN
             deterministic for both): losses equal, the same launches a
             step, one NCCL all_reduce a step; then 40 step pairs in turns
             (medians and the paired difference), the mesh step's
             _data_mean, all_reduce and flatten alone, and a 3-step profile
             of each trainer; the trigger shards through gather_trigger_lists and a
             shard_dir; make_mesh(n_model=2) refused in a world of one;
  9 generate data generation's physics on the card and a search of its
             output: the design PSD and the H1/L1 variants for 300 s at
             2048 Hz (finite, zero below 9 Hz, positive above); 300 s of
             two-detector noise from the variants (NoiseGenerator, physical
             scale), a Welch PSD's median ratio to the target in
             [0.9, 1.1] over 30-900 Hz, the colored-noise core card vs CPU
             from the same draws (1e-4 of the max), strain-seconds/s; the
             irfft of spectra with imaginary DC and Nyquist parts card vs
             CPU (1e-5 of the max: both drop those parts); 64
             ds3/4 waveforms of 64 s (gwkit's inject_batch and
             wave_duration) for imrphenomd, imrphenomxphm and
             imrphenomxphm-twospin timed on the card, each waveform
             within 2e-3 of its max |h| of the same function on the CPU,
             waveforms/s, peak memory, the two-spin ODE timed alone and
             profiled; the Euler angles of that batch (closed form and
             ODE) card vs CPU within 1e-4 of their max, and the aligned
             limit frozen exactly on the card; 20 imrphenomxphm injections projected onto H1 and
             L1 (antenna patterns, the geocenter delay as an FD phase),
             scaled to network SNRs from U(8, 30) against the normalized
             PSDs (recomputed within 1e-4) and added to the noise; phase
             4's bf16 task and threshold on that foreground and on a
             second noise draw (background): exactly 4 A, 8 B and 4 C a
             batch, no plain call, get_stats under phase 4c's checks, the
             found count and sensitive distances printed;
  10 pipeline data generation's pipeline on the card, through
             gwkit_torch.data.generate and glitch: (a) challenge dataset 3,
             one hour (the first default O3a segment, 7,372,800 samples in
             15 chunks of 2^19, two batched calls a detector, a PSD variant
             a detector, about 147 imrphenomxphm injections at gwkit's
             inject_batch 64 and wave_duration 64) in memory: the injection
             table and PSD keys bit-equal to the CPU's, each background's
             Welch PSD against its target (median ratio in [0.9, 1.1] over
             30-900 Hz), fg - bg zero exactly outside the injections'
             windows and non-zero in each, strain-s/s and peak memory; (b)
             datasets 1 and 3 at 600 s on the card and the CPU from one
             seed: table and PSD keys bit for bit, fg - bg within 2e-3 of
             its max; (c) phase 4's bf16 task and threshold on (a)'s
             foreground and background: 4 A, 8 B, 4 C a batch, no plain
             call, get_stats against the generated table under phase 4c's
             checks, found count and sensitive distances printed; (d) the
             training corpus's arrays (1024 + 256 windows, imrphenomd, 16 s
             waves) against the CPU path: each waveform window within 2e-3
             of its max, the whitened noise's std within 5% (other draws),
             waveforms/s and noise windows/s; (e) 8 steps of phase 5's
             recipe on an InjectionDataset of (d): 8 A, 4 D, 8 B, 4 C a
             step, no plain call, finite losses, samples/s; (f) the
             synthetic glitch corpus and the realistic one (64 a class) on
             the card under gwkit's calibration gate, samples/s;
  11 utils   gwkit_torch.utils.tracing and the Q-scan's time_decimation:
             (a) trace(logdir) around 2 batches of phase 4's bf16 search
             inside annotate("search"): the trace file parses as JSON and
             holds the region; its device events in the region, grouped by
             _kernel_group, count 8 A, 16 B and 8 C, equal to the launch
             counters; trace(None) records nothing; the trace's size, the
             region's device ms by group and the profiled wall printed;
             (b) qscan at d = 4 on those 256 whitened windows (x 2
             detectors) at phase 4's plan, card vs CPU in f32 within
             1e-4, and against d = 1 on the card: every window's
             spectrogram correlates above 0.98 where gwkit sets that bar,
             with its 180 Hz burst added at 10x the noise (the noise-only
             windows' correlation and plane changes printed); then phase
             4's segment searched with QAdapterConfig(time_decimation=4):
             4 A, 8 B, 4 C a batch, no plain call; score correlation and
             trigger Jaccard with phase 4's d = 1 search, strain-s/s;
  kernels    one line per the kernel table (times, bound, launches, by
             path: search, search_stream, search_int8, train, mel,
             mel_train, efficiency_train, efficiency, real_events,
             search_mesh, train_mesh, search_generated, search_pipeline,
             train_pipeline, search_decimated); kernel
             E's times, bound and int_mm times are the sums of its four
             launches a layer, kernel B's of its two;
then the card's name and power limit, and the result line last.
Fails (non-zero exit, no result line) on any disagreement, and without CUDA.
"""
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from gwkit_torch.ops import _cuda
from gwkit_torch.ops import attention as A
from gwkit_torch.ops import fused_block as FB
from gwkit_torch.ops import fused_mlp as FM
from gwkit_torch.ops import int8_gemm as IG

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (H100 SXM data sheet)
H100_F32_FLOPS = 67e12    # f32 outside the tensor cores: the f32 kernels use FMA, not TF32
H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak
H100_BYTES = 3.35e12      # HBM3
CAPSTONE = "artifacts/capstone_r5"
KERNELS = ("attention", "attention_bwd", "ln_gemm", "fused_mlp", "int8_gemm")
# the bf16 wgmma kernels the build phase must find, each spill-free with
# warpgroup MMA in its SASS (HGMMA; IGMMA, the integer form, for kernel E's
# panel and stream modes)
HOPPER_KERNELS = ("hopper_attention_kernel", "hopper_dq_kernel", "hopper_dkdv_kernel", "hopper_ln_gemm_kernel",
                  "hopper_fused_mlp_kernelILi384", "hopper_fused_mlp_kernelILi512",
                  "hopper_int8_gemm_kernelILb0", "hopper_int8_gemm_kernelILb1")
SOURCES = {name: f"gwkit_torch/csrc/{name}.cu" for name in KERNELS}
REPLACES = {"attention": "gwkit/ops/attention.py:30", "attention_bwd": "gwkit/ops/attention.py:93",
            "ln_gemm": "gwkit/ops/fused_block.py:112", "fused_mlp": "gwkit/ops/fused_mlp.py:31",
            "int8_gemm": "gwkit/ops/fused_block.py:99"}
# __global__ grids one counted launch runs: kernel D is dq_kernel, then dkdv_kernel
GRIDS_PER_LAUNCH = {"attention": 1, "attention_bwd": 2, "ln_gemm": 1, "fused_mlp": 1, "int8_gemm": 1}
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
# int8 vs bf16 search scores, as fractions of the f32 score span: gwkit's int8
# report on the trained capstone at (80, 512) read max |delta| 0.56% of the
# span and mean 0.053% (docs/results/int8_parity.md), on its validation set;
# these windows are synthetic noise, hence the margin
SEARCH_INT8_TOL = {"max": 0.015, "mean": 0.0015}
# int8 checks: a value at a rounding tie may round to the other quantum when
# the two sides' LayerNorm or attention differ in the last bit, and its row
# then differs by about one quantum everywhere. Such rows are allowed beside
# the tolerance (the mean error stays held to it), within 1e-2 of the largest
# value, and counted (flipped_rows): for one projection at most 1 row in
# 100; for a whole layer any number, since a flipped quantum of k or v
# reaches every row of its sequence through attention.
FLIP_ROWS, FLIP_BOUND = 0.01, 1e-2


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


def device_ms(fn, reps=20):
    """Device time of one call of ``fn``: the median over ``reps`` calls of
    the profiler's kernel time a call. The calls stand apart by a
    synchronize and 2 ms of sleep, so each call's kernels form one cluster
    on the device's clock (no host work is counted)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if "cuda" in str(getattr(e, "device_type", "")).lower() and e.time_range.end > e.time_range.start)
    calls, last_end = [], None
    for start, end in spans:  # microseconds
        if last_end is None or start - last_end > 1000:
            calls.append(0.0)
        calls[-1] += end - start
        last_end = end if last_end is None else max(last_end, end)
    return statistics.median(calls) / 1e3 if calls else "not measured"


def bound_ms(n_bytes, flops, dtype, peak=None):
    peak = peak or (H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS)
    t_bytes, t_ops = n_bytes / H100_BYTES * 1e3, flops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Checks:
    def __init__(self):
        self.failed = []

    def compare(self, name, got, want, tol, flip_rows=0.0, **extra):
        """max and mean |got - want| within tol of want's; with
        ``flip_rows``, that share of rows with a flipped quantum is allowed
        beside the max (FLIP_ROWS)."""
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        ref, mean_ref = float(want.float().abs().max()), float(want.float().abs().mean())
        err, mean_err = float(diff.max()), float(diff.mean())
        rel = float((diff / want.float().abs().clamp_min(1e-6)).median())
        ok = bool(torch.isfinite(got.float()).all()) and mean_err <= tol * mean_ref
        if flip_rows:  # a row is the last dimension (each element of a vector)
            rows = diff.reshape(-1, diff.shape[-1] if diff.dim() > 1 else 1).amax(dim=-1) > tol * ref
            n_flip = int(rows.sum())
            extra["flipped_rows"] = n_flip
            ok = ok and (n_flip == 0 or n_flip <= max(1, flip_rows * rows.numel()) and err <= FLIP_BOUND * ref)
        else:
            ok = ok and err <= tol * ref
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


def _ptxas(log):
    """Per kernel function: registers and spill bytes from nvcc's -Xptxas -v
    log, with ptxas's performance warnings."""
    funcs, warnings = [], []
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            funcs.append({"function": m.group(1)})
        elif funcs and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)):
            funcs[-1]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif funcs and (m := re.search(r"Used (\d+) registers", ln)):
            funcs[-1]["registers"] = int(m.group(1))
        elif "Performance Loss" in ln:
            warnings.append(ln.strip())
    return funcs, warnings


def _sass(path, function):
    tool = os.path.join(os.path.dirname(_cuda._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", "-fun", function, str(path)], capture_output=True, text=True).stdout


def _max_sass_register(sass):
    """The highest register a function's SASS names: kernel A's consumers
    run past the block's count after setmaxnreg."""
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", sass)]
    return max(regs) + 1 if regs else "not measured"


def build_phase(checks):
    t0 = time.time()
    paths = _cuda.build()
    seconds = time.time() - t0
    ptxas, ok = {}, True
    for name, path in paths.items():
        log = path.with_suffix(".log").read_text() if path.with_suffix(".log").is_file() else ""
        funcs, warnings = _ptxas(log)
        for f in funcs:  # the bf16 kernels: no spills, products on wgmma (HGMMA; IGMMA for int8)
            if "hopper_" in f["function"]:
                sass = _sass(path, f["function"])
                f["hgmma_instructions"] = sass.count("HGMMA")
                f["igmma_instructions"] = sass.count("IGMMA")
                f["gmma_forms"] = sorted(set(re.findall(r"\b[A-Z]*GMMA[\w.]*", sass)))
                if "hopper_attention_kernel" in f["function"]:
                    f["registers_used_after_setmaxnreg"] = _max_sass_register(sass)
                mma = "igmma_instructions" if "int8" in f["function"] else "hgmma_instructions"
                ok = ok and f.get("spill_bytes") == 0 and f[mma] > 0
        ptxas[name] = {"functions": funcs, "warnings": warnings}
    names = [f["function"] for fs in ptxas.values() for f in fs["functions"]]
    ok = ok and all(any(kernel in n for n in names) for kernel in HOPPER_KERNELS)
    emit("build", seconds=seconds, libraries=[p.name for p in paths.values()], ptxas=ptxas,
         bf16_hopper_kernels_spill_free_on_gmma=ok)
    if not ok:
        checks.failed.append("a bf16 Hopper kernel (A, B, C, D or E) missing, spilling or without warpgroup MMA")


def _layer(D, F, H, rng, dora):
    """Random layer params (gwkit layout, init scales like gwkit's) and DoRA adapters."""
    u = lambda *s, fan: torch.from_numpy((rng.uniform(-1, 1, size=s) / np.sqrt(fan)).astype(np.float32))
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
                        "scaling": torch.tensor(4.0)}
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


def _layer_bounds(Bs, T, D, F, H, dt):
    """The bounds (ms, by) of one encoder layer's kernel launches over Bs
    sequences of T tokens: B's two launches (LN1 + QKV, o-projection +
    residual), A, C; each input read once, each output written once."""
    it = torch.tensor([], dtype=dt).element_size()
    M = Bs * T
    qkv_b, qkv_f = it * (M * D + D * 3 * D + 2 * D + M * 3 * D) + 4 * 3 * D, 2 * M * 3 * D * D
    o_b, o_f = it * (M * D + D * D + 2 * M * D) + 4 * D, 2 * M * D * D
    att_b, att_f = it * 4 * M * D, 4 * Bs * H * T * T * (D // H)
    mlp_b, mlp_f = it * (2 * M * D + 2 * D + 2 * D * F) + 4 * (F + D), 4 * M * D * F
    return {"ln_gemm": [bound_ms(qkv_b, qkv_f, dt), bound_ms(o_b, o_f, dt)],
            "attention": [bound_ms(att_b, att_f, dt)], "fused_mlp": [bound_ms(mlp_b, mlp_f, dt)]}


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

        M = Bs * T
        bounds = _layer_bounds(Bs, T, D, F, H, dt)
        qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        timing = {
            "ln_gemm": dict(
                ms=median_ms(lambda: FB.ln_gemm(x2, layer.wqkv, layer.bqkv, ln=ln1))
                + median_ms(lambda: FB.ln_gemm(att2, layer.wo, layer.bo, residual=x2)),
                plain_ms=median_ms(lambda: FB._ln_gemm_reference(x2, layer.wqkv, layer.bqkv, ln1))
                + median_ms(lambda: FB._ln_gemm_reference(att2, layer.wo, layer.bo, None, x2)),
                bound=bounds["ln_gemm"], library_ms=None,
                max_abs_err=max(e_qkv, e_o)),
            "attention": dict(
                ms=median_ms(lambda: A.attention_from_qkv(qkv.view(Bs, T, 3 * D), H)),
                plain_ms=median_ms(lambda: A.reference_attention(q, k, v)),
                bound=bounds["attention"], library_ms=median_ms(sdpa), max_abs_err=e_att),
            "fused_mlp": dict(
                ms=median_ms(lambda: FM.fused_mlp_block(*mlp_args, approx=True)),
                plain_ms=median_ms(lambda: FM._unfused(x1.view(Bs, T, D), layer.ln2_g, layer.ln2_b, layer.w1,
                                                       layer.b1.to(dt), layer.w2, layer.b2.to(dt), True)),
                bound=bounds["fused_mlp"], library_ms=None, max_abs_err=e_mlp),
        }
        timing["attention"].update(
            device_ms=device_ms(lambda: A.attention_from_qkv(qkv.view(Bs, T, 3 * D), H)),
            library_device_ms=device_ms(sdpa))
        # B's two launches and C as one call each; beside them cuBLAS's bare
        # products of the same operands (no LN, bias, GELU or residual)
        b_layer = lambda: (FB.ln_gemm(x2, layer.wqkv, layer.bqkv, ln=ln1), FB.ln_gemm(att2, layer.wo, layer.bo, residual=x2))
        b_gemm = lambda: (torch.matmul(x2, layer.wqkv), torch.matmul(att2, layer.wo))
        h_mid = torch.empty(M, F, dtype=dt, device="cuda")
        c_gemm = lambda: torch.matmul(torch.matmul(x1, layer.w1, out=h_mid), layer.w2)
        for name, call, gemm in (("ln_gemm", b_layer, b_gemm),
                                 ("fused_mlp", lambda: FM.fused_mlp_block(*mlp_args, approx=True), c_gemm)):
            timing[name].update(device_ms=device_ms(call), gemm_ms=median_ms(gemm), gemm_device_ms=device_ms(gemm))
        for name, t in timing.items():
            b_ms = sum(b for b, _ in t["bound"])
            by = t["bound"][0][1]
            rec = dict(name=name, dtype=tag, ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=b_ms,
                       bound_by=by, library_ms=t["library_ms"], max_abs_err=t["max_abs_err"])
            dev = {k: t[k] for k in ("device_ms", "library_device_ms", "gemm_ms", "gemm_device_ms") if k in t}
            emit("timing", shapes="main path layer (256 seq x 256 tokens, D=384, H=6, F=1536)", **rec, **dev)
            if dt == torch.bfloat16:
                records[name] = {**rec, **dev}

        ragged_checks(checks, rng, dt)
        attention_checks(checks, rng, dt)

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


# kernels B and C on 3 x 200 rows: not a multiple of C's 64-row panel, of
# B's 128-row panel or of a two-block cluster's rows
RAGGED_ROWS = 3 * 200


def ragged_checks(checks, rng, dt):
    """Kernels B and C against their plain versions at RAGGED_ROWS rows,
    whisper-tiny and whisper-base widths: B with and without its LN and its
    residual (LN1 + QKV, the o-projection, both, neither), C under both
    GELUs."""
    tol, tag, M = TOL[dt], "f32" if dt == torch.float32 else "bf16", RAGGED_ROWS
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dt)
    for D in (384, 512):
        p, ad = _layer(D, 4 * D, D // 64, rng, True)
        layer = FB.fold_layer(p, ad, D // 64, dt)
        x2, att = normal(M, D), normal(M, D)
        ln1 = (layer.ln1_g, layer.ln1_b)
        for ln, res in ((True, False), (False, True), (True, True), (False, False)):
            w, bias = (layer.wqkv, layer.bqkv) if ln and not res else (layer.wo, layer.bo)
            inp, residual = (x2, att if res else None) if ln else (att, x2 if res else None)
            checks.compare(f"B ragged M={M} D={D} ln={ln} residual={res} {tag}",
                           FB.ln_gemm(inp, w, bias, ln=ln1 if ln else None, residual=residual),
                           FB._ln_gemm_reference(inp, w, bias, ln1 if ln else None, residual), tol)
        x3 = x2.view(1, M, D)
        for approx in (True, False):
            checks.compare(f"C ragged M={M} D={D} {'tanh' if approx else 'erf'} {tag}",
                           FM.fused_mlp_block(x3, layer.ln2_g, layer.ln2_b, layer.w1, layer.b1, layer.w2, layer.b2,
                                              approx=approx),
                           FM._unfused(x3, layer.ln2_g, layer.ln2_b, layer.w1, layer.b1.to(dt), layer.w2,
                                       layer.b2.to(dt), approx), tol)


# kernel A's checks: (T, sequences, score scales). T = 200 and 256 take the
# one-pass path (200 with a ragged last key tile), 300 and 1500 two passes
# (both ragged; 300 pads an odd tile count)
ATTN_CASES = ((200, 16, (1.0, 60.0)), (256, 16, (1.0, 60.0)), (300, 16, (1.0, 60.0)),
              (1500, 64, (1e-3, 1.0, 60.0, 1e3)))


def _attention_inputs(rng, B, T, H, scale, dt):
    q = torch.from_numpy(rng.normal(size=(B, T, H, 64)).astype(np.float32) * scale / 8).cuda().to(dt)
    k, v = (torch.from_numpy(rng.normal(size=(B, T, H, 64)).astype(np.float32)).cuda().to(dt) for _ in range(2))
    return q, k, v


def _sdpa_ms(q, k, v, reps):
    """SDPA on the same inputs: the median of CUDA events around one call,
    and the profiler's device time of one call."""
    qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
    call = lambda: torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
    return median_ms(call, reps), device_ms(call, reps)


def attention_checks(checks, rng, dt):
    """Kernel A against reference_attention on each of its paths (ATTN_CASES)
    under both contracts and in both layouts: K1's through flash_attention on
    contiguous tensors and on in-place views of a fused (B, T, 3D)
    projection, K3's through attention_from_qkv in place and through the
    launch on contiguous tensors; K1 at the training forward's shapes.
    Times at the strict geometry under both contracts and at the training
    forward (K1), SDPA's beside them."""
    H, tag = 6, "f32" if dt == torch.float32 else "bf16"
    lib = _cuda.library("attention")
    for T, B, scales in ATTN_CASES:
        for scale in scales:
            q, k, v = _attention_inputs(rng, B, T, H, scale, dt)
            want = A.reference_attention(q, k, v)
            tol = TOL[dt] if dt == torch.bfloat16 else max(TOL[dt], 4e-6 * scale)
            fused = torch.cat([t.reshape(B, T, H * 64) for t in (q, k, v)], dim=-1)
            views = [fused[..., i * H * 64:(i + 1) * H * 64].view(B, T, H, 64) for i in range(3)]
            k3_contiguous = torch.empty_like(q)
            A._launch(lib, _cuda.stream_of(q), q, k, v, k3_contiguous, B, T, H, H * 64, H * 64, k1=False)
            label = f"T={T} scale={scale:g} {tag}"
            for name, got, ref in (
                    ("K1 attention (K1 contract)", A.flash_attention(q, k, v), want),
                    ("A flash_attention in place (K1 contract)", A.flash_attention(*views), want),
                    ("A attention_from_qkv (K3 contract)", A.attention_from_qkv(fused, H), want.reshape(B, T, -1)),
                    ("A contiguous (K3 contract)", k3_contiguous, want)):
                checks.compare(f"{name} {label}", got, ref, tol)
            if T == 1500 and scale == 1.0:
                b_ms, by = bound_ms(4 * B * T * H * 64 * q.element_size(), 4 * B * H * T * T * 64, dt)
                sdpa, sdpa_dev = _sdpa_ms(q, k, v, 5)
                for contract, call, plain in (
                        ("K1", lambda: A.flash_attention(q, k, v), lambda: A.reference_attention(q, k, v)),
                        ("K3", lambda: A.attention_from_qkv(fused, H), lambda: A.reference_attention(*views))):
                    emit("timing", name="attention", dtype=tag, contract=contract,
                         shapes="strict: 64 seq x 6 heads x T=1500", ms=median_ms(call, 5),
                         plain_ms=median_ms(plain, 5), bound_ms=b_ms, bound_by=by, library_ms=sdpa,
                         device_ms=device_ms(call, 5), library_device_ms=sdpa_dev)
            del q, k, v, want, fused, views, k3_contiguous
    # the training forward, K1 through flash_attention: 128 sequences x 6
    # heads x T = 256 (a train step, timed) and 64 (a short batch). A
    # persistent block takes several items there, so its ring's stage index
    # and parity wrap around.
    for B in (64, 128):
        T = 256
        q, k, v = _attention_inputs(rng, B, T, H, 1.0, dt)
        checks.compare(f"K1 attention (K1 contract) training forward {B}x6xT={T} {tag}", A.flash_attention(q, k, v),
                       A.reference_attention(q, k, v), TOL[dt])
        if B == 128:
            b_ms, by = bound_ms(4 * B * T * H * 64 * q.element_size(), 4 * B * H * T * T * 64, dt)
            sdpa, sdpa_dev = _sdpa_ms(q, k, v, 15)
            emit("timing", name="attention", dtype=tag, contract="K1",
                 shapes="training forward: 128 seq x 6 heads x T=256", ms=median_ms(lambda: A.flash_attention(q, k, v)),
                 plain_ms=median_ms(lambda: A.reference_attention(q, k, v)), bound_ms=b_ms, bound_by=by,
                 library_ms=sdpa, device_ms=device_ms(lambda: A.flash_attention(q, k, v)), library_device_ms=sdpa_dev)
        del q, k, v
    if dt == torch.bfloat16:
        host_cost(lib)
    torch.cuda.empty_cache()


def _per_call_us(call, calls):
    call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def host_cost(lib, n=20000, calls=2000):
    """Host work a call, on the host clock: kernel A's three tensor-map
    encodings of the bf16 path (gw_attention_encode_maps, n times), and the
    whole flash_attention call at 1 x 6 heads x T = 64, kernel B's ln_gemm
    (LN1 + QKV) and kernel C's fused_mlp_block on 64 rows at D = 384, where
    the device's work is far shorter than the host's; with B's and C's
    cluster size and the clusters resident on the card at once."""
    lib.gw_attention_encode_maps.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    q, k, v = (torch.zeros(1, 64, 6, 64, dtype=torch.bfloat16, device="cuda") for _ in range(3))
    _cuda.check(lib.gw_attention_encode_maps(q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, 64, 6, 384, 10), "maps")
    t0 = time.perf_counter()
    _cuda.check(lib.gw_attention_encode_maps(q.data_ptr(), k.data_ptr(), v.data_ptr(), 1, 64, 6, 384, n), "maps")
    maps_us = (time.perf_counter() - t0) / n * 1e6
    call_us = _per_call_us(lambda: A.flash_attention(q, k, v), calls)
    zeros = lambda *sh, dt=torch.bfloat16: torch.zeros(*sh, dtype=dt, device="cuda")
    D, F = 384, 1536
    x, g, b = zeros(64, D), zeros(D), zeros(D)
    w, bias, w1, b1, w2, b2 = zeros(D, 3 * D), zeros(3 * D, dt=torch.float32), zeros(D, F), \
        zeros(F, dt=torch.float32), zeros(F, D), zeros(D, dt=torch.float32)
    ln_gemm_us = _per_call_us(lambda: FB.ln_gemm(x, w, bias, ln=(g, b)), calls)
    fused_mlp_us = _per_call_us(lambda: FM.fused_mlp_block(x.view(1, 64, D), g, b, w1, b1, w2, b2, approx=True),
                                calls)
    clusters = {}
    for name, fn, args in (("ln_gemm", "gw_ln_gemm_clusters", ()), ("fused_mlp", "gw_fused_mlp_clusters", (D,))):
        f = getattr(_cuda.library(name), fn)
        f.argtypes = [ctypes.c_int] * len(args) + [ctypes.c_void_p] * 2
        size, resident = ctypes.c_int(), ctypes.c_int()
        _cuda.check(f(*args, ctypes.byref(size), ctypes.byref(resident)), fn)
        clusters[name] = {"cluster_size": size.value, "clusters_resident": resident.value}
    emit("timing", name="attention host work", dtype="bf16", tensor_maps_us_per_call=maps_us,
         flash_attention_us_per_call=call_us, shapes="1 seq x 6 heads x T=64",
         ln_gemm_us_per_call=ln_gemm_us, fused_mlp_us_per_call=fused_mlp_us,
         ln_gemm_fused_mlp_shapes="64 rows, D=384 (B: LN1 + QKV, N=1152; C: F=1536)", clusters=clusters)


def arithmetic_checks(checks):
    """Kernel A's arithmetic where it is cheaper than the contract's plain
    form, on the card's own code: K3's exp (ex2.approx of x log2 e, rounded
    to bf16) against round(expf(x)) through torch.exp for every bf16 x <= 0,
    and K1's division (Markstein's correction through the reciprocal)
    against the IEEE quotient of torch's tensor division on 4e6 pairs (e in
    (0, 1] down to subnormals, l in [1, 2000] and just above 1), every
    quotient in the normal range."""
    lib, stream = _cuda.library("attention"), torch.cuda.current_stream().cuda_stream
    lib.gw_attention_exp_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.gw_attention_div.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    got = torch.empty(65536, dtype=torch.int16, device="cuda")
    _cuda.check(lib.gw_attention_exp_bf16(got.data_ptr(), stream), "attention exp")
    x = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    want = torch.exp(x.float()).to(torch.bfloat16).view(torch.int16)
    sel = x.float() <= 0
    n_exp = int((got[sel] != want[sel]).sum())
    gen = torch.Generator(device="cuda").manual_seed(4)
    n = 4_000_000
    e = torch.exp(-104 * torch.rand(n, device="cuda", generator=gen))
    l = 1 + 1999 * torch.rand(n, device="cuda", generator=gen)
    l[: n // 4] = 1 + 1e-3 * torch.rand(n // 4, device="cuda", generator=gen)
    q = torch.empty_like(e)
    _cuda.check(lib.gw_attention_div(e.data_ptr(), l.data_ptr(), q.data_ptr(), n, stream), "attention div")
    ieee = e / l
    normal = ieee >= torch.finfo(torch.float32).tiny
    n_div = int((q[normal] != ieee[normal]).sum())
    emit("parity", check="A: K3's exp vs round(expf(x)) on every bf16 x <= 0; K1's division vs IEEE",
         exp_inputs=int(sel.sum()), exp_mismatches=n_exp, div_pairs_normal=int(normal.sum()),
         div_mismatches=n_div, div_subnormal_differing=int((q[~normal] != ieee[~normal]).sum()),
         ok=n_exp == 0 and n_div == 0)
    if n_exp or n_div:
        checks.failed.append("A arithmetic")


def int8_arithmetic_check(checks):
    """Kernel E's quantization (Markstein's correction of v / sx through
    the reciprocal, rint by a float add) against the plain version's IEEE
    division (torch's tensor division) and round half to even, bit for bit:
    every finite bf16 value up to the row's maximum, at 117 row maxima (0,
    below and at the 1e-6 floor, powers of two and their neighbours, 1.5 and
    (2 - 2^-7) times powers of two, random bf16 values from 1e-8 to 1e8)."""
    lib, stream = _cuda.library("int8_gemm"), torch.cuda.current_stream().cuda_stream
    lib.gw_int8_quantize.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    gen = torch.Generator(device="cuda").manual_seed(5)
    k = torch.arange(-30, 31, 3, device="cuda", dtype=torch.float32)
    maxima = torch.cat([torch.tensor([0.0, 1e-7, 1e-6], device="cuda"), 2 ** k, 2 ** k * 1.5, 2 ** k * (2 - 2 ** -7),
                        2 ** k * (1 + 2 ** -7), 10 ** (16 * torch.rand(30, device="cuda", generator=gen) - 8)])
    maxima = maxima.to(torch.bfloat16).float()
    x = torch.arange(65536, dtype=torch.int32, device="cuda").to(torch.int16).view(torch.bfloat16)
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    rows = torch.where(x.float().abs()[None, :] <= maxima[:, None], x[None, :], torch.zeros_like(x)[None, :]).contiguous()
    got = torch.empty(rows.shape, dtype=torch.int8, device="cuda")
    _cuda.check(lib.gw_int8_quantize(rows.data_ptr(), maxima.data_ptr(), got.data_ptr(), rows.shape[0], rows.shape[1],
                                     stream), "int8 quantize")
    want, _ = IG._quantize_rows(rows.float(), row_amax=maxima)
    n_bad = int((got != want).sum())
    emit("parity", check="E: quantization (reciprocal + Markstein's correction) vs IEEE division, every bf16 value",
         rows=rows.shape[0], values=rows.numel(), mismatches=n_bad, ok=n_bad == 0)
    if n_bad:
        checks.failed.append("E quantization arithmetic")


# kernel D's checks: (sequences, T) x score scales; the training shapes and the strict T = 1500
BWD_CASES = ((128, 256), (32, 1500))
BWD_SCALES = (1e-3, 1.0, 60.0, 1e3)


def _bwd_bound(BH, T, it):
    """The bound of K5's function, whatever route computes it: q, k, v, dO
    read and dq, dk, dv written once (``it`` bytes an element), and five
    T x T x 64 products (S, dP, dV, dQ, dK; D = rowsum(p_lo * dP) needs no
    sixth). The row state a design saves is not part of the function."""
    return bound_ms(BH * T * 7 * 64 * it, 10 * BH * T * T * 64, torch.bfloat16 if it == 2 else torch.float32)


def attention_bwd_phase(checks):
    """Kernel D against its plain version (recomputing), f32 and bf16, at
    BWD_CASES x BWD_SCALES, on q, k, v contiguous and as in-place views of a
    fused (B, T, 3D) projection. bf16 runs both routes: from the row state
    that kernel A saves under K1 (the training path) and standalone (A
    first, inside the call); A's output bits must not change when it saves
    the state, and its m, l (f32 tolerances) and o must agree with the plain
    forward's. Reruns must give the same bits. Times at score scale 1 beside
    SDPA's backward, each route beside the plain version of the same
    function (from the state, or recomputing); returns the bf16
    training-shape record."""
    rng = np.random.default_rng(1)
    record = None
    for dt in (torch.float32, torch.bfloat16):
        tag = "f32" if dt == torch.float32 else "bf16"
        for Bs, T in BWD_CASES:
            for scale in BWD_SCALES:
                q = torch.from_numpy(rng.normal(size=(Bs, T, 6, 64)).astype(np.float32) * scale / 8).cuda().to(dt)
                k, v, do = (torch.from_numpy(rng.normal(size=(Bs, T, 6, 64)).astype(np.float32)).cuda().to(dt)
                            for _ in range(3))
                qkv = torch.cat([t.reshape(Bs, T, -1) for t in (q, k, v)], dim=-1)
                views = [qkv[..., i * 384:(i + 1) * 384].view(Bs, T, 6, 64) for i in range(3)]
                want = A.reference_attention_bwd(q, k, v, do)
                tol = TOL[dt] if dt == torch.bfloat16 else max(TOL[dt], 4e-6 * scale)
                label = f"{Bs}x6xT={T} scale={scale:g} {tag}"
                routes = {"standalone": lambda: A.attention_bwd(q, k, v, do),
                          "standalone from fused QKV": lambda: A.attention_bwd(*views, do)}
                if dt == torch.bfloat16:
                    out, state = A.attention_fwd(q, k, v, save_state=True)
                    same_bits = bool(torch.equal(out, A.attention_fwd(q, k, v)))
                    emit("parity", check=f"A under K1: output bits with the row state saved == without, {label}",
                         ok=same_bits)
                    if not same_bits:
                        checks.failed.append(f"A saved state changes output bits {label}")
                    _, plain_state = A.reference_attention(q, k, v, with_state=True)
                    # m and l are f32 values (the f32 tolerance, which grows with the score
                    # scale: s sums 64 products in another order); o sums p rounded to bf16
                    f32_tol = max(TOL[torch.float32], 4e-6 * scale)
                    for n, g, w in zip("mlo", (state.m[:, :T], state.l[:, :T], state.o), plain_state):
                        checks.compare(f"A row state {n} (K1) {label}", g, w, TOL[dt] if n == "o" else f32_tol)
                    _, view_state = A.attention_fwd(*views, save_state=True)
                    routes["saved state"] = lambda: A.attention_bwd(q, k, v, do, state)
                    routes["saved state from fused QKV"] = lambda: A.attention_bwd(*views, do, view_state)
                errs = []
                for route, call in routes.items():
                    got = call()
                    errs += [checks.compare(f"K5 attention_bwd d{n} {route} {label}", g, w, tol)
                             for n, g, w in zip("qkv", got, want)]
                    again = call()
                    same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                    emit("parity", check=f"K5 deterministic {route} {label}", ok=same)
                    if not same:
                        checks.failed.append(f"K5 deterministic {route} {label}")
                    del got, again
                if scale == 1.0:
                    saved = dt == torch.bfloat16
                    b_ms, by = _bwd_bound(Bs * 6, T, q.element_size())
                    qh, kh, vh = (t.permute(0, 2, 1, 3).detach().requires_grad_() for t in (q, k, v))
                    out_h = torch.nn.functional.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
                    doh = do.permute(0, 2, 1, 3)
                    sdpa_bwd = lambda: torch.autograd.grad(out_h, (qh, kh, vh), doh, retain_graph=True)
                    main = routes["saved state" if saved else "standalone"]
                    plain = lambda: A.reference_attention_bwd(q, k, v, do, state if saved else None)
                    reps = 15 if T == 256 else 5
                    rec = dict(name="attention_bwd", dtype=tag, route="saved state" if saved else "standalone",
                               ms=median_ms(main, reps), device_ms=device_ms(main, reps),
                               plain_ms=median_ms(plain, reps), bound_ms=b_ms, bound_by=by,
                               library_ms=median_ms(sdpa_bwd, reps), library_device_ms=device_ms(sdpa_bwd, reps),
                               max_abs_err=max(errs), deterministic=True)
                    if saved:  # the standalone call (kernel A first, then D), the same bound
                        rec.update(standalone_ms=median_ms(routes["standalone"], reps),
                                   standalone_device_ms=device_ms(routes["standalone"], reps),
                                   standalone_plain_ms=median_ms(lambda: A.reference_attention_bwd(q, k, v, do),
                                                                 reps))
                    emit("timing", shapes=f"{Bs} seq x 6 heads x T={T}, hd 64", **rec)
                    if dt == torch.bfloat16 and T == 256:
                        record = rec
                    del qh, kh, vh, out_h
                del q, k, v, do, qkv, views, want, routes
                torch.cuda.empty_cache()
    return record


@contextlib.contextmanager
def plain_stages():
    """Every stage of the fused layer on its plain PyTorch version, on the
    card: the layer's function computed without the kernels (the reference
    of the int8 layer checks and of the int8 search's f32 scores)."""
    def attention_from_qkv(qkv, n_heads):
        B, T, D3 = qkv.shape
        q, k, v = (t.reshape(B, T, n_heads, -1) for t in qkv.split(D3 // 3, dim=-1))
        return A.reference_attention(q, k, v).reshape(B, T, D3 // 3)

    plain = {"int8_gemm": IG._int8_gemm_reference, "ln_gemm": FB._ln_gemm_reference,
             "attention_from_qkv": attention_from_qkv, "flash_attention": A.reference_attention,
             "fused_mlp_block": FM._unfused}
    saved = {name: getattr(FB, name) for name in plain}
    for name, fn in plain.items():
        setattr(FB, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(FB, name, fn)


def _special_rows(t):
    """Rows 0-63 all zero, rows 64-127 exact .5 ties: the largest value is
    127 / 16, so the row scale is 1/16 and every other value / scale is
    k + 0.5 (exact in f32 and bf16)."""
    K = t.shape[1]
    ties = torch.from_numpy(((np.arange(K) % 121) - 60 + 0.5) / 16).float()
    ties[0] = 127 / 16
    t[:64] = 0
    t[64:128] = ties.to(t.dtype).to(t.device)
    return t


def _int_mm_ms(M, K, N):
    """torch._int_mm (cuBLASLt int8 -> int32) at the shapes: the bare int8
    products, a yardstick only (no LN, quantization or epilogue). Returns
    (CUDA-event ms, device ms, error)."""
    a = torch.randint(-127, 128, (M, K), dtype=torch.int8, device="cuda")
    b = torch.randint(-127, 128, (K, N), dtype=torch.int8, device="cuda")
    for operand in (b, b.t().contiguous().t()):
        try:
            torch._int_mm(a, operand)
        except RuntimeError as exc:
            err = str(exc).splitlines()[0]
            continue
        call = lambda: torch._int_mm(a, operand)
        return median_ms(call), device_ms(call), None
    return None, None, err


def _sum(a, b):
    """a + b, or None where either was not measured."""
    return a + b if isinstance(a, float) and isinstance(b, float) else None


def _e_modes(layer, q, x2, att, act_in, x1):
    """Kernel E's modes: name -> (input, projection, LN, GELU, residual,
    extra arguments). fc1 hands each row's maximum out, fc2 takes its
    input's (as the int8 layer chains them)."""
    ln1, ln2 = (layer.ln1_g, layer.ln1_b), (layer.ln2_g, layer.ln2_b)
    amax = act_in.float().abs().amax(dim=-1)
    return {"ln1+qkv": (x2, q.qkv, ln1, None, None, {}), "o+residual": (att, q.o, None, None, x2, {}),
            "ln2+fc1+gelu_tanh": (x1, q.fc1, ln2, "tanh", None, {"return_row_amax": True}),
            "ln2+fc1+gelu_erf": (x1, q.fc1, ln2, "erf", None, {"return_row_amax": True}),
            "fc2+residual": (act_in, q.fc2, None, None, x1, {"row_amax": amax})}


def _e_check(checks, label, inp, proj, ln, act, res, kw, tol, special_rows=False):
    """Kernel E in one mode against its plain version (which takes each
    row's maximum itself); a row maximum handed out must be the output's,
    exactly. ``special_rows``: also report rows 0-127 (_special_rows) apart.
    Returns the max error."""
    got = IG.int8_gemm(inp, proj, ln=ln, act=act, residual=res, **kw)
    if kw.get("return_row_amax"):
        got, amax = got
        exact = bool(torch.equal(amax, got.float().abs().amax(dim=-1)))
        emit("parity", check=f"{label}: row max handed out = max |y| of each row", exact=exact, ok=exact)
        if not exact:
            checks.failed.append(f"{label} row max")
    want = IG._int8_gemm_reference(inp, proj, ln, act, res)
    extra = {"special_rows_max_abs_err": float((got[:128].float() - want[:128].float()).abs().max())} \
        if special_rows else {}
    return checks.compare(label, got, want, tol, flip_rows=FLIP_ROWS, shape=list(got.shape), **extra)


def int8_phase(checks):
    """Kernel E against its plain version in each mode at the main shapes,
    f32 and bf16, with times; the int8 layer in gwkit's three regimes
    against the same chain on plain versions; int8 against the unquantized
    layer. Returns the bf16 main-path record of kernel E."""
    rng = np.random.default_rng(3)
    D, F, H, Bs, T = 384, 1536, 6, 256, 256
    M = Bs * T
    record = None
    for dt in (torch.float32, torch.bfloat16):
        tol = TOL[dt]
        tag = "f32" if dt == torch.float32 else "bf16"
        it = torch.tensor([], dtype=dt).element_size()
        p, ad = _layer(D, F, H, rng, True)
        layer = FB.fold_layer(p, ad, H, dt, quant=True)
        q = layer.int8
        normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).cuda().to(dt)
        x = normal(Bs, T, D)
        x2 = _special_rows(x.view(M, D))
        att, act_in, x1 = _special_rows(normal(M, D)), _special_rows(normal(M, F)), normal(M, D)
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "int_mm_ms", "int_mm_device_ms")
        rec = dict({key: 0.0 for key in keys}, max_abs_err=0.0)
        # per layer: qkv, o, fc1 (tanh), fc2
        for name, (inp, proj, ln, act, res, kw) in _e_modes(layer, q, x2, att, act_in, x1).items():
            call = lambda: IG.int8_gemm(inp, proj, ln=ln, act=act, residual=res, **kw)
            plain = lambda: IG._int8_gemm_reference(inp, proj, ln, act, res)
            err = _e_check(checks, f"E {name} {tag}", inp, proj, ln, act, res, kw, tol, special_rows=True)
            K, N = proj.w.shape
            n_bytes = it * (M * K + M * N + (M * N if res is not None else 0) + (2 * K if ln else 0)) + K * N + 8 * N
            b_ms, by = bound_ms(n_bytes, 2 * M * N * K, dt, peak=H100_INT8_OPS)
            t = dict(ms=median_ms(call), device_ms=device_ms(call), plain_ms=median_ms(plain, 5), bound_ms=b_ms)
            t["int_mm_ms"], t["int_mm_device_ms"], int_mm_err = _int_mm_ms(M, K, N)
            emit("timing", name="int8_gemm", mode=name, dtype=tag, bound_by=by, max_abs_err=err,
                 int_mm_error=int_mm_err, shapes=f"{M} rows x K={K} -> N={N}", **t)
            if name != "ln2+fc1+gelu_erf":  # the main path's four launches a layer
                for key in keys:
                    rec[key] = _sum(rec[key], t[key])
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # the whole int8 layer (fused regime, DoRA, tanh) against the same
        # chain on plain versions, and against the unquantized layer
        assert FB._quant_regime(T, D, F, dt) == "fused"
        x = normal(Bs, T, D)
        got = FB.fused_layer_apply(x, layer, approx=True)
        with plain_stages():
            want = FB.fused_layer_apply(x, layer, approx=True)
        checks.compare(f"int8 layer, fused regime, main shapes, DoRA {tag}", got, want, tol, flip_rows=1.0)
        full_layer = FB.fold_layer(p, ad, H, dt)
        full = FB.fused_layer_apply(x, full_layer, approx=True)
        rel = float((got.float() - full.float()).norm() / full.float().norm())
        emit("parity", check=f"int8 layer vs unquantized layer, relative L2 {tag}", rel_l2=rel, tol=0.03,
             ok=rel < 0.03)
        if not rel < 0.03:
            checks.failed.append(f"int8 vs unquantized {tag}")
        emit("timing", name="int8 layer", dtype=tag, shapes="main path layer (256 seq x 256 tokens)",
             int8_layer_ms=median_ms(lambda: FB.fused_layer_apply(x, layer, approx=True)),
             unquantized_chain_ms=median_ms(lambda: FB.fused_layer_apply(x, full_layer, approx=True)),
             int8_layer_device_ms=device_ms(lambda: FB.fused_layer_apply(x, layer, approx=True)),
             unquantized_chain_device_ms=device_ms(lambda: FB.fused_layer_apply(x, full_layer, approx=True)),
             chains={"int8": "E, A, E, E, E", "unquantized": "B, A, B, C"})
        if dt == torch.bfloat16:
            record = dict(name="int8_gemm", dtype=tag, bound_by="bytes", library_ms=None, **rec)
        del x, x2, att, act_in, x1, got, want, full, layer, full_layer
        torch.cuda.empty_cache()

        # RAGGED_ROWS rows at whisper-tiny and whisper-base widths (fc2 at K = 2048)
        for Dr in (384, 512):
            pr, adr = _layer(Dr, 4 * Dr, Dr // 64, rng, True)
            lr = FB.fold_layer(pr, adr, Dr // 64, dt, quant=True)
            R = RAGGED_ROWS
            for name, (inp, proj, ln, act, res, kw) in _e_modes(lr, lr.int8, normal(R, Dr), normal(R, Dr),
                                                                 normal(R, 4 * Dr), normal(R, Dr)).items():
                _e_check(checks, f"E ragged M={R} D={Dr} {name} {tag}", inp, proj, ln, act, res, kw, tol)

    # the split regime (base at T = 1500, bf16) and the reference regime
    # (tiny at T = 1500, f32), each against the same chain on plain versions
    for (D, F, H, B, dt, regime) in ((512, 2048, 8, 16, torch.bfloat16, "split"),
                                     (384, 1536, 6, 8, torch.float32, "reference")):
        assert FB._quant_regime(1500, D, F, dt) == regime
        p, ad = _layer(D, F, H, rng, True)
        layer = FB.fold_layer(p, ad, H, dt, quant=True)
        x = torch.from_numpy(rng.normal(size=(B, 1500, D)).astype(np.float32)).cuda().to(dt)
        _cuda.reset_counts()
        got = FB.fused_layer_apply(x, layer, approx=True)
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        with plain_stages():
            want = FB.fused_layer_apply(x, layer, approx=True)
        checks.compare(f"int8 layer, {regime} regime, D={D} T=1500 {'bf16' if dt == torch.bfloat16 else 'f32'}",
                       got, want, TOL[dt], flip_rows=1.0, launches=launches)
        del p, ad, layer, x, got, want
        torch.cuda.empty_cache()
    return record


def _flat_grads(tree):
    from gwkit_torch.io import tree_leaves

    return [t.grad for t in tree_leaves(tree)]


def _with_grad(tree):
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_grad(v) for v in tree]
    return tree.detach().clone().requires_grad_() if isinstance(tree, torch.Tensor) else tree


def layer_grad_phase(checks):
    """The layer's gradients through FusedBlock (forward chain B-A-B-C,
    backward recompute with kernel A under K1's contract and kernel D)
    against autograd of the plain layer (whisper._block), f32 per leaf."""
    from gwkit_torch.io import tree_leaves
    from gwkit_torch.models.whisper import _block, config_for

    rng = np.random.default_rng(2)
    D, F, H = 384, 1536, 6
    p, ad = _layer(D, F, H, rng, True)
    x = torch.from_numpy(rng.normal(size=(128, 256, D)).astype(np.float32)).cuda()
    w = torch.from_numpy(rng.normal(size=(128, 256, D)).astype(np.float32)).cuda()
    cfg = config_for("tiny", gelu_approx=True)
    sides = []
    for fused in (True, False):
        xs, ps, ads = x.clone().requires_grad_(), _with_grad(p), _with_grad(ad)
        out = FB.fused_encoder_block(xs, ps, H, ads, approx=True) if fused else _block(xs, ps, cfg, ads)
        (out * w).sum().backward()
        sides.append([xs.grad] + _flat_grads(ps) + _flat_grads(ads))
    names = ["x"] + [f"p{i}" for i in range(len(tree_leaves(p)))] + [f"adapter{i}" for i in range(len(tree_leaves(ad)))]
    worst = 0.0
    for name, g, r in zip(names, *sides):
        err, ref = float((g - r).abs().max()), float(r.abs().max())
        worst = max(worst, err / ref)
        if not (torch.isfinite(g).all() and err <= 1e-3 * ref):
            checks.failed.append(f"FusedBlock grad {name} f32")
    emit("parity", check="FusedBlock layer gradients vs autograd of the plain layer, f32 (128 x 256, D=384)",
         leaves=len(names), worst_max_err_over_max_grad=worst, tol=1e-3, ok=worst <= 1e-3)


def _kernel_group(name):
    low = name.lower()
    for key in ("attention_kernel", "dq_kernel", "dkdv_kernel", "ln_gemm_kernel", "fused_mlp_kernel",
                "int8_gemm_kernel"):
        if key in low:
            return key
    if "nccl" in low:
        return "nccl (collectives)"
    if "fft" in low:
        return "fft (whitening, Q-scan, resampling, STFT)"
    if any(k in low for k in ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")):
        return "convolution (stem, Q-adapter)"
    if any(k in low for k in ("gemm", "cutlass", "nvjet", "xmma")):
        return "library gemm (projections, head, pooling, mel bank)"
    if "sort" in low or "radix" in low:
        return "sort (medians)"
    return "other (elementwise, gathers, reductions)"


def profiled(phase, fn, **extra):
    """Run ``fn`` once under torch.profiler and emit the device time by
    kernel group and the device's busy share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    groups, top, launches = {}, [], 0
    for evt in prof.key_averages():
        if "cuda" not in str(getattr(evt, "device_type", "")).lower():
            continue
        us = float(getattr(evt, "self_device_time_total", 0.0) or 0.0)
        if us <= 0:
            continue
        g = _kernel_group(evt.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
        launches += evt.count
        top.append((us / 1e3, evt.key[:80], evt.count))
    device_ms = sum(groups.values())
    top.sort(reverse=True)
    emit(phase, **extra, wall_ms_profiled=wall_ms, device_ms=device_ms if device_ms else "not measured",
         device_busy_share=device_ms / wall_ms if device_ms else "not measured", device_kernels=launches,
         device_ms_by_group={k: v for k, v in sorted(groups.items(), key=lambda kv: -kv[1])},
         top_kernels=[{"ms": t, "name": n, "count": c} for t, n, c in top[:14]])
    return groups


def _capstone_search_task():
    """The capstone model as the search CLI loads it: device=None, the card,
    bf16, the kernel chain."""
    from gwkit_torch.cli.inference import load_task_from_components

    files = (f"{CAPSTONE}/run/best_lora_weights", f"{CAPSTONE}/run/best_dense_layers.npz",
             f"{CAPSTONE}/run/best_adapter.npz")
    return load_task_from_components(*files, pretrained_encoder=f"{CAPSTONE}/encoder_pretrained.npz",
                                     target_shape=(80, 512))


def search_phase(checks, smi):
    from gwkit_torch.search.cluster import get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    t0 = time.time()
    task = _capstone_search_task()
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
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
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
    profiled("profile", lambda: score_segments(score, [seg], cfg, trigger_threshold=threshold, device=dev))

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
    return dict(launches=launches, threshold=threshold, bf16_scores=bf16_scores, span=span,
                trigger_times=_trigger_times(res.triggers), task=task, all_vals=res.all_vals, segment=seg, cfg=cfg,
                clusters=np.vstack([times, stats, np.full(len(times), 0.2)]))


def _trigger_times(triggers):
    return {t for trig in triggers.values() for t, _ in trig}


GET_STATS_KEYS = ("fg-events", "found-indices", "missed-indices", "true-positive-event-indices",
                  "false-positive-event-indices", "sorting-indices", "true-positive-diffs", "false-positive-diffs",
                  "true-positives", "false-positives", "fg-far", "far", "sensitive-volume", "sensitive-distance",
                  "sensitive-volume-error", "sensitive-fraction")


def _challenge_stats(fg, bg, inj, duration):
    """get_stats of foreground clusters ``fg`` (3, K: times, stats, time
    variances) against background clusters ``bg``, summarized: counts, the
    sensitive distance at FAR <= 1e3 and 1e2 a month, ``well_formed`` (the
    keys, finite values, non-increasing FARs) and ``counts_agree`` (found
    injections and the sensitive fraction at every background stat equal
    to a plain count, at least one injection found)."""
    from gwkit_torch.evaluation.mlgwsc import get_stats
    from gwkit_torch.search.cluster import SECONDS_PER_MONTH

    times, stats, tvars = fg
    st = get_stats(fg, bg, inj, duration=duration)
    far_month = st["far"] * SECONDS_PER_MONTH

    def distance_at(limit):
        sel = far_month <= limit
        return float(st["sensitive-distance"][sel].max()) if sel.any() else None

    well_formed = (tuple(st) == GET_STATS_KEYS
                   and all(np.isfinite(np.asarray(v, np.float64)).all() for v in st.values())
                   and bool(np.all(np.diff(st["far"]) <= 0)) and bool(np.all(np.diff(st["fg-far"]) <= 0)))
    # the plain count: an injection is found when a cluster lies within the
    # cluster's time variance of its tc (injections further apart than two
    # variances, so no cluster is near two), with its loudest such cluster's
    # stat; found at a background stat when louder than it
    near = np.abs(times[None, :] - inj["tc"][:, None]) <= tvars[None, :]  # (injections, clusters)
    best = np.where(near, stats[None, :], -np.inf).max(axis=1, initial=-np.inf)
    plain_found = int(np.isfinite(best).sum())
    plain_fraction = (best[None, :] > np.sort(bg[1])[:, None]).sum(axis=1) / len(best)
    found = int(len(np.unique(st["found-indices"][st["true-positive-event-indices"]])))
    return dict(
        foreground_clusters=int(len(times)), true_positives=int(len(st["true-positive-event-indices"])),
        false_positives=int(len(st["false-positive-event-indices"])),
        found_injections=found, plain_found_injections=plain_found,
        sensitive_distance_far_le_1e3_per_month=distance_at(1e3),
        sensitive_distance_far_le_1e2_per_month=distance_at(1e2),
        # a background of T seconds resolves no FAR below one event in T
        sensitive_distance_at_lowest_nonzero_far=distance_at(far_month[far_month > 0].min())
        if (far_month > 0).any() else None,
        loudest_injection_found_stat=float(st["true-positives"][1].max()) if st["true-positives"].size else None,
        best_found_fraction=float(st["sensitive-fraction"].max()) if len(st["sensitive-fraction"]) else None,
        well_formed=well_formed,
        counts_agree=found == plain_found > 0 and np.array_equal(st["sensitive-fraction"], plain_fraction))


def stream_search_phase(checks, smi, bf16):
    """Phase 4c: phase 4's bf16 task and threshold on a 300 s segment of
    independent noise (another seed than phase 4's) with 20 chirps added.
    The exact search, then the streaming search (a warm pass, then a timed
    pass each); the streaming pass's launches; its first 4 batches against
    the f32 plain path; the challenge statistics of both searches against
    phase 4's noise-only clusters, their found injections and sensitive
    fractions held against a plain count. Returns the streaming pass's
    launches."""
    from gwkit_torch.search.cluster import SECONDS_PER_MONTH, get_clusters
    from gwkit_torch.search.engine import score_segments, stream_search_kwargs
    from gwkit_torch.search.slicer import Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    task, threshold = bf16["task"], bf16["threshold"]
    enc = task.cfg.encoder
    fs, seconds, n_inj = 2048, 300.0, 20
    rng = np.random.default_rng(20)
    waves, tc_local = _chirps(n_inj, rng, with_tc=True)
    snr = rng.uniform(8.0, 30.0, n_inj)
    starts = 5.0 + 14.0 * np.arange(n_inj) + rng.uniform(0.0, 4.0, n_inj)
    # foreground noise independent of phase 4's background (seed 0)
    strain = (np.random.default_rng(1).normal(size=(2, int(seconds * fs))) * 1e-21).astype(np.float32)
    for w, a, t0 in zip(waves, snr, starts):
        i = int(round(t0 * fs))
        strain[:, i:i + fs] += (a * 1e-21 * w).astype(np.float32)  # white noise of unit variance: SNR a
    # injection table: distance falls as the SNR rises (a source at 1500 Mpc at SNR 8)
    inj = {"tc": starts + tc_local, "distance": 1500.0 * 8.0 / snr, "mass1": rng.uniform(10.0, 50.0, n_inj),
           "mass2": rng.uniform(10.0, 50.0, n_inj)}
    seg = Segment(key="smoke_injections", strain=strain, start_time=0.0, delta_t=1.0 / fs)
    cfg = SlicerConfig(batch_size=128)
    dev = torch.device("cuda")
    saved, n_spec = [], [0]

    def score_spec(qspec):
        n_spec[0] += 1
        if len(saved) < 4:  # the warm pass's first 4 batches, for the f32 check
            saved.append(qspec.clone())
        return task.score_spec(qspec)

    stream_kw = {**stream_search_kwargs(task), "stream_score_fn": score_spec}
    runs = {}
    for name, kw in (("exact", {}), ("stream", stream_kw)):
        warm = score_segments(task.score, [seg], cfg, trigger_threshold=threshold, device=dev, **kw)
        n_spec[0] = 0
        _cuda.reset_counts()
        res = score_segments(task.score, [seg], cfg, trigger_threshold=threshold, device=dev, **kw)
        runs[name] = (warm, res, dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS), n_spec[0])
    exact, stream = runs["exact"][1], runs["stream"][1]
    _, _, launches, plain, nb = runs["stream"]
    nl = enc.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    ok = launches == expect and not plain and nb > 0
    t_exact, t_stream = _trigger_times(exact.triggers), _trigger_times(stream.triggers)
    union = t_exact | t_stream
    emit("search_stream", card=smi, seconds=seconds, injections=n_inj, windows=stream.n_windows, batches=nb,
         threshold=threshold, launches=launches, expected_launches=expect, plain_calls=plain, ok=ok,
         strain_seconds_per_second={"exact": exact.throughput_x_realtime, "stream": stream.throughput_x_realtime},
         warm_strain_seconds_per_second={k: runs[k][0].throughput_x_realtime for k in runs},
         wall_s={"exact": exact.wall_seconds, "stream": stream.wall_seconds},
         triggers={"exact": len(t_exact), "stream": len(t_stream)},
         score_correlation_stream_vs_exact=float(np.corrcoef(stream.all_vals, exact.all_vals)[0, 1]),
         max_abs_score_diff_stream_vs_exact=float(np.abs(stream.all_vals - exact.all_vals).max()),
         trigger_jaccard_stream_vs_exact=len(t_exact & t_stream) / len(union) if union else 1.0)
    if not ok:
        checks.failed.append("stream launch counters")
    assert stream.n_windows == exact.n_windows == 3000 and len(stream.all_vals) == 3000
    assert np.isfinite(stream.all_vals).all() and np.isfinite(exact.all_vals).all()
    profiled("profile_stream", lambda: score_segments(task.score, [seg], cfg, trigger_threshold=threshold, device=dev,
                                                      **stream_kw))

    # the streaming pass's first 4 batches on the f32 plain path (the reference)
    task32 = build_mlgwsc(dataclasses.replace(enc, compute_dtype=torch.float32, fused_block=False), task.qcfg,
                          task.params, device=dev)
    with torch.no_grad():
        ref = torch.cat([task32.score_spec(q) for q in saved]).float().cpu()
    del task32, saved
    got = torch.from_numpy(stream.all_vals[: 4 * 128])
    span = float(ref.max() - ref.min())
    d = (got - ref).abs()
    tol = {k: v * span for k, v in SEARCH_BF16_TOL.items()}
    ok_bf16 = float(d.max()) <= tol["max"] and float(d.mean()) <= tol["mean"]
    emit("parity", check="stream search scores: bf16 kernels vs f32 plain (first 4 batches)",
         max_abs_err=float(d.max()), mean_abs_err=float(d.mean()), f32_score_span=span,
         correlation=float(np.corrcoef(got.numpy(), ref.numpy())[0, 1]), tol_of_span=SEARCH_BF16_TOL, tol=tol,
         ok=ok_bf16)
    if not ok_bf16:
        checks.failed.append("bf16 stream search scores")

    # the challenge statistics: each search's clusters as foreground, phase 4's noise-only clusters as background
    evaluation = {}
    for name, res in (("exact", exact), ("stream", stream)):
        evaluation[name] = ev = _challenge_stats(np.vstack(get_clusters(res.triggers)), bf16["clusters"], inj, seconds)
        if not ev["well_formed"]:
            checks.failed.append(f"get_stats ({name} search)")
        if not ev["counts_agree"]:
            checks.failed.append(f"get_stats found injections vs plain count ({name} search)")
    emit("evaluate", background_clusters=int(bf16["clusters"].shape[1]), injections=n_inj, duration_s=seconds,
         loudest_background_stat=float(bf16["clusters"][1].max()),
         far_per_month_of_one_background_event=SECONDS_PER_MONTH / seconds, **evaluation,
         ok=all(v["well_formed"] and v["counts_agree"] for v in evaluation.values()))
    return launches


def int8_search_phase(checks, smi, bf16):
    """Phase 4's search with int8 projections: launches, throughput, scores
    against the f32 plain int8 path and against phase 4's bf16 scores.
    Returns (launches, the int8 task)."""
    from gwkit_torch.cli.inference import load_task_from_components
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_mlgwsc

    files = (f"{CAPSTONE}/run/best_lora_weights", f"{CAPSTONE}/run/best_dense_layers.npz",
             f"{CAPSTONE}/run/best_adapter.npz")
    t0 = time.time()
    task = load_task_from_components(*files, pretrained_encoder=f"{CAPSTONE}/encoder_pretrained.npz",
                                     target_shape=(80, 512), quant_int8=True)
    load_s = time.time() - t0
    enc = task.cfg.encoder
    assert enc.quant_int8 and enc.fused_block and enc.compute_dtype == torch.bfloat16 and enc.gelu_approx

    fs, seconds = 2048, 300.0
    strain = (np.random.default_rng(0).normal(size=(2, int(seconds * fs))) * 1e-21).astype(np.float32)
    seg = Segment(key="smoke", strain=strain, start_time=0.0, delta_t=1.0 / fs)
    cfg = SlicerConfig(batch_size=128)
    dev = torch.device("cuda")
    n_batches = [0]

    def score(windows):
        n_batches[0] += 1
        return task.score(windows)

    warm = score_segments(score, [seg], cfg, trigger_threshold=bf16["threshold"], device=dev)
    n_batches[0] = 0
    _cuda.reset_counts()
    res = score_segments(score, [seg], cfg, trigger_threshold=bf16["threshold"], device=dev)
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    nb, nl = n_batches[0], enc.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 0, "fused_mlp": 0, "int8_gemm": 4 * nl * nb}
    ok = launches == expect and not plain
    times = _trigger_times(res.triggers)
    union = times | bf16["trigger_times"]
    jaccard = len(times & bf16["trigger_times"]) / len(union) if union else 1.0
    emit("search_int8", card=smi, seconds=seconds, windows=res.n_windows, batches=nb,
         triggers=sum(len(v) for v in res.triggers.values()), threshold=bf16["threshold"],
         wall_s=res.wall_seconds, strain_seconds_per_second=res.throughput_x_realtime,
         warm_strain_seconds_per_second=warm.throughput_x_realtime, load_s=load_s, launches=launches,
         expected_launches=expect, plain_calls=plain, ok=ok, trigger_jaccard_vs_bf16=jaccard,
         scores_finite=bool(np.isfinite(res.all_vals).all()))
    if not ok:
        checks.failed.append("int8 launch counters")
    assert res.n_windows == 3000 and len(res.all_vals) == 3000 and np.isfinite(res.all_vals).all()
    profiled("profile_int8", lambda: score_segments(score, [seg], cfg, trigger_threshold=bf16["threshold"],
                                                    device=dev))

    batches = []
    for windows, _, valid in DeviceSlicer(seg, cfg, device=dev).batches():
        assert valid.all()
        batches.append(windows)
        if len(batches) == 4:
            break
    int8_scores = torch.from_numpy(res.all_vals[: 4 * 128])
    task32 = build_mlgwsc(dataclasses.replace(enc, compute_dtype=torch.float32), task.qcfg, task.params, device=dev)
    with torch.no_grad():
        k32 = torch.cat([task32.score(w) for w in batches]).float().cpu()
        with plain_stages():
            ref = torch.cat([task32.score(w) for w in batches]).float().cpu()
            # the int8 function's own sensitivity: the same windows, each value moved by 2e-7 relative
            gen = torch.Generator(device="cuda").manual_seed(1)
            nudged = torch.cat([task32.score(w * (1 + 2e-7 * (2 * torch.randint(0, 2, w.shape, device=dev,
                                                                                  generator=gen) - 1)))
                                for w in batches]).float().cpu()
    span = float(ref.max() - ref.min())
    # f32 kernels vs f32 plain, both int8: a flipped quantum moves a score
    # by up to about 2e-3 of the largest (tests/test_torch_quant.py, the
    # capstone on the CPU), so the max is held at 5e-3 and the mean at 1e-3
    err = (k32 - ref).abs()
    ok32 = float(err.max()) <= 5e-3 * float(ref.abs().max()) and float(err.mean()) <= 1e-3 * float(ref.abs().mean())
    emit("parity", check="int8 search scores: f32 kernels vs f32 plain int8 path (first 4 batches)",
         max_abs_err=float(err.max()), mean_abs_err=float(err.mean()), max_abs_ref=float(ref.abs().max()),
         mean_abs_ref=float(ref.abs().mean()), sensitivity_max_abs=float((nudged - ref).abs().max()),
         tol={"max": 5e-3 * float(ref.abs().max()), "mean": 1e-3 * float(ref.abs().mean())}, ok=ok32)
    if not ok32:
        checks.failed.append("int8 f32 search scores")
    for label, other, tol_of_span in (("bf16 int8 kernels vs f32 plain int8 path", ref, SEARCH_BF16_TOL),
                                      ("int8 (bf16 kernels) vs phase 4's bf16 scores", bf16["bf16_scores"],
                                       SEARCH_INT8_TOL)):
        s = bf16["span"] if other is bf16["bf16_scores"] else span
        d = (int8_scores - other).abs()
        tol = {k: v * s for k, v in tol_of_span.items()}
        ok_d = float(d.max()) <= tol["max"] and float(d.mean()) <= tol["mean"]
        emit("parity", check=f"search scores: {label} (first 4 batches)", max_abs_err=float(d.max()),
             mean_abs_err=float(d.mean()), f32_score_span=s, max_of_span=float(d.max()) / s,
             mean_of_span=float(d.mean()) / s, tol_of_span=tol_of_span, tol=tol, ok=ok_d)
        if not ok_d:
            checks.failed.append(label)
    del task32
    return launches, task


def server_phase(checks, task):
    """A ScoringServer on the int8 task, served from a thread over a Unix
    socket: ping, a request for a missing file, shutdown."""
    from gwkit_torch.serve import ScoringServer, request

    with tempfile.TemporaryDirectory() as td:
        sock = os.path.join(td, "gw.sock")
        server = ScoringServer(task, sock, batch_size=128)
        server.bind()
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            pong = request(sock, {"cmd": "ping"}, timeout=60)
            missing = request(sock, {"input": os.path.join(td, "missing.hdf"), "output": os.path.join(td, "o.hdf")},
                              timeout=60)
        finally:
            bye = request(sock, {"cmd": "shutdown"}, timeout=60)
        thread.join(timeout=60)
        ok = (pong.get("ok") and pong.get("pong") and not missing.get("ok") and "no such input" in missing["error"]
              and bye.get("bye") and not thread.is_alive() and not os.path.exists(sock))
    emit("serve", task="int8 capstone (bf16, kernel E)", ping=pong, missing_file=missing, shutdown=bye,
         thread_joined=not thread.is_alive(), socket_removed=True, ok=bool(ok),
         note="scored requests read HDF5, and this machine has no h5py: tests/test_torch_serve.py scores "
              "them on the CPU")
    if not ok:
        checks.failed.append("serve")


def _chirps(n, rng, fs=2048, with_tc=False):
    """n two-detector chirp-like waveforms of 1 s, each detector scaled to
    unit norm (so the dataset's SNR factor sets the amplitude); with
    ``with_tc`` also each one's envelope peak in seconds."""
    t = np.arange(fs) / fs
    out = np.zeros((n, 2, fs), np.float32)
    tcs = np.zeros(n)
    for i in range(n):
        f0, f1, tc = rng.uniform(30, 60), rng.uniform(150, 400), rng.uniform(0.5, 0.9)
        tcs[i] = tc
        phase = 2 * np.pi * (f0 * t + 0.5 * (f1 - f0) * t ** 2 / tc)
        env = np.exp(-((t - tc) / 0.12) ** 2)
        for d in range(2):
            h = np.sin(phase + rng.uniform(0, 2 * np.pi)) * env
            out[i, d] = h / np.linalg.norm(h)
    return (out, tcs) if with_tc else out


def _grad_groups(task, batch, summed_logits=False):
    """Gradients of the task's loss on ``batch`` (no dropout), or with
    ``summed_logits`` of the sum of its logits, flattened per group of the
    trainable tree (adapters, encoder, head, qadapter)."""
    from gwkit_torch.io import tree_leaves

    tr = _with_grad(task.trainable)
    if summed_logits:
        loss = task.apply(tr, task.frozen, batch[0]).float().sum()
    else:
        loss, _ = task.loss_fn(tr, task.frozen, batch)
    grads = torch.autograd.grad(loss, tree_leaves(tr), allow_unused=True)
    out, i = {}, 0
    for key in sorted(tr):  # tree_leaves' order
        leaves = tree_leaves(tr[key])
        out[key] = torch.cat([(torch.zeros_like(t) if g is None else g).float().flatten()
                              for t, g in zip(leaves, grads[i:i + len(leaves)])])
        i += len(leaves)
    return out


def _cosine(a, b):
    return float(torch.dot(a, b) / (a.norm() * b.norm()))


def _gradient_gate(checks, label, g_k, g_p, f32=False):
    """Per group, kernels against the plain layer: in bf16 cosine >= 0.99 and
    norm ratio 0.95-1.05 (phase 5's gate); in f32 max |diff| <= 1e-3 x
    max |g| (the layer gradient parity of PERF.md section 2)."""
    for key in g_k:
        a, b = g_k[key], g_p[key]
        cos, ratio = _cosine(a, b), float(a.norm() / b.norm())
        if f32:
            err, ref = float((a - b).abs().max()), float(b.abs().max())
            ok, tol = err <= 1e-3 * ref, {"max_abs": 1e-3 * ref}
            extra = {"max_abs_err": err, "max_abs_ref": ref}
        else:
            ok, tol, extra = cos >= 0.99 and 0.95 <= ratio <= 1.05, {"cosine": 0.99, "norm_ratio": [0.95, 1.05]}, {}
        emit("parity", check=f"{label} gradients, {key}: kernels vs plain layer ({'f32' if f32 else 'bf16'})",
             cosine=cos, norm_ratio=ratio, tol=tol, ok=ok, **extra)
        if not ok:
            checks.failed.append(f"{label} gradients {key}")


def train_phase(checks, smi):
    """The capstone recipe through Trainer.fit on the kernels; returns the
    launches of kernel D (and the others) in this phase."""
    from gwkit_torch.cli.inference import _load_gwkit_encoder, load_task_from_components
    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.adapters import AdapterConfig
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import config_for
    from gwkit_torch.train.tasks import build_mlgwsc
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    frames, batch = 512, 64
    enc_cfg = config_for("tiny", compute_dtype=torch.bfloat16, fused_block=True, gelu_approx=True,
                         max_positions=frames // 2)
    encoder = from_gwkit_numpy(encoder=_load_gwkit_encoder(f"{CAPSTONE}/encoder_pretrained.npz", "tiny",
                                                           enc_cfg))["encoder"]
    qcfg = QAdapterConfig(median_stride=8, target_shape=(80, frames))
    acfg = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo")
    task = build_mlgwsc(enc_cfg, qcfg, {"encoder": encoder}, usr=False, device=dev, acfg=acfg, seed=0)

    rng = np.random.default_rng(0)
    snr = (7.0, 20.0)
    train = InjectionDataset(rng.normal(size=(1024, 2, 2048)).astype(np.float32), _chirps(512, rng), snr, dev)
    valid = InjectionDataset(rng.normal(size=(256, 2, 2048)).astype(np.float32), _chirps(128, rng), snr, dev)

    # the step's gradients on the kernels against the plain layer, bf16, per group
    probe = next(train.batches(torch.Generator().manual_seed(5), batch))
    plain = build_mlgwsc(dataclasses.replace(enc_cfg, fused_block=False), qcfg, task.params, usr=False,
                         device=dev, acfg=acfg)
    g_k, g_p = _grad_groups(task, probe), _grad_groups(plain, probe)
    _gradient_gate(checks, "train-step", g_k, g_p)
    del plain, g_k, g_p

    counts = {"train": 0, "valid": 0}

    def counted(kind, it):
        for b in it:
            counts[kind] += 1
            yield b

    cfg = TrainConfig(learning_rate=3e-4, clip_norm=100.0, epochs=2, batch_size=batch, early_stop_patience=2,
                      optimizer="adam", seed=0)
    trainer = Trainer(task.loss_fn, task.trainable, task.frozen, cfg, export_components=task.export_components)
    epochs = []
    with tempfile.TemporaryDirectory() as out:
        _cuda.reset_counts()
        t0 = time.time()
        best = trainer.fit(lambda g: counted("train", train.batches(g, batch)),
                           lambda g: counted("valid", valid.batches(g, batch, shuffle=False, drop_remainder=False)),
                           outdir=out)
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        launches, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        lines = open(os.path.join(out, "losses.txt")).read().splitlines()
        epochs = [[float(v) for v in ln.split("\t")[1:]] for ln in lines]
        files = [os.path.join(out, n) for n in ("best_lora_weights", "best_dense_layers.npz", "best_adapter.npz")]
        written = all(os.path.exists(f) for f in files) and os.path.isfile(os.path.join(out, "last.ckpt"))
        served = load_task_from_components(*files, pretrained_encoder=f"{CAPSTONE}/encoder_pretrained.npz",
                                           target_shape=(80, frames))
        scores = served.score(probe[0][:16]).float().cpu().numpy()

    nt, nv, L = counts["train"], counts["valid"], enc_cfg.n_layers
    expect = {"attention": 2 * L * nt + L * nv, "attention_bwd": L * nt, "ln_gemm": 2 * L * (nt + nv),
              "fused_mlp": L * (nt + nv), "int8_gemm": 0}
    finite = bool(np.isfinite(np.asarray(epochs)).all()) and len(epochs) == 2
    ok = launches == expect and not plain_calls and finite and written and bool(np.isfinite(scores).all())

    # steps per second: three timed windows of 8 more steps (the host-bound
    # step spreads from window to window), then a profiled window of 3
    steps = list(train.batches(torch.Generator().manual_seed(9), batch))[:8]
    trainer.run_epoch(steps[:1])
    window_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.run_epoch(steps)
        torch.cuda.synchronize()
        window_s.append((time.time() - t0) / len(steps))
    step_s = statistics.median(window_s)
    emit("train", card=smi, recipe="capstone: whisper-tiny (capstone encoder, frozen), DoRA r=8 a=32 qkvo, "
         "Q-adapter median_stride=8 at (80, 512), batch 64 (128 sequences x 256 tokens), bf16, Adam 3e-4, clip 100",
         train_steps=nt, valid_batches=nv, losses=epochs, best_val=best, fit_s=fit_s,
         launches=launches, expected_launches=expect, launches_per_train_step={"attention": 2 * L,
         "attention_bwd": L, "ln_gemm": 2 * L, "fused_mlp": L}, plain_calls=plain_calls,
         exports_written=written, exported_scores=scores[:4].tolist(), step_ms=step_s * 1e3,
         steps_per_s=1 / step_s, samples_per_s=batch / step_s,
         samples_per_s_by_window=[batch / w for w in window_s], fit_samples_per_s=batch * nt / fit_s,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
         ok=ok)
    if not ok:
        checks.failed.append("train phase")
    profiled("train_profile", lambda: trainer.run_epoch(steps[:3]), steps=3)
    return launches

MEL_BATCH, MEL_BATCHES, MEL_TRAIN_BATCH = 64, 8, 16
# bf16 logits on the kernels may lie at most this many times as far from the
# f32 plain path as the plain bf16 layer's (PERF.md section 2: at T = 1500 on
# random weights the logits' sample-to-sample span is below bf16's resolution,
# so the span gate of the search reads rounding, not the kernels)
BF16_VS_PLAIN = 2.0


def _perturb_lora_b(task, seed):
    """Non-zero LoRA B (drawn from a torch seed), so DoRA's low-rank path counts."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for layer in task.trainable.get("adapters") or []:
            for entry in layer.values():
                entry["b"].copy_(torch.randn(entry["b"].shape, generator=gen) * 0.02)


def _mel_gate(checks, label, task, strain):
    """The card's log-mel (cuFFT, cuBLAS) against the plain CPU path on the
    same strain: 2e-3 absolute, gwkit's bound against float64."""
    with torch.no_grad():
        card = torch.cat(task.log_mels(strain)).cpu()
        cpu = torch.cat(task.log_mels(strain.cpu()))
    err = float((card - cpu).abs().max())
    ok = bool(torch.isfinite(card).all()) and err <= 2e-3 and card.shape[-2:] == (80, task.n_frames)
    emit("parity", check=f"{label}: log-mel on the card vs the plain CPU path", max_abs_err=err,
         mean_abs_err=float((card - cpu).abs().mean()), shape=list(card.shape), tol=2e-3, ok=ok)
    if not ok:
        checks.failed.append(f"{label} log-mel")


def _mel_forward(checks, smi, label, task, batches, samples_per_batch):
    """The counted forward over ``batches`` (exactly 4 A, 8 B and 4 C a batch,
    no plain call), samples/s, a profiled pass; then against the f32 plain
    path: every token of the first batch's encoder output in bf16 on the
    kernels (TOL), the first 2 batches' logits in f32 on the kernels (1e-3)
    and in bf16 (BF16_VS_PLAIN times the plain bf16 layer's distance; the
    span gate of the search printed beside it)."""
    from gwkit_torch.models.whisper import WhisperEncoder

    enc = task.cfg.encoder
    task.forward(batches[0])  # prepares (folds) the encoder; cuDNN picks its algorithms
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.time()
    logits = [task.forward(x) for x in batches]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    nb, nl = len(batches), enc.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    out = torch.cat(logits).float()
    ok = launches == expect and not plain and bool(torch.isfinite(out).all()) and \
        out.shape == (nb * samples_per_batch, task.cfg.num_classes)
    emit(label, card=smi, batches=nb, samples=nb * samples_per_batch,
         sequences=nb * samples_per_batch * task.cfg.n_detectors, tokens_per_sequence=task.n_frames // 2,
         wall_s=wall, samples_per_s=nb * samples_per_batch / wall, launches=launches, expected_launches=expect,
         plain_calls=plain, logits_finite=bool(torch.isfinite(out).all()), ok=ok)
    if not ok:
        checks.failed.append(f"{label} launch counters")
    groups = profiled(f"{label}_profile", lambda: [task.forward(x) for x in batches], batches=nb,
                      samples=nb * samples_per_batch)
    seqs, T = samples_per_batch * task.cfg.n_detectors, task.n_frames // 2
    bounds = _layer_bounds(seqs, T, enc.d_model, enc.d_ff, enc.n_heads, enc.compute_dtype)
    per_launch = {}
    for name, group, per_layer in (("attention", "attention_kernel", 1), ("ln_gemm", "ln_gemm_kernel", 2),
                                   ("fused_mlp", "fused_mlp_kernel", 1)):
        b = bounds[name]
        per_launch[name] = {"device_ms_per_layer": groups.get(group, 0.0) * per_layer / max(launches[name], 1),
                            "bound_ms_per_layer": sum(x[0] for x in b), "bound_by": [x[1] for x in b],
                            "launches_per_layer": per_layer}
    emit(f"{label}_kernels", card=smi, sequences=seqs, tokens=T, by_kernel=per_launch)

    bf16 = torch.cat(logits[:2]).float().cpu()
    del logits
    mel0 = torch.cat(task.log_mels(batches[0]))
    with torch.no_grad():
        seq = WhisperEncoder(enc, task.params["encoder"], task.params.get("adapters"))(mel0).float()
    refs = {}
    for name, dt, fused in (("f32_plain", torch.float32, False), ("f32_kernels", torch.float32, True),
                            ("bf16_plain", torch.bfloat16, False)):  # the same weights on other paths
        t = _variant(task, dt, fused)
        refs[name] = torch.cat([t.forward(x) for x in batches[:2]]).float().cpu()
        if name == "f32_plain":  # every token of the first batch, not only the pooled last one
            with torch.no_grad():
                ref_seq = WhisperEncoder(t.cfg.encoder, t.params["encoder"], t.params.get("adapters"))(mel0)
            checks.compare(f"{label} encoder output, all {seq.shape[1]} tokens: bf16 kernels vs f32 plain "
                           "(first batch)", seq, ref_seq, TOL[torch.bfloat16])
            del ref_seq, seq
        del t
        torch.cuda.empty_cache()
    ref, k32, p16 = refs["f32_plain"], refs["f32_kernels"], refs["bf16_plain"]
    checks.compare(f"{label} logits: f32 kernels vs f32 plain (first 2 batches)", k32, ref, 1e-3)
    _bf16_gate(checks, f"{label} logits: bf16 kernels vs f32 plain (first 2 batches)", bf16, ref, p16)
    return launches


def _bf16_gate(checks, label, bf16, ref, p16):
    """bf16 logits on the kernels against the f32 plain path (CPU tensors):
    within BF16_VS_PLAIN times the plain bf16 layer's distance (PERF.md
    section 2), the search's span gate printed beside it."""
    span = float(ref.max() - ref.min())
    d, dp = (bf16 - ref).abs(), (p16 - ref).abs()
    span_tol = {k: v * span for k, v in SEARCH_BF16_TOL.items()}
    tol = {"max": BF16_VS_PLAIN * float(dp.max()), "mean": BF16_VS_PLAIN * float(dp.mean())}
    ok_bf16 = float(d.max()) <= tol["max"] and float(d.mean()) <= tol["mean"]
    extra = {}
    if ref.shape[1] > 1:
        extra["argmax_agreement"] = float((bf16.argmax(1) == ref.argmax(1)).float().mean())
        extra["plain_bf16_argmax_agreement"] = float((p16.argmax(1) == ref.argmax(1)).float().mean())
    corr = lambda a: float(np.corrcoef(a.flatten().numpy(), ref.flatten().numpy())[0, 1])
    emit("parity", check=label,
         max_abs_err=float(d.max()), mean_abs_err=float(d.mean()), correlation=corr(bf16),
         plain_bf16_max_abs_err=float(dp.max()), plain_bf16_mean_abs_err=float(dp.mean()),
         plain_bf16_correlation=corr(p16), f32_logit_span=span, max_abs_logit=float(ref.abs().max()),
         tol=tol, tol_rule=f"{BF16_VS_PLAIN} x the plain bf16 layer's distance from f32 (PERF.md section 2)",
         span_gate={"tol_of_span": SEARCH_BF16_TOL, "tol": span_tol,
                    "holds": float(d.max()) <= span_tol["max"] and float(d.mean()) <= span_tol["mean"]},
         ok=ok_bf16, **extra)
    if not ok_bf16:
        checks.failed.append(label)


def _variant(task, dtype, fused, **kw):
    """``task``'s workload on the same weights in another precision or layer path."""
    from gwkit_torch.train.tasks import build_glitch, build_signal_vs_noise

    cfg = dataclasses.replace(task.cfg.encoder, compute_dtype=dtype, fused_block=fused)
    if task.name == "signal_vs_noise":
        return build_signal_vs_noise(cfg, task.params, task.acfg, num_classes=task.cfg.num_classes,
                                     n_detectors=task.cfg.n_detectors, device=task.device)
    return build_glitch(cfg, task.params, task.acfg, num_classes=task.cfg.num_classes,
                        full_finetune=task.full_finetune, device=task.device)


def _train_gradient_gates(checks, label, task, batch):
    """The training step's gradients at T = 1500: in f32 the task's loss on
    the kernels against the plain layer (the f32 gradient parity gate), in
    bf16 the summed logits' (phase 5's gate; their cotangent does not
    cancel between samples); the bf16 loss gradients' cosines are printed
    beside them (PERF.md section 2 says why they are not gated)."""
    plain16 = _variant(task, torch.bfloat16, False)
    _gradient_gate(checks, f"{label} summed logits", _grad_groups(task, batch, True),
                   _grad_groups(plain16, batch, True))
    g16k, g16p = _grad_groups(task, batch), _grad_groups(plain16, batch)
    del plain16
    torch.cuda.empty_cache()
    g32p = _grad_groups(_variant(task, torch.float32, False), batch)
    torch.cuda.empty_cache()
    _gradient_gate(checks, f"{label} loss", _grad_groups(_variant(task, torch.float32, True), batch), g32p, f32=True)
    emit("reading", check=f"{label} loss gradients in bf16 (not gated)",
         cosine={key: {"kernels_vs_plain_bf16": _cosine(g16k[key], g16p[key]),
                       "kernels_vs_f32_plain": _cosine(g16k[key], g32p[key]),
                       "plain_bf16_vs_f32_plain": _cosine(g16p[key], g32p[key])} for key in g16k})
    torch.cuda.empty_cache()


def _switches_check(checks, task, strain):
    """WhisperConfig's use_flash_attention and fused_mlp (gwkit's switches)
    on the unfused layer at T = 1500 in bf16: the forward on kernels A and C
    (one each a layer, no plain call) against the f32 plain path (TOL), and
    the adapter gradients of a fixed random projection of the output (A
    saving its state, then D) against the plain bf16 layer's (phase 5's
    gate)."""
    from gwkit_torch.io import tree_leaves
    from gwkit_torch.models.whisper import encoder_apply

    enc, p = task.cfg.encoder, task.params
    cfg = dataclasses.replace(enc, fused_block=False, use_flash_attention=True, fused_mlp=True)
    plain = dataclasses.replace(enc, fused_block=False)
    mel = task.log_mels(strain[:4])[0]
    nl = enc.n_layers
    _cuda.reset_counts()
    with torch.no_grad():
        out = encoder_apply(cfg, p["encoder"], mel, p["adapters"])
    fwd = dict(_cuda.LAUNCHES)
    # a fixed random projection of the output (its plain sum would cancel in the final LayerNorm)
    w = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(out.device)
    tr = _with_grad(p["adapters"])
    _cuda.reset_counts()
    g_k = torch.autograd.grad((encoder_apply(cfg, p["encoder"], mel, tr).float() * w).sum(), tree_leaves(tr))
    bwd, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    with torch.no_grad():
        ref = encoder_apply(dataclasses.replace(plain, compute_dtype=torch.float32), p["encoder"], mel, p["adapters"])
    checks.compare("switches: encoder output, unfused layer on A and C (bf16) vs f32 plain", out, ref,
                   TOL[torch.bfloat16])
    tr = _with_grad(p["adapters"])
    g_p = torch.autograd.grad((encoder_apply(plain, p["encoder"], mel, tr).float() * w).sum(), tree_leaves(tr))
    _gradient_gate(checks, "switches: projected output", {"adapters": torch.cat([g.float().flatten() for g in g_k])},
                   {"adapters": torch.cat([g.float().flatten() for g in g_p])})
    want = ({"attention": nl, "attention_bwd": 0, "ln_gemm": 0, "fused_mlp": nl, "int8_gemm": 0},
            {"attention": nl, "attention_bwd": nl, "ln_gemm": 0, "fused_mlp": nl, "int8_gemm": 0})
    ok = (fwd, bwd) == want and not plain_calls
    emit("switches", sequences=len(mel), tokens=mel.shape[-1] // 2, forward_launches=fwd,
         forward_backward_launches=bwd, expected=list(want), plain_calls=plain_calls, ok=ok)
    if not ok:
        checks.failed.append("switches launch counters")
    torch.cuda.empty_cache()


def _timed_steps(trainer, steps, windows=3):
    """samples/s over ``windows`` timed passes of ``steps`` train steps."""
    trainer.run_epoch(steps[:1], torch.Generator().manual_seed(0))
    rates = []
    for w in range(windows):
        torch.cuda.synchronize()
        t0 = time.time()
        trainer.run_epoch(steps, torch.Generator().manual_seed(w))
        torch.cuda.synchronize()
        rates.append(len(steps) * len(steps[0][0]) / (time.time() - t0))
    return rates


def mel_phase(checks, smi):
    """Phase 6: the Signal_vs_Noise and glitch workloads at Whisper-tiny's
    full width and context (3000 mel frames, T = 1500), bf16 on the kernel
    chain. Returns the launches of the forward (mel) and of training (mel_train)."""
    from types import SimpleNamespace

    from gwkit_torch.cli.common import build_encoder_config
    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.data.glitch import LabeledDataset
    from gwkit_torch.models.adapters import AdapterConfig
    from gwkit_torch.train.tasks import build_glitch, build_signal_vs_noise
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    enc_cfg = build_encoder_config(SimpleNamespace(cpu=False, encoder="tiny"), 3000)  # the CLIs' card config
    assert enc_cfg.fused_block and enc_cfg.compute_dtype == torch.bfloat16 and enc_cfg.gelu_approx
    assert enc_cfg.max_positions == 1500 and not enc_cfg.quant_int8
    acfg = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo")
    # 1 s two-detector strain at 2048 Hz: N(0, 1) noise, half the samples with a chirp at SNR 5-15
    rng = np.random.default_rng(6)
    n = MEL_BATCH * MEL_BATCHES
    ds = InjectionDataset(rng.normal(size=(n, 2, 2048)).astype(np.float32), _chirps(n // 2, rng), (5.0, 15.0), dev)
    batches = [x for x, _, _ in ds.batches(torch.Generator().manual_seed(6), MEL_BATCH)]

    # 6a: Signal_vs_Noise forward, batch 64 = 128 sequences x 1500 tokens
    t0 = time.time()
    task = build_signal_vs_noise(enc_cfg, None, acfg, device=dev, seed=0)
    _perturb_lora_b(task, 0)
    load_s = time.time() - t0
    _mel_gate(checks, "mel", task, batches[0])
    mel = _mel_forward(checks, smi, "mel", task, batches, MEL_BATCH)
    _switches_check(checks, task, batches[0])
    emit("mel_setup", load_s=load_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)

    # 6b: Signal_vs_Noise training, cli/train.py's recipe (AdamW 1e-5, clip 0), batch 16 = 32 x 1500
    torch.cuda.reset_peak_memory_stats()
    cfg = TrainConfig(learning_rate=1e-5, clip_norm=0.0, optimizer="adamw", batch_size=MEL_TRAIN_BATCH, seed=0)
    train_task = build_signal_vs_noise(enc_cfg, {"encoder": task.frozen["encoder"]}, acfg, device=dev, seed=1)
    _perturb_lora_b(train_task, 1)
    del task
    torch.cuda.empty_cache()
    steps = list(ds.batches(torch.Generator().manual_seed(7), MEL_TRAIN_BATCH))[:6]
    _train_gradient_gates(checks, "mel train-step", train_task, steps[0])
    trainer = Trainer(train_task.loss_fn, train_task.trainable, train_task.frozen, cfg)
    trainer.run_epoch(steps[:1], torch.Generator().manual_seed(1))
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.time()
    loss, _ = trainer.run_epoch(steps, torch.Generator().manual_seed(2))
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    mel_train, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    ns, nl = len(steps), enc_cfg.n_layers
    expect = {"attention": 2 * nl * ns, "attention_bwd": nl * ns, "ln_gemm": 2 * nl * ns, "fused_mlp": nl * ns,
              "int8_gemm": 0}
    rates = _timed_steps(trainer, steps[:4])
    ok = mel_train == expect and not plain_calls and bool(np.isfinite(loss))
    emit("mel_train", card=smi, recipe="Signal_vs_Noise (cli/train.py): whisper-tiny frozen (random, torch seed), "
         "DoRA r=8 a=32 qkvo, two-channel head, 3000 mel frames (T = 1500), batch 16 (32 sequences), bf16, "
         "AdamW 1e-5, clip 0", steps=ns, mean_loss=loss, wall_s=fit_s, samples_per_s=ns * MEL_TRAIN_BATCH / fit_s,
         samples_per_s_by_window=rates, launches=mel_train, expected_launches=expect,
         launches_per_train_step={"attention": 2 * nl, "attention_bwd": nl, "ln_gemm": 2 * nl, "fused_mlp": nl},
         plain_calls=plain_calls, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
    if not ok:
        checks.failed.append("mel_train")
    groups = profiled("mel_train_profile", lambda: trainer.run_epoch(steps[:3], torch.Generator().manual_seed(3)),
                      steps=3)
    seqs, T = MEL_TRAIN_BATCH * 2, train_task.n_frames // 2
    d_ms, d_by = _bwd_bound(seqs * enc_cfg.n_heads, T, 2)
    emit("mel_train_kernels", card=smi, sequences=seqs, tokens=T, by_kernel={"attention_bwd": {
        "device_ms_per_launch": (groups.get("dq_kernel", 0.0) + groups.get("dkdv_kernel", 0.0)) / (3 * nl),
        "bound_ms": d_ms, "bound_by": d_by, "grids_per_launch": 2}})
    del trainer, train_task
    torch.cuda.empty_cache()

    # 6c: glitch, one detector, 11 classes: the forward at batch 64 under 6a's gates, one adapter
    # step with dropout, one full fine-tuning step with the encoder's gradients through the kernels
    grng = np.random.default_rng(8)
    ng = MEL_BATCH * 4
    strain = grng.normal(size=(ng, 2048)).astype(np.float32)
    strain[: ng // 2] += grng.uniform(5, 15, size=(ng // 2, 1)).astype(np.float32) * _chirps(ng // 2, grng)[:, 0]
    gds = LabeledDataset(strain, grng.integers(0, 11, ng), device=dev)
    gbatches = list(gds.batches(torch.Generator().manual_seed(8), MEL_BATCH))
    gtask = build_glitch(enc_cfg, None, acfg, device=dev, seed=2)
    _perturb_lora_b(gtask, 2)
    _mel_gate(checks, "glitch", gtask, gbatches[0][0])
    glitch = _mel_forward(checks, smi, "glitch", gtask, [x for x, _ in gbatches], MEL_BATCH)
    step = [(x[:MEL_TRAIN_BATCH], y[:MEL_TRAIN_BATCH]) for x, y in gbatches[:1]]
    gtrainer = Trainer(gtask.loss_fn, gtask.trainable, gtask.frozen, cfg)
    _cuda.reset_counts()
    adapter_loss, _ = gtrainer.run_epoch(step, torch.Generator().manual_seed(4))  # dropout drawn from it
    adapter_launches = dict(_cuda.LAUNCHES)
    ft = build_glitch(enc_cfg, {"encoder": gtask.frozen["encoder"], "head": gtask.trainable["head"]}, acfg,
                      full_finetune=True, device=dev)
    _train_gradient_gates(checks, "glitch full fine-tuning", ft, step[0])
    ftrainer = Trainer(ft.loss_fn, ft.trainable, ft.frozen, cfg)
    _cuda.reset_counts()
    ft_loss, _ = ftrainer.run_epoch(step, torch.Generator().manual_seed(5))
    ft_launches, ft_plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    one_step = {"attention": 2 * nl, "attention_bwd": nl, "ln_gemm": 2 * nl, "fused_mlp": nl, "int8_gemm": 0}
    ok = bool(np.isfinite(adapter_loss) and np.isfinite(ft_loss)) and adapter_launches == one_step and \
        ft_launches == one_step and not ft_plain_calls
    emit("glitch_train", adapter_step_loss=adapter_loss, full_finetune_step_loss=ft_loss,
         adapter_step_launches=adapter_launches, full_finetune_step_launches=ft_launches,
         expected_launches_per_step=one_step, plain_calls=ft_plain_calls,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
    if not ok:
        checks.failed.append("glitch training steps")
    del gtrainer, ftrainer, ft, gtask
    torch.cuda.empty_cache()
    return mel, mel_train


# phase 7: the efficiency workload (the CLIs' defaults: training batch 32, sweep batch 16,
# real-event windows of 2048 samples every 204, batch 64)
EFF_TRAIN, EFF_VALID, EFF_LADDER = (192, 96), (64, 32), ("30", "20", "10")
EFF_WAVES, EFF_NOISES, EFF_GATED_SNRS = 128, 512, (5.0, 11.0, 23.0)
EVENT_SECONDS, EVENT_STEP = 32, 204
ONE_STEP = {"attention": 8, "attention_bwd": 4, "ln_gemm": 8, "fused_mlp": 4, "int8_gemm": 0}
ONE_FORWARD = {"attention": 4, "attention_bwd": 0, "ln_gemm": 8, "fused_mlp": 4, "int8_gemm": 0}


def _times(counts, n):
    return {k: v * n for k, v in counts.items()}


def _delta(before):
    return {k: _cuda.LAUNCHES[k] - before[k] for k in before}


def _recorded(ds, kind, log):
    """``ds.batches`` recording the SNR range at each epoch's start and each
    batch's launches (what ran between its yield and the next request)."""
    batches = ds.batches

    def wrapped(*a, **kw):
        log[f"{kind}_snr_ranges"].append(tuple(float(v) for v in ds.snrs()))
        for b in batches(*a, **kw):
            before = dict(_cuda.LAUNCHES)
            yield b
            log[f"{kind}_launches"].append(_delta(before))
    ds.batches = wrapped


def _table_agreement(est, got, want):
    """Two efficiency tables from (noise, waves) scores: equal, except that an
    entry may differ by one sample where the deciding score (an injection's,
    or the next-ranked noise score) lies within 1e-3 x max |score| of the
    threshold. Returns (ok, the entries that differ)."""
    (noise, waves), (w_noise, w_waves) = got, want
    tol = 1e-3 * max(np.abs(w_noise).max(), max(np.abs(w).max() for w in w_waves))
    t_got, t_want = est.table(noise, waves), est.table(w_noise, w_waves)
    ranked, ok, entries = np.sort(w_noise), True, []
    for i, j in zip(*np.nonzero(t_got != t_want)):
        p = len(ranked) - max(int(est.faps[j] * len(ranked)), 1)
        near = min(float(np.abs(w_waves[i] - ranked[p]).min()),
                   *(float(abs(ranked[q] - ranked[p])) for q in (p - 1, p + 1) if 0 <= q < len(ranked)))
        one = abs(t_got[i, j] - t_want[i, j]) * len(w_waves[i]) <= 1 + 1e-9
        ok = ok and one and near <= tol
        entries.append({"snr": est.snrs[i], "fap": est.faps[j], "got": float(t_got[i, j]),
                        "want": float(t_want[i, j]), "deciding_distance": near, "tol": tol})
    return ok, entries, t_got, t_want


def _read_table(path):
    lines = open(path).read().splitlines()
    return lines[0], np.array([[float(v) for v in ln.split("\t")] for ln in lines[1:]])


def efficiency_phase(checks, smi):
    """Phase 7: the efficiency workload at Whisper-tiny's full width and
    context through the CLIs' recipes (their HDF5 reading aside), bf16 on
    the kernel chain: (7a) train_efficiency's curriculum, (7b)
    calculate_efficiencies on 7a's checkpoints, (7c) real-event scoring.
    Returns the launches of each path."""
    from gwkit_torch.cli import calculate_efficiencies, real_events, train_efficiency
    from gwkit_torch.cli.common import load_task
    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.evaluation.efficiency import EfficiencyEstimator
    from gwkit_torch.search.realevents import score_event_segments
    from gwkit_torch.search.slicer import DeviceSlicer, Segment, SlicerConfig
    from gwkit_torch.train.tasks import build_signal_vs_noise
    from gwkit_torch.train.trainer import Trainer

    dev = torch.device("cuda")
    t_phase = time.time()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rng = np.random.default_rng(10)
    train_ds = InjectionDataset(rng.normal(size=(EFF_TRAIN[0], 2, 2048)).astype(np.float32),
                                _chirps(EFF_TRAIN[1], rng), device=dev)
    valid_ds = InjectionDataset(rng.normal(size=(EFF_VALID[0], 2, 2048)).astype(np.float32),
                                _chirps(EFF_VALID[1], rng), device=dev)
    log = {k: [] for k in ("train_snr_ranges", "train_launches", "valid_snr_ranges", "valid_launches", "resets")}
    _recorded(train_ds, "train", log)
    _recorded(valid_ds, "valid", log)
    reset = Trainer.reset_optimizer

    def recorded_reset(self):
        before = self.opt_state.count
        reset(self)
        st = self.opt_state
        log["resets"].append({"count_before": before, "count_after": st.count,
                              "moments_zero": all(not bool(t.any()) for t in st.mu + st.nu)})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_eff_") as out:
        # 7a: train_efficiency's recipe: the epoch scheduler over the ladder 30 20 10 (a rung an
        # epoch), --reset-optimizer, AdamW 1e-5, clip 0, batch 32, random weights from torch seed 0
        targs = train_efficiency.parse_args(["-d", "(in memory)", "-o", out, "--epochs", "3", "--scheduler", "epoch",
                                             "--scheduler-patience", "0", "--snr-ladder", *EFF_LADDER,
                                             "--reset-optimizer", "--seed", "0"])
        Trainer.reset_optimizer = recorded_reset
        _cuda.reset_counts()
        t0 = time.time()
        try:
            trainer = train_efficiency.train(targs, train_ds, valid_ds, dev)
        finally:
            Trainer.reset_optimizer = reset
        torch.cuda.synchronize()
        fit_s = time.time() - t0
        eff_train, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        run = os.path.join(out, "run_0000")
        losses = np.loadtxt(os.path.join(run, "losses.txt")).reshape(-1, 3)
        rungs = [(25.0, 30.0), (15.0, 20.0), (5.0, 10.0)]
        n_steps = EFF_TRAIN[0] // 32
        files = [f"state_e_{e:04d}.npz" for e in (1, 2, 3)] + ["best.npz"]
        gates = {
            "snr_ranges": log["train_snr_ranges"] == rungs and log["valid_snr_ranges"] == rungs,
            "resets": [(r["count_before"], r["count_after"], r["moments_zero"]) for r in log["resets"]]
            == [(0, 0, True), (n_steps, 0, True), (n_steps, 0, True)] and trainer.opt_state.count == n_steps,
            "launches_a_step": len(log["train_launches"]) == 3 * n_steps
            and all(x == ONE_STEP for x in log["train_launches"]),
            "launches_a_validation_batch": len(log["valid_launches"]) == 3 * (EFF_VALID[0] // 32)
            and all(x == ONE_FORWARD for x in log["valid_launches"]),
            "no_plain_call": not plain_calls,
            "losses_finite": losses.shape == (3, 3) and bool(np.isfinite(losses).all()),
            "checkpoints": all(os.path.isfile(os.path.join(run, f)) for f in files),
        }
        ok = all(gates.values())
        snr_ranges = {"train": list(log["train_snr_ranges"]), "valid": list(log["valid_snr_ranges"])}
        steps = list(train_ds.batches(torch.Generator().manual_seed(7), 32))[:4]
        rates = _timed_steps(trainer, steps)
        emit("efficiency_train", card=smi, recipe="train_efficiency: whisper-tiny frozen (random, torch seed 0), "
             "DoRA r=8 a=32 qkvo, two-channel head, 3000 mel frames (T = 1500), batch 32 (64 sequences), bf16, "
             "AdamW 1e-5, clip 0, EpochCLScheduler(patience=0) over 30 20 10, --reset-optimizer",
             epochs=3, steps=3 * n_steps, validation_batches=len(log["valid_launches"]), losses=losses.tolist(),
             snr_ranges=snr_ranges, resets=log["resets"],
             launches=eff_train, launches_per_step=ONE_STEP, plain_calls=plain_calls, fit_s=fit_s,
             fit_samples_per_s=3 * (EFF_TRAIN[0] + EFF_VALID[0]) / fit_s, samples_per_s_by_window=rates,
             peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, gates=gates, ok=ok)
        if not ok:
            checks.failed.append("efficiency_train: " + ", ".join(k for k, v in gates.items() if not v))
        profiled("efficiency_train_profile", lambda: trainer.run_epoch(steps[:3], torch.Generator().manual_seed(3)),
                 steps=3)
        del trainer, steps, train_ds, valid_ds
        torch.cuda.empty_cache()

        # 7b: calculate_efficiencies' recipe on 7a's three checkpoints (--epochs all): 128
        # injections (noise plus a chirp) and 512 noises, the CLI's SNRs, FAPs and batch 16
        torch.cuda.reset_peak_memory_stats()
        srng = np.random.default_rng(11)
        ds = InjectionDataset(srng.normal(size=(EFF_WAVES + EFF_NOISES, 2, 2048)).astype(np.float32),
                              _chirps(EFF_WAVES, srng), device=dev)
        sargs = calculate_efficiencies.parse_args(["-d", "(in memory)", "--checkpoint-dir", run, "-o",
                                                   os.path.join(out, "tables"), "--epochs", "all", "--seed", "0"])
        per_ckpt = -(-EFF_NOISES // sargs.batch_size) + len(sargs.snrs) * -(-EFF_WAVES // sargs.batch_size)
        _cuda.reset_counts()
        t0 = time.time()
        tables = calculate_efficiencies.sweep(sargs, ds, dev)
        torch.cuda.synchronize()
        sweep_s = time.time() - t0
        eff, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        n_batches = 3 * per_ckpt
        read_ok = True
        for name, table in tables.items():
            header, rows = _read_table(os.path.join(sargs.output_dir, f"out_efficiencies_{name}.txt"))
            read_ok = read_ok and header == "# SNR\t" + "\t".join(f"FAP={f:g}" for f in sargs.faps) and \
                rows.shape == (len(sargs.snrs), len(sargs.faps) + 1) and np.array_equal(rows[:, 0], sargs.snrs) and \
                np.array_equal(rows[:, 1:], [[float(f"{v:.6f}") for v in row] for row in table])
        ok = eff == _times(ONE_FORWARD, n_batches) and not plain_calls and sorted(tables) == \
            ["state_e_0001", "state_e_0002", "state_e_0003"] and read_ok
        scored = 3 * (EFF_NOISES + len(sargs.snrs) * EFF_WAVES)
        emit("efficiency", card=smi, recipe="calculate_efficiencies --epochs all on 7a's checkpoints: 128 injections, "
             "512 noises, SNRs 5..23, FAPs 1e-1..1e-4, batch 16 (32 sequences x 1500 tokens), bf16",
             checkpoints=sorted(tables), batches=n_batches, launches=eff, expected_launches=_times(ONE_FORWARD, n_batches),
             plain_calls=plain_calls, tables_read_back=read_ok, wall_s=sweep_s, samples_scored=scored,
             samples_per_s=scored / sweep_s, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, ok=ok)
        if not ok:
            checks.failed.append("efficiency sweep")

        # the best checkpoint: its bf16 scores under phase 6's rule, its table in f32 on the kernels
        # against the f32 plain path at three SNRs, the bf16 table beside them (not gated: PERF.md section 2)
        task = load_task(sargs, build_signal_vs_noise, dev, os.path.join(run, "best.npz"))
        wave_ds, noise_ds = calculate_efficiencies.split_dataset(ds, dev)
        est = EfficiencyEstimator(wave_ds, noise_ds, EFF_GATED_SNRS, sargs.batch_size, sargs.faps)
        scores = {}

        def bf16_scores():  # profiled: where a sweep's time goes
            scores["bf16_kernels"] = est.scores(lambda x: task.forward(x).reshape(-1), seed=0)

        n_gated = -(-EFF_NOISES // sargs.batch_size) + len(EFF_GATED_SNRS) * -(-EFF_WAVES // sargs.batch_size)
        profiled("efficiency_profile", bf16_scores, checkpoint="best.npz", batches=n_gated,
                 samples=EFF_NOISES + len(EFF_GATED_SNRS) * EFF_WAVES)
        for name, t in (("f32_kernels", _variant(task, torch.float32, True)),
                        ("f32_plain", _variant(task, torch.float32, False))):
            scores[name] = est.scores(lambda x: t.forward(x).reshape(-1), seed=0)
            torch.cuda.empty_cache()
        first = [x for x, _, _ in noise_ds.batches(torch.Generator(), sargs.batch_size, shuffle=False)][:2]
        p16 = _variant(task, torch.bfloat16, False)
        logit = lambda t: torch.cat([t.forward(x) for x in first]).float().cpu()
        _bf16_gate(checks, "efficiency logits: bf16 kernels vs f32 plain (first 2 noise batches of the best "
                   "checkpoint)", logit(task), logit(_variant(task, torch.float32, False)), logit(p16))
        del p16
        ok32, entries, t32, tref = _table_agreement(est, scores["f32_kernels"], scores["f32_plain"])
        emit("efficiency_table", card=smi, checkpoint="best.npz", snrs=list(EFF_GATED_SNRS), faps=sargs.faps,
             f32_kernels=t32.tolist(), f32_plain=tref.tolist(), bf16_kernels=est.table(*scores["bf16_kernels"]).tolist(),
             thresholds={k: est.thresholds(v[0]).tolist() for k, v in scores.items()},
             f32_noise_score_span=float(np.ptp(scores["f32_plain"][0])),
             max_abs_score=float(np.abs(scores["f32_plain"][0]).max()),
             differing_entries=entries, n_differing=len(entries),
             rule="equal, but an entry may differ by one sample where the deciding score lies within 1e-3 x max "
                  "|score| of its threshold", ok=ok32)
        if not ok32:
            checks.failed.append("efficiency table f32")
        del task, wave_ds, noise_ds, ds, scores, est
        torch.cuda.empty_cache()

        # 7c: two events of 32 s: one raw (the CLI's --whiten: the slicer whitens it on the card,
        # a chirp at amplitude 12 inside), one pre-whitened; windows 2048, step 204, batch 64
        erng = np.random.default_rng(12)
        n = EVENT_SECONDS * 2048
        raw = erng.normal(size=(2, n)).astype(np.float32)
        c0 = n // 2 - 2048  # the chirp's second
        raw[:, c0:c0 + 2048] += 12.0 * _chirps(1, erng)[0]
        white = erng.normal(size=(2, n)).astype(np.float32)
        best = os.path.join(run, "best.npz")
        rargs = {w: real_events.parse_args(["-d", "(in memory)", "--checkpoint", best, "-o", "scores.hdf", "--seed", "0"]
                                           + (["--whiten"] if w else [])) for w in (True, False)}
        task = load_task(rargs[True], build_signal_vs_noise, dev, best, input_sample_rate=int(rargs[True].sample_rate))
        events = {"raw": ({"GW_raw": raw}, rargs[True]), "white": ({"GW_white": white}, rargs[False])}

        def score_all():
            got = {}
            for ev, a in events.values():
                got.update(score_event_segments(task, ev, sample_rate=a.sample_rate, window=a.window, step=a.step,
                                                batch_size=a.batch_size, white=not a.whiten))
            return got

        score_all()  # warm: cuDNN picks its algorithms for batch 64
        torch.cuda.synchronize()
        _cuda.reset_counts()
        t0 = time.time()
        got = score_all()
        torch.cuda.synchronize()
        ev_s = time.time() - t0
        real, plain_calls = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        half = int(SlicerConfig().max_filter_duration * 2048) // 2
        want_n = {"GW_raw": 1 + (n - 2 * half - 2048) // EVENT_STEP, "GW_white": 1 + (n - 2048) // EVENT_STEP}
        n_batches = sum(-(-v // rargs[True].batch_size) for v in want_n.values())
        ok = {k: len(v) for k, v in got.items()} == want_n and real == _times(ONE_FORWARD, n_batches) and \
            not plain_calls and all(bool(((v >= 0) & (v <= 1)).all()) for v in got.values())
        windows = sum(want_n.values())
        emit("real_events", card=smi, recipe="real_events on 7a's best checkpoint: 2 events x 32 s x 2 detectors, "
             "one raw (whitened by the slicer, --whiten), one pre-whitened; window 2048, step 204, batch 64, bf16",
             windows=want_n, got_windows={k: len(v) for k, v in got.items()}, batches=n_batches, launches=real,
             expected_launches=_times(ONE_FORWARD, n_batches), plain_calls=plain_calls,
             max_score={k: float(v.max()) for k, v in got.items()}, chirp_window_score=float(got["GW_raw"][
                 (c0 - half) // EVENT_STEP]), wall_s=ev_s, windows_per_s=windows / ev_s, ok=ok)
        if not ok:
            checks.failed.append("real_events")
        profiled("real_events_profile", score_all, batches=n_batches, windows=windows)
        cfg = SlicerConfig(step_size=EVENT_STEP / 2048, slice_length=2048, batch_size=64, peak_offset=0.0)
        seg = Segment(key="GW_raw", strain=raw, start_time=0.0, delta_t=1 / 2048)
        x = next(DeviceSlicer(seg, cfg, white=False, device=dev).batches())[0]
        logit = lambda t: t.forward(x).float().cpu()
        _bf16_gate(checks, "real_events logits: bf16 kernels vs f32 plain (first batch of the raw event)",
                   logit(task), logit(_variant(task, torch.float32, False)), logit(_variant(task, torch.bfloat16, False)))
        del task
        torch.cuda.empty_cache()
    emit("efficiency_phase", wall_s=time.time() - t_phase)
    return eff_train, eff, real


HOSTIO_SECONDS, HOSTIO_RATE = 4096, 2048  # the raw file: 2 x 4096 s of f64 at 2048 Hz, 134 MB
MESH_TRAIN_STEPS = 8
MESH_TIMED_PAIRS, MESH_PIECE_REPS = 40, 15  # phase 8's step pairs in turns; reps of each piece


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _hostio_checks(checks, smi):
    """The C++ reader built by g++ and bit-exact on a raw f64 file."""
    from gwkit_torch.native import hostio

    built = hostio.available()
    emit("hostio_build", library=str(hostio.library_path()), built=built, ok=built)
    if not built:
        checks.failed.append("hostio build")
        return
    n = HOSTIO_SECONDS * HOSTIO_RATE
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "strain.f64")
        np.random.default_rng(0).standard_normal((2, n)).tofile(path)
        size = os.path.getsize(path)
        want = np.fromfile(path).astype(np.float32).reshape(2, n)
        t0 = time.perf_counter()
        got = hostio.ArrayPrefetch(path, 0, (2, n), True).wait()
        prefetch_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loader = hostio.ChunkLoader(path, 0, 2 * n, on_disk_f64=True)
        chunked = np.concatenate(list(loader)).reshape(2, n)
        loader.close()
        loader_s = time.perf_counter() - t0
    ok = np.array_equal(got, want) and np.array_equal(chunked, want)
    emit("hostio", card=smi, file_mb=size / 1e6, prefetch_mb_per_s=size / 1e6 / prefetch_s,
         chunk_loader_mb_per_s=size / 1e6 / loader_s, prefetch_s=prefetch_s, chunk_loader_s=loader_s,
         note="the file was just written, so it is read from the page cache", bit_exact=ok, ok=ok)
    if not ok:
        checks.failed.append("hostio readers")


def _mesh_search(checks, smi, bf16_search, mesh):
    """Phase 4's search with the mesh: scores bit-identical, the same
    launches, one all_gather a batch. A warm mesh pass first (NCCL starts
    its communicator at the first collective), then timed passes in turns
    (unmeshed, mesh, mesh, unmeshed) and a profiled mesh pass."""
    from gwkit_torch.search.engine import score_segments

    task, seg, cfg = _capstone_search_task(), bf16_search["segment"], bf16_search["cfg"]
    dev = torch.device("cuda")
    run = lambda m: score_segments(task.score, [seg], cfg, trigger_threshold=bf16_search["threshold"],
                                   device=dev, mesh=m)
    run(mesh)
    rates = {"unmeshed": [], "mesh": []}
    identical, launches, gathers = [], [], []
    for name in ("unmeshed", "mesh", "mesh", "unmeshed"):
        m = mesh if name == "mesh" else None
        before = mesh.calls["all_gather/data"]
        _cuda.reset_counts()
        res = run(m)
        launches.append((dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)))
        gathers.append(mesh.calls["all_gather/data"] - before)
        identical.append(np.array_equal(res.all_vals, bf16_search["all_vals"]))
        rates[name].append(res.throughput_x_realtime)
    batches = -(-res.n_windows // cfg.batch_size)
    mesh_launches = launches[1][0]
    ok = all(identical) and all(lv == (bf16_search["launches"], {}) for lv in launches) and \
        gathers == [0, batches, batches, 0]
    emit("search_mesh", card=smi, mesh=list(mesh.shape), windows=res.n_windows, batches=batches,
         scores_bit_identical_to_phase4=identical, launches=mesh_launches, phase4_launches=bf16_search["launches"],
         plain_calls=launches[1][1], nccl_all_gathers=gathers, strain_seconds_per_second=rates,
         order="unmeshed, mesh, mesh, unmeshed after a warm mesh pass", ok=ok)
    if not ok:
        checks.failed.append("search_mesh")
    profiled("search_mesh_profile", lambda: run(mesh), batches=batches)
    return res.triggers, mesh_launches


def _host_ms(fn, reps, sync=True):
    """Median host ms of ``fn`` over ``reps`` calls after 3 warm ones, the
    card synchronized before each call and, with ``sync``, after it."""
    out = []
    for i in range(3 + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize()
        if i >= 3:
            out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _mesh_train(checks, smi, mesh):
    """Phase 5's recipe, MESH_TRAIN_STEPS steps of an unmeshed trainer and
    of one with the mesh, in turns, from the same trainables and batches:
    losses equal, the same kernel launches, one NCCL all_reduce a step.
    cuDNN is held to its deterministic algorithms (the Q-adapter's weight
    gradients), so equal means bit for bit. Then the step times:
    MESH_TIMED_PAIRS more pairs in turns (the first of a pair swapped each
    pair) and their paired differences; the mesh step's own pieces on its
    gradients (``_data_mean``: flatten, all_reduce, split back; the
    all_reduce alone; the flatten alone); and a profiled window of 3 steps
    of each trainer, both under deterministic cuDNN."""
    import torch.distributed as dist

    from gwkit_torch.cli.inference import _load_gwkit_encoder
    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.adapters import AdapterConfig
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import config_for
    from gwkit_torch.train.tasks import build_mlgwsc
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    dev = torch.device("cuda")
    frames, batch = 512, 64
    enc_cfg = config_for("tiny", compute_dtype=torch.bfloat16, fused_block=True, gelu_approx=True,
                         max_positions=frames // 2)
    encoder = from_gwkit_numpy(encoder=_load_gwkit_encoder(f"{CAPSTONE}/encoder_pretrained.npz", "tiny",
                                                           enc_cfg))["encoder"]
    qcfg = QAdapterConfig(median_stride=8, target_shape=(80, frames))
    acfg = AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo")
    rng = np.random.default_rng(0)
    train = InjectionDataset(rng.normal(size=(1024, 2, 2048)).astype(np.float32), _chirps(512, rng), (7.0, 20.0),
                             dev)
    steps = list(train.batches(torch.Generator().manual_seed(9), batch))[:MESH_TRAIN_STEPS]
    cfg = TrainConfig(learning_rate=3e-4, clip_norm=100.0, epochs=1, batch_size=batch, optimizer="adam", seed=0)
    prev = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for name, m in (("unmeshed", None), ("mesh", mesh)):
            task = build_mlgwsc(enc_cfg, qcfg, {"encoder": encoder}, usr=False, device=dev, acfg=acfg, seed=0)
            runs[name] = dict(trainer=Trainer(task.loss_fn, task.trainable, task.frozen, cfg, mesh=m), losses=[],
                              launches={}, plain={}, calls={})
        for i, b in enumerate(steps):  # the two trainers step in turns, the first of a pair swapped each step
            for name in (("unmeshed", "mesh") if i % 2 == 0 else ("mesh", "unmeshed")):
                r = runs[name]
                calls = dict(mesh.calls)
                _cuda.reset_counts()
                r["losses"].append(r["trainer"].train_step(b)[0])
                for key, src in (("launches", _cuda.LAUNCHES), ("plain", _cuda.PLAIN_CALLS)):
                    for k, v in src.items():
                        r[key][k] = r[key].get(k, 0) + v
                for k, v in mesh.calls.items():
                    if v - calls.get(k, 0):
                        r["calls"][k] = r["calls"].get(k, 0) + v - calls.get(k, 0)
        ms = {"unmeshed": [], "mesh": []}
        for i in range(MESH_TIMED_PAIRS):  # the checked steps above warmed both trainers
            b = steps[i % len(steps)]
            for name in (("unmeshed", "mesh") if i % 2 == 0 else ("mesh", "unmeshed")):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                runs[name]["trainer"].train_step(b)
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
        tm = runs["mesh"]["trainer"]
        loss, _, grads, _ = tm._gradients(steps[0])
        tensors = [loss, *grads]
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        pieces = {"data_mean_ms": _host_ms(lambda: tm._data_mean(tensors), MESH_PIECE_REPS),
                  "all_reduce_ms": _host_ms(lambda: dist.all_reduce(flat), MESH_PIECE_REPS),
                  "all_reduce_host_ms_no_sync": _host_ms(lambda: dist.all_reduce(flat), MESH_PIECE_REPS, sync=False),
                  "flatten_ms": _host_ms(lambda: torch.cat([t.reshape(-1).float() for t in tensors]),
                                         MESH_PIECE_REPS)}
        for phase, name in (("train_unmeshed_deterministic_profile", "unmeshed"), ("train_mesh_profile", "mesh")):
            trainer = runs[name]["trainer"]
            profiled(phase, lambda: [trainer.train_step(b) for b in steps[:3]], steps=3, cudnn_deterministic=True)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = prev
    u, m = runs["unmeshed"], runs["mesh"]
    for r in (u, m):
        r["losses"] = torch.stack(r["losses"]).float().cpu().numpy()
        del r["trainer"]
    per_step = {k: v / len(steps) for k, v in m["launches"].items()}
    equal = np.array_equal(u["losses"], m["losses"])
    ok = equal and u["launches"] == m["launches"] and not any(m["plain"].values()) and not u["calls"] and \
        m["calls"] == {"all_reduce/data": len(steps)} and bool(np.isfinite(m["losses"]).all())
    diffs = [a - b for a, b in zip(ms["mesh"], ms["unmeshed"])]
    med = {k: statistics.median(v) for k, v in ms.items()}
    emit("train_mesh", card=smi, mesh=list(mesh.shape), steps=len(steps), losses=m["losses"].tolist(),
         unmeshed_losses=u["losses"].tolist(), losses_equal=equal,
         max_abs_diff=float(np.abs(u["losses"] - m["losses"]).max()), launches=m["launches"],
         unmeshed_launches=u["launches"], launches_per_step=per_step, plain_calls=m["plain"],
         nccl_calls=m["calls"], nccl_calls_per_step={k: v / len(steps) for k, v in m["calls"].items()},
         trainable_leaves=len(grads), trainable_elements=int(sum(g.numel() for g in grads)),
         timed_pairs=MESH_TIMED_PAIRS, step_ms_median=med, step_ms_range={k: [min(v), max(v)] for k, v in ms.items()},
         paired_diff_ms_median=statistics.median(diffs), mesh_over_unmeshed=med["mesh"] / med["unmeshed"],
         step_ms=ms, **pieces, order="after the checked steps, pairs in turns, the first of a pair swapped each pair",
         ok=ok)
    if not ok:
        checks.failed.append("train_mesh")
    return m["launches"]


def parallel_phase(checks, smi, bf16_search):
    """Phase 8: the host-IO reader, then a one-rank NCCL world: the mesh
    search and the mesh trainer against their unmeshed runs, the trigger
    shards, and make_mesh's refusal. Returns the two mesh paths' launches."""
    import torch.distributed as dist

    from gwkit_torch.parallel.distributed import (gather_trigger_lists, initialize, merge_trigger_shards,
                                                  process_count, write_trigger_shard)
    from gwkit_torch.parallel.mesh import make_mesh

    t_phase = time.time()
    _hostio_checks(checks, smi)
    initialize(f"127.0.0.1:{_free_port()}", 1, 0)
    try:
        mesh = make_mesh(1)
        assert dist.get_backend() == "nccl" and mesh.shape == (1, 1) and process_count() == 1
        triggers, search_mesh = _mesh_search(checks, smi, bf16_search, mesh)
        train_mesh = _mesh_train(checks, smi, mesh)
        with tempfile.TemporaryDirectory() as shard_dir:
            gathered = gather_trigger_lists(triggers, shard_dir)
            write_trigger_shard(triggers, shard_dir, 0)
            merged = merge_trigger_shards(shard_dir, 1)
        want = {k: np.asarray(v, np.float64).reshape(-1, 2).tolist() for k, v in sorted(triggers.items())}
        try:
            make_mesh(n_model=2)
            refused = False
        except ValueError:
            refused = True
        ok = gathered is triggers and merged == want and refused
        emit("shards", triggers=sum(len(v) for v in triggers.values()), gather_identity=gathered is triggers,
             round_trip_equal=merged == want, make_mesh_2_refused=refused, ok=ok)
        if not ok:
            checks.failed.append("trigger shards")
    finally:
        dist.destroy_process_group()
    emit("parallel_phase", wall_s=time.time() - t_phase)
    return search_mesh, train_mesh


# phase 9: data generation's physics on the card (gwkit_torch.data, ops.psd/whiten/snr) and the search of
# its output: a 300 s two-detector MLGWSC-1-style segment at 2048 Hz
GEN_SECONDS, GEN_FS, GEN_F_LOW = 300.0, 2048, 9.0
GEN_WAVE_BATCH, GEN_WAVE_SECONDS = 64, 64.0  # gwkit's challenge inject_batch and wave_duration
GEN_APPROXIMANTS = ("imrphenomd", "imrphenomxphm", "imrphenomxphm-twospin")
GEN_INJECTIONS, GEN_SNR = 20, (8.0, 30.0)
GEN_WAVE_TOL = 2e-3    # card vs CPU, of each waveform's max |h|: float32 phases of 1e3-1e5 rad
GEN_NOISE_TOL = 1e-4   # colored noise, card vs CPU from the same draws, of the max
GEN_SNR_TOL = 1e-4     # recomputed network SNR vs its target, relative
GEN_IRFFT_TOL = 1e-5   # C2R of spectra with imaginary DC/Nyquist parts, card vs CPU, of the max
# Euler angles card vs CPU, of each angle's max |.|: eps is a float32 cumsum
# over 65,537 bins (or 384 steps), summed in another order on the card (a
# parallel scan), so it differs by some sqrt(N) ulps of the running sum
GEN_ANGLE_TOL = 1e-4


def _gen_noise(psds, seed, dev):
    """(2, N) physical-scale noise, one NoiseGenerator a detector."""
    from gwkit_torch.data.noise import NoiseGenerator

    return torch.cat([NoiseGenerator(p, GEN_FS, GEN_F_LOW, seed=seed + i, device=dev).get(1, GEN_SECONDS)
                      for i, p in enumerate(psds)])


def _gen_psd_and_noise(checks, smi, dev):
    """PSDs, then 300 s of noise for H1 and L1 from their variants: a Welch
    PSD against the target, the colored-noise core card vs CPU from the same
    draws, the rate. Returns the two PSDs."""
    from gwkit_torch.data.noise import colored_noise_core
    from gwkit_torch.ops.psd import aligo_zdhp_psd, psd_variant, welch_psd

    n = int(GEN_SECONDS * GEN_FS)
    flen, df = n // 2 + 1, GEN_FS / n
    f = np.arange(flen) * df
    t0 = time.perf_counter()
    psds = {"aLIGOZeroDetHighPower": aligo_zdhp_psd(flen, df, GEN_F_LOW),
            "H1/0": psd_variant(flen, df, GEN_F_LOW, "H1", 0), "L1/0": psd_variant(flen, df, GEN_F_LOW, "L1", 0)}
    psd_s = time.perf_counter() - t0
    shapes = {k: bool(np.isfinite(p).all() and (p[f < GEN_F_LOW] == 0).all() and (p[f >= GEN_F_LOW] > 0).all())
              for k, p in psds.items()}
    ok = all(shapes.values())
    emit("generation_psd", bins=flen, delta_f=df, host_s=psd_s, finite_zero_below_cutoff_positive_above=shapes,
         ok=ok)
    if not ok:
        checks.failed.append("generation PSDs")
    variants = [psds["H1/0"], psds["L1/0"]]

    _gen_noise(variants, 1, dev)  # warm: cuFFT plans, the generator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    noise = _gen_noise(variants, 11, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    ratios = {}
    for det, x, p in zip(("H1", "L1"), noise, variants):
        c = float(p[p > 0].mean())
        est = welch_psd((x / np.sqrt(c))[None], 1.0 / GEN_FS, segment_duration=4.0)[0].cpu().numpy()
        f_est = np.arange(len(est)) * 0.25
        band = (f_est >= 30.0) & (f_est <= 900.0)
        ratios[det] = float(np.median(est[band] / (np.interp(f_est, f, p) / c)[band]))
    ok_psd = all(0.9 <= r <= 1.1 for r in ratios.values()) and bool(torch.isfinite(noise).all())

    # the core from the same draws on both devices (the card's draws moved to the CPU)
    g = torch.Generator(device=dev).manual_seed(5)
    a, b = (torch.randn((2, flen), generator=g, device=dev) for _ in range(2))
    pn = torch.from_numpy(np.stack([p / p[p > 0].mean() for p in variants]).astype(np.float32))
    on_card = colored_noise_core(a, b, n, 1.0 / GEN_FS, pn.to(dev)).cpu()
    on_cpu = colored_noise_core(a.cpu(), b.cpu(), n, 1.0 / GEN_FS, pn)
    err = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
    ok_core = err <= GEN_NOISE_TOL
    emit("generation_noise", card=smi, seconds=GEN_SECONDS, detectors=2, std=[float(x.std()) for x in noise],
         welch_median_ratio_30_900hz=ratios, strain_seconds_per_second=2 * GEN_SECONDS / gen_s, wall_s=gen_s,
         core_card_vs_cpu_max_err_of_max=err, tol=GEN_NOISE_TOL, ok=ok_psd and ok_core)
    if not ok_psd:
        checks.failed.append("generation noise PSD")
    if not ok_core:
        checks.failed.append("generation noise card vs CPU")
    return variants, noise


def _td(params, approximant, dev):
    from gwkit_torch.data.waveforms import td_polarizations

    return td_polarizations(params, GEN_WAVE_SECONDS, GEN_FS, 20.0, approximant, device=dev)


def _gen_waveforms(checks, smi, dev):
    """A batch of GEN_WAVE_BATCH waveforms of GEN_WAVE_SECONDS at 2048 Hz
    from the ds3/4 population for each of GEN_APPROXIMANTS: timed on the
    card, each waveform against the same function on the CPU; the two-spin
    ODE timed alone. First, the irfft of spectra whose DC and Nyquist bins
    have imaginary parts (the FD models put such values at Nyquist), card
    vs CPU: pocketfft drops those parts, and td_polarizations counts on
    cuFFT's C2R dropping them too, which it does not promise."""
    from gwkit_torch.data.precession_ode import integrate_precession
    from gwkit_torch.data.waveforms import SourceDistribution

    n = int(GEN_WAVE_SECONDS * GEN_FS)
    z = torch.randn((4, n // 2 + 1), generator=torch.Generator().manual_seed(0), dtype=torch.complex64)
    probe = float((torch.fft.irfft(z.to(dev), n).cpu() - torch.fft.irfft(z, n)).abs().max()
                  / torch.fft.irfft(z, n).abs().max())
    ok = probe <= GEN_IRFFT_TOL
    emit("generation_irfft_probe", n=n, card_vs_cpu_max_err_of_max=probe, tol=GEN_IRFFT_TOL, ok=ok)
    if not ok:
        checks.failed.append("irfft of imaginary DC/Nyquist parts, card vs CPU")
    out = {}
    for ap in GEN_APPROXIMANTS:
        params = SourceDistribution(spin_max=0.99, isotropic_spins=True, approximant=ap).sample(
            np.random.default_rng(9), GEN_WAVE_BATCH)
        params["tc"] = np.full(GEN_WAVE_BATCH, 0.75 * GEN_WAVE_SECONDS, np.float32)  # generate.py's window
        _td(params, ap, dev)  # warm
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card = _td(params, ap, dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() - base
        t0 = time.perf_counter()
        cpu = _td(params, ap, "cpu")
        cpu_s = time.perf_counter() - t0
        errs = []
        for hk, hc in zip(card, cpu):
            scale = hc.abs().amax(dim=-1)
            errs.append(((hk.cpu() - hc).abs().amax(dim=-1) / scale))
        err = torch.stack(errs)  # (2, B): h+ and hx of each waveform
        finite = all(bool(torch.isfinite(h).all()) for h in card)
        ok = finite and float(err.max()) <= GEN_WAVE_TOL
        rec = dict(approximant=ap, batch=GEN_WAVE_BATCH, seconds=GEN_WAVE_SECONDS, sample_rate=GEN_FS,
                   wall_s_median=statistics.median(times), wall_s=times,
                   waveforms_per_second=GEN_WAVE_BATCH / statistics.median(times),
                   cpu_wall_s=cpu_s, cpu_waveforms_per_second=GEN_WAVE_BATCH / cpu_s,
                   peak_mem_gb=peak / 1e9, max_err_of_max=float(err.max()),
                   median_err_of_max=float(err.median()), tol=GEN_WAVE_TOL)
        if ap.endswith("-twospin"):
            m1, m2 = (torch.as_tensor(params[k], device=dev) for k in ("mass1", "mass2"))
            s1, s2 = (torch.as_tensor(np.stack([params[f"spin{i}x"], params[f"spin{i}y"], params[f"spin{i}z"]], 1),
                                      device=dev) for i in (1, 2))
            integrate_precession(m1, m2, s1, s2, 20.0, 1024.0)
            ode = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                integrate_precession(m1, m2, s1, s2, 20.0, 1024.0)
                torch.cuda.synchronize()
                ode.append(time.perf_counter() - t0)
            rec.update(ode_wall_s_median=statistics.median(ode), ode_steps=384,
                       ode_ms_per_step=statistics.median(ode) / 384 * 1e3,
                       ode_share_of_batch=statistics.median(ode) / statistics.median(times))
            profiled("generation_ode_profile", lambda: integrate_precession(m1, m2, s1, s2, 20.0, 1024.0),
                     batch=GEN_WAVE_BATCH, steps=384)
        emit("generation_waveforms", card=smi, **rec, ok=ok)
        if not ok:
            checks.failed.append(f"generation waveforms {ap}")
        out[ap] = rec
        del card, cpu
        torch.cuda.empty_cache()
    return out


def _gen_angles(checks, dev):
    """The precession angles on the card: the aligned limit frozen exactly
    (atan2(0, 0) = 0 on the card too), and the closed-form and two-spin
    (alpha, cos beta, eps) of the ds3/4 batch against the same functions
    on the CPU within GEN_ANGLE_TOL of each angle's max."""
    from gwkit_torch.data.imrphenomp import precession_angles
    from gwkit_torch.data.precession_ode import precession_angles_numerical
    from gwkit_torch.data.waveforms import SourceDistribution

    p = SourceDistribution(spin_max=0.99, isotropic_spins=True).sample(np.random.default_rng(9), GEN_WAVE_BATCH)
    freqs = torch.arange(int(GEN_WAVE_SECONDS * GEN_FS) // 2 + 1, dtype=torch.float32) / GEN_WAVE_SECONDS

    def angles(device):
        t = {k: torch.as_tensor(v, device=device) for k, v in p.items()}
        m1, m2, c1, c2 = t["mass1"], t["mass2"], t["spin1z"], t["spin2z"]
        s_z = (c1 * m1 ** 2 + c2 * m2 ** 2) / (m1 + m2) ** 2
        col = lambda x: x[:, None]
        closed = precession_angles(freqs.to(device), col(m1), col(m2), col(s_z), col(t["chi_p"]), col(t["alpha0"]))
        s1 = torch.stack([t["spin1x"], t["spin1y"], c1], dim=-1)
        s2 = torch.stack([t["spin2x"], t["spin2y"], c2], dim=-1)
        ode = precession_angles_numerical(m1, m2, s1, s2, alpha0=col(t["alpha0"]))(freqs.to(device))
        return closed + ode

    names = [f"{model}_{a}" for model in ("closed_form", "two_spin") for a in ("alpha", "cos_beta", "eps")]
    err = {n: float((k.cpu() - c).abs().max() / c.abs().max()) for n, k, c in zip(names, angles(dev), angles("cpu"))}
    z = torch.zeros(4, device=dev)
    s_al = torch.stack([z, z, torch.tensor([0.4, -0.7, 0.9, 0.0], device=dev)], dim=-1)
    a, cb, e = precession_angles_numerical(torch.full((4,), 36.0, device=dev), torch.full((4,), 29.0, device=dev),
                                           s_al, s_al.flip(0), alpha0=0.7)(freqs.to(dev))
    frozen = bool((a == np.float32(0.7)).all() and (cb == 1.0).all() and (e == np.float32(0.7)).all())
    ok = frozen and all(v <= GEN_ANGLE_TOL for v in err.values())
    emit("generation_angles", batch=GEN_WAVE_BATCH, bins=len(freqs), card_vs_cpu_max_err_of_max=err,
         tol=GEN_ANGLE_TOL, aligned_limit_frozen_on_card=frozen, ok=ok)
    if not ok:
        checks.failed.append("generation precession angles")


def _gen_injections(checks, noise, dev):
    """GEN_INJECTIONS ds3/4 injections (imrphenomxphm) with tc spread over
    the segment as phase 4c spreads its chirps: projected onto H1 and L1
    (antenna patterns, the geocenter delay as an FD phase, as generate.py),
    scaled to a network SNR drawn from U(8, 30) against the detectors'
    variants normalized (on the 64 s window's grid), added to ``noise`` in
    place. Returns the injection table for get_stats."""
    from gwkit_torch.data.detector import antenna_pattern, time_delay_from_earth_center
    from gwkit_torch.data.waveforms import SourceDistribution, fd_polarizations_switch
    from gwkit_torch.ops.psd import psd_variant
    from gwkit_torch.ops.snr import network_snr, optimal_snr

    rng = np.random.default_rng(19)
    params = SourceDistribution(spin_max=0.99, isotropic_spins=True, approximant="imrphenomxphm").sample(
        rng, GEN_INJECTIONS)
    tc = 5.0 + 14.0 * np.arange(GEN_INJECTIONS) + rng.uniform(0.5, 4.5, GEN_INJECTIONS)
    target = rng.uniform(*GEN_SNR, GEN_INJECTIONS)
    n = int(GEN_WAVE_SECONDS * GEN_FS)
    dt = 1.0 / GEN_FS
    tc_win = 0.75 * GEN_WAVE_SECONDS
    freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=dev) / GEN_WAVE_SECONDS
    t0 = time.perf_counter()
    p = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    hp, hc = fd_polarizations_switch(
        freqs, "imrphenomxphm", 20.0, p["mass1"], p["mass2"], p["distance"], p["inclination"],
        torch.full_like(p["mass1"], tc_win), p["coa_phase"], p["spin1z"], p["spin2z"], p["chi_p"], p["alpha0"])
    dets, strains, psd_n, scales = ("H1", "L1"), [], [], []
    for i, det in enumerate(dets):
        fp, fc = antenna_pattern(det, params["ra"], params["dec"], params["polarization"], tc)
        delay = time_delay_from_earth_center(det, params["ra"], params["dec"], tc)
        col = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)[:, None]
        hdet = (col(fp) * hp + col(fc) * hc) * torch.exp(-2j * np.pi * freqs * col(delay))
        strains.append(torch.fft.irfft(hdet, n) / dt)
        pw = psd_variant(n // 2 + 1, 1.0 / GEN_WAVE_SECONDS, GEN_F_LOW, det, 0)
        c = float(pw[pw > 0].mean())
        psd_n.append(torch.from_numpy((pw / c).astype(np.float32)).to(dev))
        scales.append(np.float32(np.sqrt(c)))
    # SNRs on normalized strain against the normalized PSD (f32 range, as gwkit's callers)
    snr = torch.stack([optimal_snr(h / s, pn, dt, 20.0) for h, pn, s in zip(strains, psd_n, scales)], dim=-1)
    net = network_snr(snr)
    gain = torch.as_tensor(target, dtype=torch.float32, device=dev) / net
    strains = [h * gain[:, None] for h in strains]
    again = network_snr(torch.stack([optimal_snr(h / s, pn, dt, 20.0) for h, pn, s in zip(strains, psd_n, scales)],
                                    dim=-1)).cpu().numpy()
    seg_n = noise.shape[-1]
    for j in range(GEN_INJECTIONS):
        s = int(round((tc[j] - tc_win) * GEN_FS))
        ws, we = max(0, -s), n - max(0, s + n - seg_n)
        for i in range(len(dets)):
            noise[i, max(s, 0): min(s + n, seg_n)] += strains[i][j, ws:we]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rel = np.abs(again / target - 1.0)
    ok = bool(rel.max() <= GEN_SNR_TOL) and bool(torch.isfinite(noise).all())
    emit("generation_injections", injections=GEN_INJECTIONS, approximant="imrphenomxphm",
         target_network_snr=target.tolist(), recomputed_max_rel_err=float(rel.max()), tol=GEN_SNR_TOL,
         snr_before_scaling=net.cpu().numpy().tolist(), wall_s=wall, ok=ok)
    if not ok:
        checks.failed.append("generation injection SNRs")
    # a source scaled by gain sits at distance / gain
    return {"tc": tc, "distance": params["distance"] / gain.cpu().numpy(), "mass1": params["mass1"],
            "mass2": params["mass2"]}


def generation_phase(checks, smi, bf16):
    """Phase 9: PSDs, colored noise, waveforms and injections on the card,
    then phase 4's bf16 task (loaded anew) and threshold on the generated
    foreground and background: launches, and the challenge statistics.
    Returns the searches' launches."""
    from gwkit_torch.search.cluster import SECONDS_PER_MONTH, get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import Segment, SlicerConfig

    t_phase = time.time()
    dev = torch.device("cuda")
    psds, foreground = _gen_psd_and_noise(checks, smi, dev)
    waveforms = _gen_waveforms(checks, smi, dev)
    _gen_angles(checks, dev)
    inj = _gen_injections(checks, foreground, dev)
    background = _gen_noise(psds, 21, dev)

    task, threshold = _capstone_search_task(), bf16["threshold"]
    cfg = SlicerConfig(batch_size=128)
    n_batches = [0]

    def score(windows):
        n_batches[0] += 1
        return task.score(windows)

    segs = {name: Segment(key=f"generated_{name}", strain=x.cpu().numpy(), start_time=0.0, delta_t=1.0 / GEN_FS)
            for name, x in (("foreground", foreground), ("background", background))}
    del foreground, background
    score_segments(score, [segs["foreground"]], cfg, trigger_threshold=threshold, device=dev)  # warm
    n_batches[0] = 0
    _cuda.reset_counts()
    res = {name: score_segments(score, [seg], cfg, trigger_threshold=threshold, device=dev)
           for name, seg in segs.items()}
    launches, plain, nb = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS), n_batches[0]
    nl = task.cfg.encoder.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    ok = launches == expect and not plain and nb > 0
    fg, bg = res["foreground"], res["background"]
    finite = all(np.isfinite(r.all_vals).all() and r.n_windows == 3000 for r in res.values())
    emit("search_generated", card=smi, seconds=GEN_SECONDS, windows={k: r.n_windows for k, r in res.items()},
         batches=nb, threshold=threshold, launches=launches, expected_launches=expect, plain_calls=plain,
         strain_seconds_per_second={k: r.throughput_x_realtime for k, r in res.items()},
         triggers={k: sum(len(v) for v in r.triggers.values()) for k, r in res.items()}, scores_finite=finite,
         ok=ok and finite)
    if not (ok and finite):
        checks.failed.append("search_generated launch counters")
    bt, bs, _ = get_clusters(bg.triggers)
    ev = _challenge_stats(np.vstack(get_clusters(fg.triggers)), np.vstack([bt, bs, np.full(len(bt), 0.2)]), inj,
                          GEN_SECONDS)
    ok_ev = ev["well_formed"] and ev["counts_agree"]
    emit("evaluate_generated", background_clusters=int(len(bt)), injections=GEN_INJECTIONS,
         duration_s=GEN_SECONDS, far_per_month_of_one_background_event=SECONDS_PER_MONTH / GEN_SECONDS,
         **ev, note="found counts and distances are findings, not gates: the capstone model was trained on other "
                    "data", ok=ok_ev)
    if not ev["well_formed"]:
        checks.failed.append("get_stats (generated search)")
    if not ev["counts_agree"]:
        checks.failed.append("get_stats found injections vs plain count (generated search)")
    emit("generation_phase", wall_s=time.time() - t_phase, waveform_batches={k: v["wall_s_median"]
                                                                              for k, v in waveforms.items()})
    return launches


PIPE_SECONDS, PIPE_SHORT = 3600.0, 600.0  # (a) one hour of ds3; (b) ds1 and ds3 card vs CPU
PIPE_SEED = 7
PIPE_WAVE_TOL = 2e-3   # card vs CPU, of the max: fg - bg (b) and each corpus waveform window (d)
PIPE_NOISE_STD = 0.05  # whitened-noise std card vs CPU (other draws), relative
PIPE_TRAIN_STEPS, PIPE_GLITCH_PER_CLASS = 8, 64


def _pipeline_spans(seconds):
    from gwkit_torch.data.segments import default_o3a_segments, restrict_segments

    return restrict_segments(default_o3a_segments(), seconds)[:1]


def _injection_windows(synth, si):
    """[s, e) sample ranges of segment si's injections, as _add_injections places them."""
    start, n = synth.spans[si][0], synth.n_samples(si)
    n_wave = int(synth.wave_duration * synth.sample_rate)
    tc = synth.params["tc"]
    out = []
    for t in tc[(tc >= start) & (tc < start + n / synth.sample_rate)]:
        s = int(round((t - 0.75 * synth.wave_duration - start) * synth.sample_rate))
        if max(s, 0) < min(s + n_wave, n):
            out.append((max(s, 0), min(s + n_wave, n)))
    return out


def _pipeline_challenge(checks, smi, dev):
    """(a): dataset 3, one hour, in memory on the card: the table against the
    CPU's, the Welch PSD of each background against its target, fg - bg zero
    exactly outside the injections' windows and non-zero inside each.
    Returns the synthesis and the segment."""
    from gwkit_torch.data.generate import N_CHUNK, ChallengePSDSelector, ChallengeSynthesis
    from gwkit_torch.ops.psd import welch_psd

    kw = dict(duration=PIPE_SECONDS, seed=PIPE_SEED, dataset=3, segments=_pipeline_spans(PIPE_SECONDS))
    ChallengeSynthesis(**{**kw, "duration": 300.0, "segments": _pipeline_spans(300.0)}, device=dev).segment(0)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    synth = ChallengeSynthesis(**kw, device=dev)
    start, bg, fg = synth.segment(0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    cpu = ChallengeSynthesis(**kw, device="cpu")  # the host's table and PSD choices, no segment made
    table_equal = sorted(cpu.params) == sorted(synth.params) and all(
        np.array_equal(cpu.params[k], synth.params[k]) for k in cpu.params)
    keys_equal = [cpu.psd_key(0, d) for d in synth.detectors] == [synth.psd_key(0, d) for d in synth.detectors]
    n = synth.n_samples(0)
    ratios = {}
    for det in synth.detectors:
        key = synth.psd_key(0, det)
        target = ChallengePSDSelector(3, PIPE_SEED, synth.detectors).psd_array(
            key, N_CHUNK // 2 + 1, synth.sample_rate / N_CHUNK, synth.f_lower - 2.0)
        c = float(target[target > 0].mean())
        est = welch_psd((bg[det] / np.sqrt(c))[None], 1.0 / synth.sample_rate, segment_duration=4.0)[0].cpu().numpy()
        f_est = np.arange(len(est)) * 0.25
        band = (f_est >= 30.0) & (f_est <= 900.0)
        f = np.arange(len(target)) * synth.sample_rate / N_CHUNK
        ratios[det] = float(np.median(est[band] / (np.interp(f_est, f, target) / c)[band]))
    windows = _injection_windows(synth, 0)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    for s, e in windows:
        inside[s:e] = True
    outside_zero, each_nonzero = True, True
    for det in synth.detectors:
        d = fg[det] - bg[det]
        outside_zero &= bool((d[~inside] == 0).all())
        each_nonzero &= all(bool((d[s:e] != 0).any()) for s, e in windows)
    finite = all(bool(torch.isfinite(x[det]).all()) for x in (bg, fg) for det in synth.detectors)
    ok_psd = all(0.9 <= r <= 1.1 for r in ratios.values())
    ok = table_equal and keys_equal and ok_psd and outside_zero and each_nonzero and finite and len(windows) > 100
    emit("pipeline_challenge", card=smi, dataset=3, seconds=n / synth.sample_rate, samples=n,
         chunks=-(-n // N_CHUNK), injections=len(synth.params["tc"]), injection_windows=len(windows),
         psd_keys={d: list(synth.psd_key(0, d)) for d in synth.detectors}, table_equal_to_cpu=table_equal,
         psd_keys_equal_to_cpu=keys_equal, welch_median_ratio_30_900hz=ratios,
         fg_minus_bg_zero_outside_windows=outside_zero, fg_minus_bg_nonzero_in_each_window=each_nonzero,
         wall_s=wall, strain_seconds_per_second=len(synth.detectors) * n / synth.sample_rate / wall,
         peak_mem_gb=peak / 1e9, ok=ok)
    if not ok:
        checks.failed.append("pipeline challenge (dataset 3, one hour)")
    return synth, start, bg, fg


def _pipeline_card_vs_cpu(checks, dev):
    """(b): datasets 1 and 3 at PIPE_SHORT seconds on the card and on the
    CPU from one seed: the table and PSD keys bit for bit, fg - bg within
    PIPE_WAVE_TOL of its max (the noise draws are each device's own)."""
    from gwkit_torch.data.generate import ChallengeSynthesis

    for dataset in (1, 3):
        kw = dict(duration=PIPE_SHORT, seed=PIPE_SEED, dataset=dataset, segments=_pipeline_spans(PIPE_SHORT))
        out, walls = {}, {}
        for name, d in (("card", dev), ("cpu", "cpu")):
            t0 = time.perf_counter()
            synth = ChallengeSynthesis(**kw, device=d)
            _, bg, fg = synth.segment(0)
            out[name] = (synth, {k: (fg[k] - bg[k]).cpu() for k in bg})
            walls[name] = time.perf_counter() - t0
        (card, dc), (cpu, dp) = out["card"], out["cpu"]
        table = all(np.array_equal(card.params[k], cpu.params[k]) for k in cpu.params) and \
            sorted(card.params) == sorted(cpu.params)
        keys = [card.psd_key(0, d) for d in card.detectors] == [cpu.psd_key(0, d) for d in cpu.detectors]
        err = {k: float((dc[k] - dp[k]).abs().max() / dp[k].abs().max()) for k in dp}
        ok = table and keys and all(e <= PIPE_WAVE_TOL for e in err.values())
        emit("pipeline_card_vs_cpu", dataset=dataset, seconds=PIPE_SHORT, injections=len(cpu.params["tc"]),
             table_bit_equal=table, psd_keys_equal=keys, fg_minus_bg_max_err_of_max=err, tol=PIPE_WAVE_TOL,
             card_wall_s=walls["card"], cpu_wall_s=walls["cpu"], ok=ok)
        if not ok:
            checks.failed.append(f"pipeline dataset {dataset} card vs CPU")


def _pipeline_search(checks, smi, bf16, synth, start, bg, fg, dev):
    """(c): phase 4's bf16 task and threshold on the hour's foreground and
    background: launches a batch, get_stats against the generated table."""
    from gwkit_torch.search.cluster import SECONDS_PER_MONTH, get_clusters
    from gwkit_torch.search.engine import score_segments
    from gwkit_torch.search.slicer import Segment, SlicerConfig

    task, threshold = _capstone_search_task(), bf16["threshold"]
    cfg = SlicerConfig(batch_size=128)
    n_batches = [0]

    def score(windows):
        n_batches[0] += 1
        return task.score(windows)

    dets = synth.detectors
    segs = {name: Segment(key=f"pipeline_{name}", strain=torch.stack([x[d] for d in dets]).cpu().numpy(),
                          start_time=start, delta_t=1.0 / synth.sample_rate)
            for name, x in (("foreground", fg), ("background", bg))}
    warm = Segment(key="warm", strain=segs["foreground"].strain[:, :int(300 * synth.sample_rate)], start_time=start,
                   delta_t=1.0 / synth.sample_rate)
    score_segments(score, [warm], cfg, trigger_threshold=threshold, device=dev)
    n_batches[0] = 0
    _cuda.reset_counts()
    res = {name: score_segments(score, [seg], cfg, trigger_threshold=threshold, device=dev)
           for name, seg in segs.items()}
    launches, plain, nb = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS), n_batches[0]
    nl = task.cfg.encoder.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    finite = all(np.isfinite(r.all_vals).all() for r in res.values())
    ok = launches == expect and not plain and nb > 0 and finite
    emit("search_pipeline", card=smi, seconds=PIPE_SECONDS, windows={k: r.n_windows for k, r in res.items()},
         batches=nb, threshold=threshold, launches=launches, expected_launches=expect, plain_calls=plain,
         strain_seconds_per_second={k: r.throughput_x_realtime for k, r in res.items()},
         wall_s={k: r.wall_seconds for k, r in res.items()},
         triggers={k: sum(len(v) for v in r.triggers.values()) for k, r in res.items()}, scores_finite=finite,
         ok=ok)
    if not ok:
        checks.failed.append("search_pipeline launch counters")
    bt, bs, _ = get_clusters(res["background"].triggers)
    p = synth.params
    inj = {"tc": p["tc"], "distance": p["distance"], "mass1": p["mass1"], "mass2": p["mass2"]}
    ev = _challenge_stats(np.vstack(get_clusters(res["foreground"].triggers)),
                          np.vstack([bt, bs, np.full(len(bt), 0.2)]), inj, PIPE_SECONDS)
    ok_ev = ev["well_formed"] and ev["counts_agree"]
    emit("evaluate_pipeline", background_clusters=int(len(bt)), injections=len(p["tc"]), duration_s=PIPE_SECONDS,
         far_per_month_of_one_background_event=SECONDS_PER_MONTH / PIPE_SECONDS, **ev,
         note="found counts and distances are findings, not gates: the capstone model was trained on other data",
         ok=ok_ev)
    if not ev["well_formed"]:
        checks.failed.append("get_stats (pipeline search)")
    if not ev["counts_agree"]:
        checks.failed.append("get_stats found injections vs plain count (pipeline search)")
    return launches


def _pipeline_corpus(checks, smi, dev):
    """(d): the training corpus's arrays on the card (1024 + 256 windows,
    imrphenomd, 16 s waves) against the CPU path: each waveform window
    within PIPE_WAVE_TOL of its max, the whitened noise's std within
    PIPE_NOISE_STD (other draws); then 512 waveforms and 1024 noise windows
    timed, and the noise alone."""
    from gwkit_torch.data import generate as G

    kw = dict(n_train=1024, n_valid=256, seed=PIPE_SEED, wave_duration=16.0)
    G.synthesize_training_set(n_train=16, n_valid=0, seed=PIPE_SEED, wave_duration=16.0, device=dev)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = G.synthesize_training_set(**kw, device=dev)
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = G.synthesize_training_set(**kw, device="cpu")
    cpu_wall = time.perf_counter() - t0
    errs, stds = [], {}
    for split in card:
        (wk, nk), (wc, nc) = card[split], cpu[split]
        assert wk.shape == wc.shape and nk.shape == nc.shape
        errs.append((np.abs(wk - wc).max(axis=(1, 2)) / np.abs(wc).max(axis=(1, 2))))
        stds[split] = {"card": float(nk.std()), "cpu": float(nc.std())}
    err = np.concatenate(errs)
    finite = all(np.isfinite(a).all() for pair in card.values() for a in pair)
    std_ok = all(abs(s["card"] / s["cpu"] - 1.0) <= PIPE_NOISE_STD for s in stds.values())
    ok = finite and float(err.max()) <= PIPE_WAVE_TOL and std_ok

    # 512 waveforms with 1024 noise windows, and the noise alone (median of 3 each)
    def timed(fraction):
        fn = lambda: G.synthesize_training_set(n_train=1024, n_valid=0, waveform_fraction=fraction, seed=PIPE_SEED,
                                               wave_duration=16.0, device=dev)
        fn()
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts)

    times = {"both": timed(0.5), "noise": timed(0.0)}
    times["waves"] = times["both"] - times["noise"]
    emit("pipeline_corpus", card=smi, n_train=1024, n_valid=256, approximant="imrphenomd", wave_seconds=16.0,
         waveforms=int(sum(len(v[0]) for v in card.values())), noises=int(sum(len(v[1]) for v in card.values())),
         wall_s=wall, cpu_wall_s=cpu_wall, waveform_max_err_of_max=float(err.max()),
         waveform_median_err_of_max=float(np.median(err)), tol=PIPE_WAVE_TOL, whitened_noise_std=stds,
         std_tol=PIPE_NOISE_STD, waveforms_per_second=512 / times["waves"],
         noise_windows_per_second=1024 / times["noise"],
         timed_s={"512_waveforms_and_1024_noises": times["both"], "1024_noises": times["noise"]}, ok=ok)
    if not ok:
        checks.failed.append("pipeline training corpus card vs CPU")
    return card


def _pipeline_train(checks, smi, corpus, dev):
    """(e): phase 5's recipe on an InjectionDataset of (d)'s training split:
    a warm step, then PIPE_TRAIN_STEPS steps with launch counters."""
    from gwkit_torch.cli.inference import _load_gwkit_encoder
    from gwkit_torch.data.datasets import InjectionDataset
    from gwkit_torch.io import from_gwkit_numpy
    from gwkit_torch.models.adapters import AdapterConfig
    from gwkit_torch.models.qadapter import QAdapterConfig
    from gwkit_torch.models.whisper import config_for
    from gwkit_torch.train.tasks import build_mlgwsc
    from gwkit_torch.train.trainer import TrainConfig, Trainer

    frames, batch = 512, 64
    enc_cfg = config_for("tiny", compute_dtype=torch.bfloat16, fused_block=True, gelu_approx=True,
                         max_positions=frames // 2)
    encoder = from_gwkit_numpy(encoder=_load_gwkit_encoder(f"{CAPSTONE}/encoder_pretrained.npz", "tiny",
                                                           enc_cfg))["encoder"]
    task = build_mlgwsc(enc_cfg, QAdapterConfig(median_stride=8, target_shape=(80, frames)), {"encoder": encoder},
                        usr=False, device=dev, acfg=AdapterConfig(r=8, alpha=32, use_dora=True, targets="qkvo"), seed=0)
    waves, noises = corpus["training"]
    train = InjectionDataset(noises, waves, (7.0, 20.0), dev)
    steps = list(train.batches(torch.Generator().manual_seed(9), batch))[:PIPE_TRAIN_STEPS + 1]
    cfg = TrainConfig(learning_rate=3e-4, clip_norm=100.0, epochs=1, batch_size=batch, optimizer="adam", seed=0)
    trainer = Trainer(task.loss_fn, task.trainable, task.frozen, cfg)
    losses = [trainer.train_step(steps[0])[0]]
    torch.cuda.synchronize()
    _cuda.reset_counts()
    t0 = time.perf_counter()
    losses += [trainer.train_step(b)[0] for b in steps[1:]]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
    losses = torch.stack(losses).float().cpu().numpy()
    expect = {k: v * PIPE_TRAIN_STEPS for k, v in ONE_STEP.items()}
    ok = launches == expect and not plain and bool(np.isfinite(losses).all())
    emit("train_pipeline", card=smi, recipe="phase 5's: capstone encoder frozen, DoRA r=8 a=32 qkvo, batch 64, bf16, "
         "Adam 3e-4, clip 100", dataset={"noises": list(noises.shape), "waveforms": list(waves.shape),
                                        "snr_range": [7.0, 20.0]},
         steps=PIPE_TRAIN_STEPS, losses=losses.tolist(), launches=launches, expected_launches=expect,
         plain_calls=plain, wall_s=wall, samples_per_s=batch * PIPE_TRAIN_STEPS / wall, ok=ok)
    if not ok:
        checks.failed.append("train_pipeline")
    return launches


def _pipeline_glitch(checks, smi, dev):
    """(f): the synthetic corpus (numpy) bit-equal run to run, and the
    realistic corpus on the card under gwkit's calibration gate."""
    from gwkit_torch.data.glitch import realistic_glitch_dataset, synthetic_glitch_dataset

    a, b = synthetic_glitch_dataset(8, seed=PIPE_SEED), synthetic_glitch_dataset(8, seed=PIPE_SEED)
    synth_equal = all(np.array_equal(x, y) for x, y in zip(a, b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x, y, (ach, tgt) = realistic_glitch_dataset(PIPE_GLITCH_PER_CLASS, seed=PIPE_SEED, return_achieved=True,
                                                device=dev)
    wall = time.perf_counter() - t0
    ratio = ach[tgt > 0] / tgt[tgt > 0]
    med, spread = float(np.median(ratio)), float(np.quantile(ratio, 0.9) / np.quantile(ratio, 0.1))
    ok = synth_equal and 0.5 < med < 2.0 and spread < 2.0 and bool(np.isfinite(x).all()) and \
        x.shape == (11 * PIPE_GLITCH_PER_CLASS, 2048)
    emit("pipeline_glitch", card=smi, synthetic_shape=list(a[0].shape), synthetic_bit_equal=synth_equal,
         realistic_shape=list(x.shape), achieved_over_target_median=med, spread_90_10=spread,
         gate={"median": [0.5, 2.0], "spread_below": 2.0}, wall_s=wall, samples_per_s=len(x) / wall, ok=ok)
    if not ok:
        checks.failed.append("pipeline glitch corpora")


def pipeline_phase(checks, smi, bf16):
    """Phase 10: data generation's pipeline on the card, (a)-(f). Returns the
    search's and the training's launches."""
    t_phase = time.time()
    dev = torch.device("cuda")
    synth, start, bg, fg = _pipeline_challenge(checks, smi, dev)
    _pipeline_card_vs_cpu(checks, dev)
    search = _pipeline_search(checks, smi, bf16, synth, start, bg, fg, dev)
    del bg, fg
    torch.cuda.empty_cache()
    corpus = _pipeline_corpus(checks, smi, dev)
    train = _pipeline_train(checks, smi, corpus, dev)
    _pipeline_glitch(checks, smi, dev)
    emit("pipeline_phase", wall_s=time.time() - t_phase)
    return search, train



# phase 11: the last of gwkit's surface on the card: the search traced by kernel name (gwkit_torch.utils.tracing)
# and the Q-scan's time_decimation
TRACE_BATCHES = 2
DECIMATION = 4
# gwkit's bar for the decimated spectrogram (tests/test_qtransform.py::test_qscan_decimated_spectrogram_close),
# set there on a 180 Hz sine-Gaussian burst (tau 0.05 s) of 10x the noise's amplitude, which this phase adds to
# the windows it holds to the bar
DECIMATION_CORR = 0.98
BURST_OVER_NOISE = 10.0


def _row_correlation(a, b):
    """Pearson correlation of each (F, T) spectrogram of ``a`` with b's."""
    a, b = a.reshape(a.shape[0], -1).double(), b.reshape(b.shape[0], -1).double()
    a, b = a - a.mean(dim=1, keepdim=True), b - b.mean(dim=1, keepdim=True)
    return (a * b).sum(dim=1) / (a.norm(dim=1) * b.norm(dim=1))


def _traced_search(checks, smi, task, batches):
    """(a): trace(logdir) around phase 4's bf16 search of ``batches``
    inside annotate("search"); the trace's device events in the region, by
    kernel group, against the launch counters."""
    from gwkit_torch.utils.tracing import annotate, trace

    with trace(None):
        untraced = not torch.autograd.profiler._is_profiler_enabled
    with torch.no_grad(), tempfile.TemporaryDirectory(prefix="gwkit_torch_trace_") as logdir:
        task.score(batches[0])  # warm
        torch.cuda.synchronize()
        _cuda.reset_counts()
        with trace(logdir):
            t0 = time.time()
            with annotate("search"):
                scores = [task.score(w) for w in batches]
            torch.cuda.synchronize()
            wall_ms = (time.time() - t0) * 1e3
        launches, plain = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS)
        files = [f for f in os.listdir(logdir) if f.endswith(".pt.trace.json")]
        assert len(files) == 1, files
        trace_file, trace_bytes = files[0], os.path.getsize(os.path.join(logdir, files[0]))
        with open(os.path.join(logdir, trace_file)) as f:
            events = json.load(f)["traceEvents"]
    region = [e for e in events if e.get("ph") == "X" and e.get("name") == "search"]
    assert len(region) == 1, f"{len(region)} 'search' regions in the trace"
    r0, r1 = region[0]["ts"], region[0]["ts"] + region[0]["dur"]
    # a device event is in the region when the host call that launched it
    # (the same correlation id) lies in it
    corr = lambda e: (e.get("args") or {}).get("correlation")
    launched = {corr(e): e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver") and r0 <= e["ts"] <= r1}
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    inside = [e for e in device if corr(e) in launched]
    ops = [e for e in events if e.get("cat") == "cpu_op" and r0 <= e["ts"] <= r1]

    def launching_op(launch):
        """The innermost host op (aten::...) around a kernel's launch."""
        around = [o for o in ops if o["tid"] == launch["tid"] and o["ts"] <= launch["ts"] <= o["ts"] + o["dur"]]
        return min(around, key=lambda o: o["dur"])["name"] if around else "(no host op)"

    count, ms, by_name, other_by_op = {}, {}, {}, {}
    for e in inside:
        g, t = _kernel_group(e["name"]), e.get("dur", 0.0) / 1e3
        count[g] = count.get(g, 0) + 1
        ms[g] = ms.get(g, 0.0) + t
        n, total = by_name.get(e["name"], (0, 0.0))
        by_name[e["name"]] = (n + 1, total + t)
        if g.startswith("other"):
            op = launching_op(launched[corr(e)])
            n, total = other_by_op.get(op, (0, 0.0))
            other_by_op[op] = (n + 1, total + t)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:16]
    nl, nb = task.cfg.encoder.n_layers, len(batches)
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    traced = {"attention": count.get("attention_kernel", 0), "ln_gemm": count.get("ln_gemm_kernel", 0),
              "fused_mlp": count.get("fused_mlp_kernel", 0)}
    ok = (untraced and launches == expect and not plain and traced == {k: expect[k] for k in traced}
          and all(torch.isfinite(s).all() for s in scores))
    device_ms = sum(ms.values())
    emit("search_traced", card=smi, batches=nb, trace_file=trace_file, trace_bytes=trace_bytes,
         trace_events=len(events), region_host_ms=region[0]["dur"] / 1e3, wall_ms_profiled=wall_ms,
         device_events_in_region=len(inside), device_events_in_trace=len(device),
         device_ms_in_region=device_ms, device_busy_share=device_ms / wall_ms,
         device_ms_by_group={k: v for k, v in sorted(ms.items(), key=lambda kv: -kv[1])},
         device_events_by_group=count,
         top_device_events_in_region=[{"ms": t, "count": n, "group": _kernel_group(k), "name": k[:100]}
                                      for k, (n, t) in top],
         other_device_ms_by_host_op={k: {"ms": t, "count": n}
                                     for k, (n, t) in sorted(other_by_op.items(), key=lambda kv: -kv[1][1])},
         traced_kernel_launches=traced, launches=launches, expected_launches=expect,
         plain_calls=plain, trace_none_records_nothing=untraced, ok=ok)
    if not ok:
        checks.failed.append("search traced by kernel name")


def _decimated_qscan(checks, smi, task, windows):
    """(b) first half: qscan at d = DECIMATION on the whitened windows, card
    vs CPU in f32, and the d = 4 spectrogram against d = 1's."""
    from gwkit_torch.ops.qtransform import _row_energies, make_qplan, plane_peaks, qscan

    q = task.qcfg
    plan = make_qplan(q.kernel_length, float(q.sample_rate), q.q_range, q.spectrogram_shape)
    kw = dict(norm=q.qscan_norm, median_stride=q.median_stride)
    x = windows.reshape(-1, windows.shape[-1]).float()  # (windows x detectors, samples)
    t = torch.arange(x.shape[-1], device=x.device) / float(q.sample_rate)
    burst = torch.sin(2 * np.pi * 180 * t) * torch.exp(-(((t - 0.5) / 0.05) ** 2))
    loud = x + BURST_OVER_NOISE * x.std() * burst
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    with torch.no_grad():
        t0 = time.time()
        card = qscan(x, plan, time_decimation=DECIMATION, **kw)
        torch.cuda.synchronize()
        card_ms = (time.time() - t0) * 1e3
        cpu = qscan(x.cpu(), plan, time_decimation=DECIMATION, **kw)
        full = qscan(x, plan, **kw)
        loud_corr = _row_correlation(qscan(loud, plan, time_decimation=DECIMATION, **kw), qscan(loud, plan, **kw))
        noise_corr = _row_correlation(card, full)
        _, r1 = _row_energies(x, plan, q.qscan_norm, q.median_stride)
        _, rd = _row_energies(x, plan, q.qscan_norm, q.median_stride, DECIMATION)
        peaks = torch.sort(plane_peaks(_row_energies(x.cpu(), plan, q.qscan_norm, q.median_stride, DECIMATION)[1],
                                       plan), dim=1).values
    margin = float(((peaks[:, -1] - peaks[:, -2]) / peaks[:, -1]).min())
    checks.compare(f"qscan time_decimation={DECIMATION}: card vs CPU, f32 ({windows.shape[0]} whitened windows "
                   f"x {windows.shape[1]} detectors of phase 4's segment)", card.cpu(), cpu, TOL[torch.float32],
                   best_plane_margin_min=margin)
    ok = bool(loud_corr.min() > DECIMATION_CORR) and bool(torch.isfinite(card).all())
    emit("qscan_decimated", card=smi, windows=int(windows.shape[0]), rows=int(x.shape[0]), d=DECIMATION,
         shape=list(card.shape[1:]), card_ms_first_call=card_ms,
         correlation_with_d1_burst_windows={"min": float(loud_corr.min()), "median": float(loud_corr.median())},
         burst="180 Hz sine-Gaussian, tau 0.05 s, at 0.5 s, amplitude 10x the windows' std (gwkit's test)",
         tol=DECIMATION_CORR,
         correlation_with_d1_noise_windows={"min": float(noise_corr.min()), "median": float(noise_corr.median())},
         best_plane_differs_from_d1_noise_windows=float(
             (plane_peaks(r1, plan).argmax(dim=1) != plane_peaks(rd, plan).argmax(dim=1)).float().mean()),
         note="the bar is gwkit's, on a loud burst; on noise alone the decimated scan picks another plane for part "
              "of the windows, in gwkit as here (the CPU tests hold the two packages equal at d = 4)", ok=ok)
    if not ok:
        checks.failed.append("decimated spectrogram vs d = 1")


def _decimated_search(checks, smi, task, bf16):
    """(b) second half: phase 4's segment searched with
    QAdapterConfig(time_decimation=DECIMATION): 4 A, 8 B, 4 C a batch, no
    plain call; scores and triggers against phase 4's d = 1 search."""
    from gwkit_torch.search.engine import score_segments

    task = dataclasses.replace(task, qcfg=dataclasses.replace(task.qcfg, time_decimation=DECIMATION))
    seg, cfg, threshold = bf16["segment"], bf16["cfg"], bf16["threshold"]
    n_batches = [0]

    def score(windows):
        n_batches[0] += 1
        return task.score(windows)

    warm = score_segments(score, [seg], cfg, trigger_threshold=threshold, device=task.device)
    n_batches[0] = 0
    _cuda.reset_counts()
    res = score_segments(score, [seg], cfg, trigger_threshold=threshold, device=task.device)
    launches, plain, nb = dict(_cuda.LAUNCHES), dict(_cuda.PLAIN_CALLS), n_batches[0]
    nl = task.cfg.encoder.n_layers
    expect = {"attention": nl * nb, "attention_bwd": 0, "ln_gemm": 2 * nl * nb, "fused_mlp": nl * nb, "int8_gemm": 0}
    finite = bool(np.isfinite(res.all_vals).all())
    ok = launches == expect and not plain and nb > 0 and finite and res.n_windows == len(bf16["all_vals"])
    t_dec, t_full = _trigger_times(res.triggers), bf16["trigger_times"]
    union = t_dec | t_full
    emit("search_decimated", card=smi, d=DECIMATION, windows=res.n_windows, batches=nb, threshold=threshold,
         launches=launches, expected_launches=expect, plain_calls=plain, scores_finite=finite,
         strain_seconds_per_second=res.throughput_x_realtime,
         warm_strain_seconds_per_second=warm.throughput_x_realtime, wall_s=res.wall_seconds,
         triggers={"d4": len(t_dec), "d1": len(t_full)},
         score_correlation_with_d1=float(np.corrcoef(res.all_vals, bf16["all_vals"])[0, 1]),
         trigger_jaccard_with_d1=len(t_dec & t_full) / len(union) if union else 1.0, ok=ok)
    if not ok:
        checks.failed.append("search_decimated launch counters")
    profiled("profile_decimated", lambda: score_segments(task.score, [seg], cfg, trigger_threshold=threshold,
                                                         device=task.device), d=DECIMATION)
    return launches


def utils_phase(checks, smi, bf16):
    """Phase 11: (a) phase 4's search traced by kernel name; (b) the Q-scan's
    time_decimation on the card and a search with it. Returns (b)'s
    search's launches."""
    from gwkit_torch.search.slicer import DeviceSlicer

    t_phase = time.time()
    task = _capstone_search_task()
    batches = []
    for windows, _, valid in DeviceSlicer(bf16["segment"], bf16["cfg"], device=task.device).batches():
        assert valid.all()
        batches.append(windows)
        if len(batches) == TRACE_BATCHES:
            break
    _traced_search(checks, smi, task, batches)
    _decimated_qscan(checks, smi, task, torch.cat(batches))
    search = _decimated_search(checks, smi, task, bf16)
    emit("utils_phase", wall_s=time.time() - t_phase)
    return search


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    checks = Checks()
    smi = device_phase()
    build_phase(checks)
    arithmetic_checks(checks)
    int8_arithmetic_check(checks)
    records = parity_phase(checks)
    records["attention_bwd"] = attention_bwd_phase(checks)
    layer_grad_phase(checks)
    records["int8_gemm"] = int8_phase(checks)
    bf16_search = search_phase(checks, smi)
    search = bf16_search["launches"]
    search_stream = stream_search_phase(checks, smi, bf16_search)
    del bf16_search["task"]
    search_int8, int8_task = int8_search_phase(checks, smi, bf16_search)
    server_phase(checks, int8_task)
    del int8_task
    torch.cuda.empty_cache()
    train = train_phase(checks, smi)
    mel, mel_train = mel_phase(checks, smi)
    eff_train, eff, real = efficiency_phase(checks, smi)
    search_mesh, train_mesh = parallel_phase(checks, smi, bf16_search)
    search_generated = generation_phase(checks, smi, bf16_search)
    search_pipeline, train_pipeline = pipeline_phase(checks, smi, bf16_search)
    search_decimated = utils_phase(checks, smi, bf16_search)
    kernels = []
    for name in KERNELS:
        r = records[name]
        # each kernel's launches on its own path: the search (forward), the
        # int8 search for kernel E, training for the attention backward
        main_path = {"attention_bwd": train, "int8_gemm": search_int8}.get(name, search)
        extra = {key: r[key] for key in ("int_mm_ms", "int_mm_device_ms", "gemm_ms", "gemm_device_ms", "device_ms",
                                         "library_device_ms",
                                         "standalone_ms", "standalone_device_ms", "standalone_plain_ms") if key in r}
        kernels.append({"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
                        "launches": main_path[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"], "grids_per_launch": GRIDS_PER_LAUNCH[name],
                        "launches_by_path": {"search": search.get(name, 0), "search_stream": search_stream.get(name, 0),
                                             "search_int8": search_int8.get(name, 0),
                                             "train": train.get(name, 0), "mel": mel.get(name, 0),
                                             "mel_train": mel_train.get(name, 0),
                                             "efficiency_train": eff_train.get(name, 0),
                                             "efficiency": eff.get(name, 0), "real_events": real.get(name, 0),
                                             "search_mesh": search_mesh.get(name, 0),
                                             "train_mesh": train_mesh.get(name, 0),
                                             "search_generated": search_generated.get(name, 0),
                                             "search_pipeline": search_pipeline.get(name, 0),
                                             "train_pipeline": train_pipeline.get(name, 0),
                                             "search_decimated": search_decimated.get(name, 0)},
                        **extra})
    if checks.failed:
        print("chip_smoke: FAILED " + ", ".join(checks.failed), file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
