"""The operation and byte counts against hand counts at the two cells' token
counts (T = 256 for the search, T = 1500 for the classifier)."""
import pytest

from gwbench import counts, files

D, F, H = 384, 1536, 6


@pytest.mark.parametrize("T, gflop", [(256, 4.027), (1500, 35.06)])
def test_encoder_flops_by_hand(T, gflop):
    qkv, o, att, mlp = 2 * T * D * 3 * D, 2 * T * D * D, 2 * 2 * T * T * D, 2 * 2 * T * D * F
    assert counts.encoder_layer_flops(T, D, F) == qkv + o + att + mlp
    assert counts.encoder_flops(files.config("svn-mel-tiny"), T) / 1e9 == pytest.approx(gflop, rel=1e-3)


@pytest.mark.parametrize("seqs, T", [(256, 256), (128, 1500)])
def test_layer_launches_by_hand(seqs, T):
    M = seqs * T
    per = counts.layer_launches(seqs, T, D, F, H, 2)
    (qb, qf), (ob, of) = per["ln_gemm"]
    assert qf == 2 * M * D * 3 * D and of == 2 * M * D * D
    assert qb == 2 * (M * D + 3 * D * D + 2 * D + 3 * M * D) + 4 * 3 * D  # x, W, LN g/b, qkv out; f32 bias
    assert ob == 2 * (M * D + D * D + 2 * M * D) + 4 * D  # attention out, W, residual in, out; f32 bias
    assert per["attention"] == [(2 * 4 * M * D, 4 * seqs * H * T * T * (D // H))]
    assert per["fused_mlp"] == [(2 * (2 * M * D + 2 * D + 2 * D * F) + 4 * (F + D), 4 * M * D * F)]


def test_whole_step_flops_by_hand():
    stem = lambda frames: 2 * frames * 80 * 3 * D + 2 * (frames // 2) * D * 3 * D
    q = 2 * 9 * 32 * 128 * 128 + 2 * 9 * 32 * 64 * 64 * 64 + 2 * 9 * 64 * 128 * 32 * 32 + 2 * 128 * 32 * 32
    head = 2 * (768 * 512 + 512 * 256 + 256 * 128 + 128 * 64 + 64 * 2)
    enc = 4 * counts.encoder_layer_flops(256, D, F)
    assert counts.search_window_flops(files.config("mlgwsc-capstone-tiny")) == 2 * (q + stem(512) + enc) + head
    head = 2 * (768 * 1024 + 1024 * 512 + 512 * 256 + 256 * 1)
    enc = 4 * counts.encoder_layer_flops(1500, D, F)
    assert counts.classify_sample_flops(files.config("svn-mel-tiny")) == 2 * (stem(3000) + enc) + head
    assert stem(3000) / 1e9 == pytest.approx(1.88, abs=0.01)


def test_least_seconds_and_peaks():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    assert counts.least_seconds(3.35e9, 0, peak) == pytest.approx(1e-3)
    assert counts.least_seconds(0, 989e9, peak) == pytest.approx(1e-3)
    assert counts.peaks("a card not in the table") is None
