"""Port parity: the encoder-layer kernel chain (gwkit_torch.ops.fused_block,
each stage on its plain version on the CPU) against gwkit's whole-layer
Pallas kernel in interpret mode, its _reference_block and whisper._block.
Same weights (bridged with from_gwkit_numpy) and inputs; f32; rtol 2e-5,
atol 2e-6, as tests/test_fused_block.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.models.adapters import AdapterConfig, init_adapters
from gwkit.models.whisper import WhisperConfig, _block as gw_block, init_encoder_params
from gwkit.ops.fused_block import _reference_block as gw_reference_block
from gwkit.ops.fused_block import fused_encoder_block as gw_fused_block
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.ops import fused_block as fb
from gwkit_torch.ops.fused_mlp import fused_mlp_block

CFG = WhisperConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=64)
TOL = dict(rtol=2e-5, atol=2e-6)


@pytest.fixture(scope="module")
def setup():
    params = init_encoder_params(jax.random.PRNGKey(0), CFG)
    adapters = init_adapters(jax.random.PRNGKey(1), CFG,
                             AdapterConfig(r=4, alpha=8, use_dora=True, targets="qkvo"), params)
    # non-zero B so the low-rank path contributes (as tests/test_fused_block.py)
    adapters = jax.tree.map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07, adapters)
    gw_p = jax.tree.map(lambda a: a[0], params["layers"])
    gw_ad = jax.tree.map(lambda a: a[0], adapters)
    port = from_gwkit_numpy(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, adapters))
    return gw_p, gw_ad, port["encoder"]["layers"][0], port["adapters"][0]


def _x(T, seed):
    return np.random.default_rng(seed).normal(size=(2, T, 64)).astype(np.float32)


@pytest.mark.parametrize("T", [50, 130, 300])
@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("with_adapters", [False, True])
def test_block_chain_matches_gwkit_fused_kernel(setup, with_adapters, approx, T):
    gw_p, gw_ad, p, ad = setup
    x = _x(T, seed=T)
    got = fb.fused_encoder_block(torch.from_numpy(x), p, CFG.n_heads, ad if with_adapters else None,
                                 approx=approx).numpy()
    want = gw_fused_block(jnp.asarray(x), gw_p, CFG.n_heads, gw_ad if with_adapters else None,
                          approx=approx, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("with_adapters", [False, True])
def test_block_chain_matches_whisper_block_and_reference(setup, with_adapters):
    gw_p, gw_ad, p, ad = setup
    x = _x(130, seed=7)
    a_gw, a_pt = (gw_ad, ad) if with_adapters else (None, None)
    got = fb.fused_encoder_block(torch.from_numpy(x), p, CFG.n_heads, a_pt).numpy()
    np.testing.assert_allclose(got, np.asarray(gw_block(jnp.asarray(x), gw_p, CFG, a_gw)), **TOL)
    np.testing.assert_allclose(got, np.asarray(gw_reference_block(jnp.asarray(x), gw_p, a_gw,
                                                                  CFG.n_heads, False)), **TOL)
    plain = fb._reference_block(torch.from_numpy(x), p, a_pt, CFG.n_heads, False).numpy()
    np.testing.assert_allclose(plain, got, **TOL)


def test_attention_only_chain_pairs_with_mlp(setup):
    """skip_mlp (the counterpart of _attn_only_kernel) followed by the MLP
    kernel is the whole layer, as gwkit's split path for big geometries."""
    gw_p, gw_ad, p, ad = setup
    x = _x(300, seed=3)
    x1 = fb.fused_encoder_block(torch.from_numpy(x), p, CFG.n_heads, ad, skip_mlp=True)
    got = fused_mlp_block(x1, p["mlp_ln"]["g"], p["mlp_ln"]["b"], p["fc1"]["w"], p["fc1"]["b"],
                          p["fc2"]["w"], p["fc2"]["b"]).numpy()
    want = gw_fused_block(jnp.asarray(x), gw_p, CFG.n_heads, gw_ad, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 60.0, 1e3])
def test_block_chain_adversarial_score_scales(setup, scale):
    """The exact row max keeps the softmax finite and equal at any logit scale."""
    gw_p, _, p, _ = setup
    x = _x(50, seed=11)
    gw_q = dict(gw_p)
    gw_q["q"] = dict(gw_p["q"], w=gw_p["q"]["w"] * scale, b=gw_p["q"]["b"] * scale)
    pq = dict(p)
    pq["q"] = {"w": p["q"]["w"] * scale, "b": p["q"]["b"] * scale}
    got = fb.fused_encoder_block(torch.from_numpy(x), pq, CFG.n_heads).numpy()
    want = gw_fused_block(jnp.asarray(x), gw_q, CFG.n_heads, None, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-6 * max(scale, 1.0))


def _requiring_grad(tree):
    return {k: _requiring_grad(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        tree.clone().requires_grad_()


def _grads(tree):
    return {k: _grads(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.grad.numpy()


@pytest.mark.parametrize("with_adapters", [False, True])
def test_fused_block_gradients_match_gwkit(setup, with_adapters):
    """FusedBlock's backward (the recompute through flash attention, whose
    backward is K5's plain version on the CPU) against jax.grad through
    gwkit's fused_encoder_block (interpret mode): x, every layer parameter
    and every adapter leaf (a, b, m, scaling); rtol 1e-4, atol 1e-5 as
    tests/test_fused_block.py."""
    gw_p, gw_ad, p, ad = setup
    gw_ad = gw_ad if with_adapters else None
    x = np.random.default_rng(3).normal(size=(3, 50, 64)).astype(np.float32)
    gx, gp, ga = jax.grad(
        lambda xx, pp, aa: jnp.sum(gw_fused_block(xx, pp, CFG.n_heads, aa, interpret=True) ** 2),
        argnums=(0, 1, 2))(jnp.asarray(x), gw_p, gw_ad)
    tx = torch.from_numpy(x).requires_grad_()
    tp = _requiring_grad(p)
    ta = _requiring_grad(ad) if with_adapters else None
    (fb.fused_encoder_block(tx, tp, CFG.n_heads, ta) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    pairs = [(_grads(tp), gp)] + ([(_grads(ta), ga)] if with_adapters else [])
    for got, want in pairs:
        want = jax.tree.map(np.asarray, want)
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
    if with_adapters:
        assert all(np.abs(_grads(ta)[k]["scaling"]) > 0 for k in "qkvo")  # scaling is trained


@pytest.mark.parametrize("dora", [False, True])
def test_dora_linear_gradients_match_gwkit(dora):
    """dora_linear's gradients in x, W0, bias, a, b, m and scaling; the
    column norm is a constant under differentiation in both packages."""
    from gwkit.ops.dora import dora_linear as gw_dora
    from gwkit_torch.ops.dora import dora_linear

    rng = np.random.default_rng(4)
    arrs = dict(x=rng.normal(size=(5, 16)), w0=rng.normal(size=(16, 12)) / 4, bias=rng.normal(size=12),
                a=rng.normal(size=(16, 3)) / 4, b=rng.normal(size=(3, 12)) / 10, m=1 + rng.random(12),
                scaling=np.array(2.5))
    arrs = {k: np.asarray(v, np.float32) for k, v in arrs.items()}
    if not dora:
        del arrs["m"]
    w = rng.normal(size=(5, 12)).astype(np.float32)

    def gw_loss(t):
        ad = {k: t[k] for k in ("a", "b", "m", "scaling") if k in t}
        return jnp.sum(gw_dora(t["x"], t["w0"], t["bias"], ad) * w)

    want = jax.grad(gw_loss)({k: jnp.asarray(v) for k, v in arrs.items()})
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in arrs.items()}
    ad = {k: t[k] for k in ("a", "b", "m", "scaling") if k in t}
    (dora_linear(t["x"], t["w0"], t["bias"], ad) * torch.from_numpy(w)).sum().backward()
    for k in arrs:
        np.testing.assert_allclose(t[k].grad.numpy(), np.asarray(want[k]), rtol=1e-4, atol=1e-5)


def test_fused_block_backward_recomputes_through_flash_attention(setup):
    """The backward runs the attention core's own backward (kernel D's plain
    version here) and never the plain layer's full-probability attention."""
    from gwkit_torch.ops import _cuda

    _, _, p, ad = setup
    x = torch.from_numpy(_x(40, seed=2)).requires_grad_()
    out = fb.fused_encoder_block(x, p, CFG.n_heads, ad)
    _cuda.reset_counts()
    out.sum().backward()
    assert _cuda.PLAIN_CALLS.get("attention_bwd") == 1 and "block" not in _cuda.PLAIN_CALLS


def test_fold_layer_folds_dora_and_q_scale(setup):
    """fold_layer's dense (D, 3D) weight reproduces the three DoRA projections,
    with 1/sqrt(hd) in the q columns."""
    _, _, p, ad = setup
    layer = fb.fold_layer(p, ad, CFG.n_heads, torch.float32)
    h = torch.from_numpy(_x(10, seed=5)).reshape(-1, 64)
    from gwkit_torch.ops.dora import dora_linear

    want = torch.cat([dora_linear(h, p["q"]["w"], p["q"]["b"], ad["q"]) * (32 ** -0.5),
                      dora_linear(h, p["k"]["w"], None, ad["k"]),
                      dora_linear(h, p["v"]["w"], p["v"]["b"], ad["v"])], dim=1)
    np.testing.assert_allclose((h @ layer.wqkv + layer.bqkv).numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("D", [64, 512])
@pytest.mark.parametrize("ln,residual", [(True, False), (False, True), (False, False), (True, True)],
                         ids=["ln-qkv", "o-proj-residual", "plain", "ln-residual"])
def test_ln_gemm_matches_gwkit_stages(D, ln, residual):
    """Kernel B's function (its plain version on the CPU) against gwkit's
    in-kernel stage math (`_ln_f32`, `_dot`, bias in f32, the residual
    added after the cast; fused_block.py:151-161, :236-246) on 3 x 200 =
    600 rows, not a multiple of the card's 128-row panel: LN1 + QKV (N = 3D),
    the o-projection with its residual and no LN, and the other two
    combinations the kernel takes; f32, the file's tolerance, its atol
    grown with sqrt(D / 64): the two packages sum the D products in
    different orders (at D = 512 a residual-cancelled value differed by
    2.4e-6)."""
    from gwkit.ops.fused_block import _dot, _ln_f32

    rng = np.random.default_rng(D + 2 * ln + residual)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    M, N = 3 * 200, 3 * D if ln else D
    x, w, bias, res = f(M, D), f(D, N, sc=D ** -0.5), f(N, sc=0.1), f(M, N)
    g, b = 1 + f(D, sc=0.1), f(D, sc=0.1)
    got = fb.ln_gemm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(bias),
                     ln=(torch.from_numpy(g), torch.from_numpy(b)) if ln else None,
                     residual=torch.from_numpy(res) if residual else None).numpy()
    h = _ln_f32(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b)) if ln else jnp.asarray(x)
    want = (_dot(h, jnp.asarray(w)) + jnp.asarray(bias)).astype(jnp.float32)
    if residual:
        want = jnp.asarray(res) + want
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL["rtol"], atol=TOL["atol"] * (D / 64) ** 0.5)


@pytest.mark.parametrize("approx", [False, True])
def test_block_chain_ragged_rows_match_gwkit_fused_kernel(setup, approx):
    """The chain B -> A -> B -> C on 3 sequences x T = 200 (600 rows: a
    ragged last row panel for kernels B and C, a ragged key tile for A),
    with DoRA, against gwkit's whole-layer kernel in interpret mode."""
    gw_p, gw_ad, p, ad = setup
    x = np.random.default_rng(13).normal(size=(3, 200, 64)).astype(np.float32)
    got = fb.fused_encoder_block(torch.from_numpy(x), p, CFG.n_heads, ad, approx=approx).numpy()
    want = gw_fused_block(jnp.asarray(x), gw_p, CFG.n_heads, gw_ad, approx=approx, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_attention_only_chain_ragged_rows_pairs_with_mlp(setup):
    """skip_mlp (K4's counterpart, B -> A -> B) then the MLP on 3 x 200
    rows is gwkit's whole layer, as test_attention_only_chain_pairs_with_mlp
    at a row count no panel size divides."""
    gw_p, gw_ad, p, ad = setup
    x = np.random.default_rng(17).normal(size=(3, 200, 64)).astype(np.float32)
    x1 = fb.fused_encoder_block(torch.from_numpy(x), p, CFG.n_heads, ad, skip_mlp=True)
    got = fused_mlp_block(x1, p["mlp_ln"]["g"], p["mlp_ln"]["b"], p["fc1"]["w"], p["fc1"]["b"],
                          p["fc2"]["w"], p["fc2"]["b"]).numpy()
    want = gw_fused_block(jnp.asarray(x), gw_p, CFG.n_heads, gw_ad, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
