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
