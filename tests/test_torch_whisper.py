"""Port parity: gwkit_torch.models.whisper.encoder_apply end to end (conv
stem, positions, layers with DoRA, final LN), unfused and on the kernel
chain's plain versions, against gwkit's encoder_apply on a tiny config.
f32; rtol 2e-5, atol 2e-6 (stem + 2 layers of f32 summation-order noise)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gwkit.models.adapters import AdapterConfig, init_adapters
from gwkit.models.whisper import WhisperConfig as GwConfig
from gwkit.models.whisper import encoder_apply as gw_encoder_apply
from gwkit.models.whisper import init_encoder_params
from gwkit.models.whisper import sinusoid_positions as gw_positions
from gwkit_torch.io import from_gwkit_numpy
from gwkit_torch.models.whisper import (WhisperConfig, encoder_apply, init_encoder_params as
                                        port_init, param_shapes, sinusoid_positions)

GW_CFG = GwConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=64)
CFG = WhisperConfig(d_model=64, n_heads=2, n_layers=2, d_ff=128, max_positions=64)


@pytest.fixture(scope="module")
def weights():
    params = init_encoder_params(jax.random.PRNGKey(0), GW_CFG)
    adapters = init_adapters(jax.random.PRNGKey(1), GW_CFG,
                             AdapterConfig(r=4, alpha=8, use_dora=True, targets="qkvo"), params)
    adapters = jax.tree.map(
        lambda a: a + 0.01 * np.arange(a.size, dtype=np.float32).reshape(a.shape) % 0.07, adapters)
    port = from_gwkit_numpy(jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, adapters))
    return params, adapters, port


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("approx", [False, True])
def test_encoder_apply_matches_gwkit(weights, fused, approx):
    params, adapters, port = weights
    mel = np.random.default_rng(5).normal(size=(2, 80, 128)).astype(np.float32)
    want = gw_encoder_apply(dataclasses.replace(GW_CFG, gelu_approx=approx), params,
                            jnp.asarray(mel), adapters)
    cfg = dataclasses.replace(CFG, gelu_approx=approx, fused_block=fused)
    got = encoder_apply(cfg, port["encoder"], torch.from_numpy(mel), port["adapters"])
    assert got.shape == (2, 64, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


def test_positions_and_param_layout():
    np.testing.assert_array_equal(sinusoid_positions(256, 384), gw_positions(256, 384))
    gw_shapes = jax.tree.map(lambda a: tuple(a.shape), init_encoder_params(jax.random.PRNGKey(0), GW_CFG))
    port_shapes = jax.tree.map(tuple, param_shapes(CFG), is_leaf=lambda x: isinstance(x, tuple))
    assert gw_shapes == port_shapes
    # the port's own random init: gwkit's layout, per-layer list, right shapes
    p = port_init(CFG, torch.Generator().manual_seed(0))
    assert len(p["layers"]) == 2 and tuple(p["layers"][0]["fc1"]["w"].shape) == (64, 128)
    assert "b" not in p["layers"][0]["k"]


@pytest.mark.parametrize("targets", ["qv", "qkvo"])
def test_empty_adapters_match_gwkit(weights, targets):
    """``empty_adapters``: all four projections whatever the targets, B = 0
    (each the identity), m = W0's column norms, gwkit's scaling; A from
    U(+-1/sqrt(d_in)), drawn by each package's own generator."""
    from gwkit.models.adapters import empty_adapters as gw_empty
    from gwkit_torch.models.adapters import AdapterConfig as PortAdapterConfig
    from gwkit_torch.models.adapters import empty_adapters

    params, _, port = weights
    want = from_gwkit_numpy(adapters=jax.tree.map(np.asarray, gw_empty(
        GW_CFG, AdapterConfig(r=4, alpha=8, use_dora=True, targets=targets), params)))["adapters"]
    got = empty_adapters(CFG, PortAdapterConfig(r=4, alpha=8, use_dora=True, targets=targets), port["encoder"])
    assert len(got) == len(want) == CFG.n_layers
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) == ["k", "o", "q", "v"]
        for proj in w:
            assert sorted(g[proj]) == sorted(w[proj])
            assert g[proj]["a"].shape == w[proj]["a"].shape
            assert float(g[proj]["a"].abs().max()) <= 1.0 / np.sqrt(CFG.d_model)
            assert not g[proj]["b"].any() and not w[proj]["b"].any()
            np.testing.assert_allclose(g[proj]["m"].numpy(), w[proj]["m"].numpy(), rtol=1e-6)
            assert float(g[proj]["scaling"]) == float(w[proj]["scaling"]) == 2.0
