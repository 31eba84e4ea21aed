"""Port parity: gwkit_torch.ops.fused_mlp (plain path on the CPU) against
gwkit's fused_mlp_block in interpret mode and its _unfused math, tanh and
erf GELU. f32; rtol 2e-5, atol 2e-6."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gwkit.ops.fused_mlp import _unfused as gw_unfused
from gwkit.ops.fused_mlp import fused_mlp_block as gw_fused_mlp
from gwkit_torch.ops.fused_mlp import fused_mlp_block

TOL = dict(rtol=2e-5, atol=2e-6)


def _operands(T, D=64, F=256, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return (f(2, T, D), 1 + f(D, sc=0.1), f(D, sc=0.1), f(D, F, sc=D ** -0.5), f(F, sc=0.1),
            f(F, D, sc=F ** -0.5), f(D, sc=0.1))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("T", [50, 300])
def test_fused_mlp_matches_gwkit(T, approx):
    ops = _operands(T, seed=T)
    got = fused_mlp_block(*(torch.from_numpy(a) for a in ops), approx=approx).numpy()
    jops = [jnp.asarray(a) for a in ops]
    np.testing.assert_allclose(got, np.asarray(gw_fused_mlp(*jops, interpret=True, approx=approx)), **TOL)
    np.testing.assert_allclose(got, np.asarray(gw_unfused(*jops, approx=approx)), **TOL)


def _batched_operands(B, T, D, F, seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)
    return (f(B, T, D), 1 + f(D, sc=0.1), f(D, sc=0.1), f(D, F, sc=D ** -0.5), f(F, sc=0.1),
            f(F, D, sc=F ** -0.5), f(D, sc=0.1))


@pytest.mark.parametrize("approx", [False, True])
@pytest.mark.parametrize("B,T,D,F", [(3, 200, 64, 256), (1, 24, 512, 2048)],
                         ids=["ragged-rows-3x200", "base-width-D512-F2048"])
def test_fused_mlp_ragged_rows_and_base_width_match_gwkit(B, T, D, F, approx):
    """Shapes kernel C's tiling treats apart on the card: 600 rows (not a
    multiple of its 64-row panel or of a two-block cluster's 128), and
    whisper-base's D = 512, F = 2048 (m64n256 fc2 halves). Against gwkit's
    _fused_mlp_impl (the _mlp_kernel Pallas kernel, interpret mode) and its
    _unfused math; f32, the file's tolerance."""
    from gwkit.ops.fused_mlp import _fused_mlp_impl

    ops = _batched_operands(B, T, D, F, seed=B * T + D)
    got = fused_mlp_block(*(torch.from_numpy(a) for a in ops), approx=approx).numpy()
    jops = [jnp.asarray(a) for a in ops]
    np.testing.assert_allclose(got, np.asarray(_fused_mlp_impl(*jops, interpret=True, approx=approx)), **TOL)
    np.testing.assert_allclose(got, np.asarray(gw_unfused(*jops, approx=approx)), **TOL)
