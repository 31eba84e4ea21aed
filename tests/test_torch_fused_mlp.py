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
