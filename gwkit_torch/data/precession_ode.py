"""Two-spin orbit-averaged precession angles by direct ODE integration
(counterpart of ``gwkit/data/precession_ode.py``).

Integrates the orbit-averaged spin-precession equations (Kidder 1995, eq.
2.4; Apostolatos et al. 1994, eq. 2),

  dS1/dt = Omega1 x S1,
  Omega1 = (1/r^3) [ (2 + 3 m2 / (2 m1)) L_N + 1/2 S2 - 3/2 (Lhat . S2) Lhat ],
  dLhat/dt = -(dS1/dt + dS2/dt)_perp / |L_N|,

with Newtonian L_N = (eta/v) Lhat (G = c = M = 1), r = v^-2, and quadrupole
radiation reaction dv/dt = (32/5) eta v^9, by fixed-step RK4 on a grid
uniform in u = v^-3 (each step then subtends a roughly constant precession
angle). Angles are reported in the frame where the total J(f_ref) is the
z-axis, with alpha(f_ref) = alpha0 and eps(f_ref) = alpha(f_ref), the
conventions of :func:`gwkit_torch.data.imrphenomp.precession_angles`.

Batching: the state is (B, 3) per vector and each per-waveform scalar
(B, 1). gwkit's ``lax.scan`` is a Python loop of ``n_steps`` RK4 steps
here, each a few hundred small kernels on the card, so the integration is
bound by launches there. gwkit's per-waveform ``jnp.interp`` closure is a
batched interpolation (:func:`interp`) over the (B, n_steps + 1) grids.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch

from gwkit_torch.data.waveforms import MTSUN_SI

Angles = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` on sorted grids, batched.

    ``xp`` and ``fp`` are (..., K); ``x`` is (..., N) with the same leading
    dims, or (N,) shared by every row. As in jnp: queries beyond the ends
    take ``fp``'s first or last value, a query equal to a grid point takes
    that point's value (the right-hand interval is chosen), and an interval
    no wider than float spacing returns its left value. In float32 the
    result equals jnp's on the CPU bit for bit."""
    lead = xp.shape[:-1]
    x = x.expand(lead + x.shape[-1:]).contiguous()
    k = xp.shape[-1]
    i = torch.clamp(torch.searchsorted(xp.contiguous(), x, right=True), 1, k - 1)
    x0, x1 = xp.gather(-1, i - 1), xp.gather(-1, i)
    f0, f1 = fp.gather(-1, i - 1), fp.gather(-1, i)
    dx = x1 - x0
    dx0 = torch.abs(dx) <= torch.finfo(xp.dtype).eps ** 2  # np.spacing(eps), as jnp
    q, df = (x - x0) / torch.where(dx0, torch.ones_like(dx), dx), f1 - f0
    if f0.dtype == torch.float32:  # f0 + q * df rounded once, as XLA's fused multiply-add rounds it
        lin = (f0.double() + q.double() * df.double()).float()
    else:
        lin = f0 + q * df
    f = torch.where(dx0, f0, lin)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _dot(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def _norm(a):
    return torch.linalg.vector_norm(a, dim=-1, keepdim=True)


def _matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3) written out: a float32 matmul on the card
    may run in TF32."""
    return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(dim=-2)


def _rotation_to_z(vec):
    """(..., 3, 3) rotations taking the unit vectors along ``vec`` (..., 3)
    to +z (Rodrigues): +z gives the identity, -z is regularized through the
    clamp on (1 + cos)."""
    v = vec / _norm(vec)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    axis = torch.linalg.cross(v, z, dim=-1)
    s2 = _dot(axis, axis)                         # sin^2(angle)
    c = _dot(v, z)
    k = torch.where(s2 > 1e-14, 1.0 / torch.clamp(1.0 + c, min=1e-7), torch.zeros_like(c))
    zero = torch.zeros_like(axis[..., 0])
    ax = torch.stack([
        torch.stack([zero, -axis[..., 2], axis[..., 1]], dim=-1),
        torch.stack([axis[..., 2], zero, -axis[..., 0]], dim=-1),
        torch.stack([-axis[..., 1], axis[..., 0], zero], dim=-1),
    ], dim=-2)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + ax + k[..., None] * _matmul3(ax, ax)


def _derivs(lhat, s1, s2, v, m1f, m2f, eta):
    """(dLhat/dv, dS1/dv, dS2/dv) in total-mass units at PN speed ``v``;
    vectors (..., 3), scalars (..., 1)."""
    ldot_s2 = _dot(lhat, s2)
    ldot_s1 = _dot(lhat, s1)
    om1 = v ** 6 * ((2.0 + 1.5 * m2f / m1f) * (eta / v) * lhat
                    + 0.5 * s2 - 1.5 * ldot_s2 * lhat)
    om2 = v ** 6 * ((2.0 + 1.5 * m1f / m2f) * (eta / v) * lhat
                    + 0.5 * s1 - 1.5 * ldot_s1 * lhat)
    dvdt = (32.0 / 5.0) * eta * v ** 9
    ds1 = torch.linalg.cross(om1, s1, dim=-1) / dvdt
    ds2 = torch.linalg.cross(om2, s2, dim=-1) / dvdt
    dsum = ds1 + ds2
    # Ldot = -(S1dot + S2dot); precession preserves |L|, so only the
    # transverse part moves the direction
    dl = -(dsum - _dot(dsum, lhat) * lhat) / (eta / v)
    return dl, ds1, ds2


def integrate_precession(m1, m2, s1_vec, s2_vec, f_ref: float, f_max: float, n_steps: int = 384):
    """Integrate Lhat/S1/S2 from f_ref to f_max on a grid uniform in v^-3.

    ``m1``, ``m2``: (B,); ``s1_vec``/``s2_vec``: (B, 3) dimensionless spin
    vectors in the frame where Lhat(f_ref) = z. Returns ``(v_grid, lhat, s1,
    s2)``, (B, n_steps + 1) and (B, n_steps + 1, 3), in that frame; |S_i|
    is re-imposed after every step."""
    m1 = torch.as_tensor(m1, dtype=torch.float32)[..., None]
    m2 = torch.as_tensor(m2, dtype=torch.float32, device=m1.device)[..., None]
    mtot = m1 + m2
    m1f = m1 / mtot
    m2f = m2 / mtot
    eta = m1f * m2f
    mt_s = mtot * MTSUN_SI
    v_lo = (math.pi * mt_s * f_ref) ** (1.0 / 3.0)
    # integrate at most to v = 1 (the twist holds angles fixed beyond)
    v_hi = torch.clamp((math.pi * mt_s * f_max) ** (1.0 / 3.0), max=1.0)
    v_hi = torch.maximum(v_hi, v_lo * (1.0 + 1e-6))
    u_lo = v_lo ** -3.0
    u_hi = v_hi ** -3.0
    du = (u_hi - u_lo) / n_steps  # negative: u decreases as v grows

    s1_0 = torch.as_tensor(s1_vec, dtype=torch.float32, device=m1.device) * m1f ** 2
    s2_0 = torch.as_tensor(s2_vec, dtype=torch.float32, device=m1.device) * m2f ** 2
    l_0 = torch.zeros_like(s1_0)
    l_0[..., 2] = 1.0
    n1_0, n2_0 = _norm(s1_0), _norm(s2_0)

    def derivs_u(lhat, s1, s2, u):
        v = torch.clamp(u, min=1.0) ** (-1.0 / 3.0)
        dl, ds1, ds2 = _derivs(lhat, s1, s2, v, m1f, m2f, eta)
        dvdu = -(v ** 4) / 3.0
        return dl * dvdu, ds1 * dvdu, ds2 * dvdu

    def fix_norm(s, n0):
        # precession torques conserve the spin magnitudes exactly; re-impose them
        return torch.where(n0 > 0.0, s * (n0 / torch.clamp(_norm(s), min=1e-30)), s)

    lhat, s1, s2 = l_0, s1_0, s2_0
    traj = [(lhat, s1, s2)]
    for i in range(n_steps):
        u = u_lo + i * du
        k1 = derivs_u(lhat, s1, s2, u)
        k2 = derivs_u(lhat + 0.5 * du * k1[0], s1 + 0.5 * du * k1[1], s2 + 0.5 * du * k1[2], u + 0.5 * du)
        k3 = derivs_u(lhat + 0.5 * du * k2[0], s1 + 0.5 * du * k2[1], s2 + 0.5 * du * k2[2], u + 0.5 * du)
        k4 = derivs_u(lhat + du * k3[0], s1 + du * k3[1], s2 + du * k3[2], u + du)
        step = [(a + 2.0 * b + 2.0 * c + d) * (du / 6.0) for a, b, c, d in zip(k1, k2, k3, k4)]
        lhat = lhat + step[0]
        lhat = lhat / _norm(lhat)
        s1 = fix_norm(s1 + step[1], n1_0)
        s2 = fix_norm(s2 + step[2], n2_0)
        traj.append((lhat, s1, s2))
    lhat, s1, s2 = (torch.stack(t, dim=-2) for t in zip(*traj))
    u_grid = u_lo + du * torch.arange(n_steps + 1, dtype=torch.float32, device=m1.device)
    v_grid = torch.clamp(u_grid, min=1.0) ** (-1.0 / 3.0)
    return v_grid, lhat, s1, s2


def precession_angles_numerical(m1, m2, s1_vec, s2_vec, alpha0=0.0, f_ref: float = 20.0,
                                f_max: float = 1024.0, n_steps: int = 384) -> Callable[[torch.Tensor], Angles]:
    """Build an ``angle_fn(freqs) -> (alpha, cos_beta, eps)`` for a batch.

    The ODE is integrated once per batch (``m1``, ``m2`` (B,), spins (B, 3),
    ``alpha0`` a scalar or (B, 1)); the returned function interpolates the
    angles onto any grid that broadcasts against (B, 1), giving (B, F)."""
    v_grid, lhat, s1, s2 = integrate_precession(m1, m2, s1_vec, s2_vec, f_ref, f_max, n_steps)
    m1 = torch.as_tensor(m1, dtype=torch.float32, device=v_grid.device)[..., None]
    m2 = torch.as_tensor(m2, dtype=torch.float32, device=v_grid.device)[..., None]
    mtot = m1 + m2
    eta = (m1 * m2) / mtot ** 2
    # rotate everything into the J(f_ref)-aligned frame
    j0 = (eta / v_grid[..., :1]) * lhat[..., 0, :] + s1[..., 0, :] + s2[..., 0, :]
    rot = _rotation_to_z(j0)
    lhat_j = (lhat.unsqueeze(-2) * rot.unsqueeze(-3)).sum(dim=-1)  # lhat @ rot.T

    lx, ly, lz = lhat_j[..., 0], lhat_j[..., 1], lhat_j[..., 2]
    cos_b = torch.clamp(lz, -1.0, 1.0)
    # signed angle between consecutive planar projections of Lhat;
    # atan2(0, 0) = 0, so the aligned limit freezes alpha exactly
    cross = lx[..., :-1] * ly[..., 1:] - ly[..., :-1] * lx[..., 1:]
    dot = lx[..., :-1] * lx[..., 1:] + ly[..., :-1] * ly[..., 1:]
    d_alpha = torch.atan2(cross, dot)
    zero = torch.zeros_like(d_alpha[..., :1])
    alpha = alpha0 + torch.cat([zero, torch.cumsum(d_alpha, dim=-1)], dim=-1)
    # minimal-rotation condition d(eps) = cos(beta) d(alpha), midpoint rule
    d_eps = 0.5 * (cos_b[..., :-1] + cos_b[..., 1:]) * d_alpha
    eps = torch.cat([zero, torch.cumsum(d_eps, dim=-1)], dim=-1)
    eps = eps + (alpha[..., :1] - eps[..., :1])

    mt_s = mtot * MTSUN_SI

    def angle_fn(freqs: torch.Tensor) -> Angles:
        v = (math.pi * mt_s * torch.clamp(freqs, min=1e-6)) ** (1.0 / 3.0)
        v = torch.minimum(torch.maximum(v, v_grid[..., :1]), v_grid[..., -1:])
        return interp(v, v_grid, alpha), interp(v, v_grid, cos_b), interp(v, v_grid, eps)

    return angle_fn
