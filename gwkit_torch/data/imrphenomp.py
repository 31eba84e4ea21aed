"""Precessing-binary FD waveforms: the IMRPhenomP-style "twist" of the
aligned-spin IMRPhenomD co-precessing waveform (counterpart of
``gwkit/data/imrphenomp.py``; Hannam et al. 2014).

The aligned model plays the co-precessing (2,2) mode, and frequency-
dependent Euler angles (alpha, beta, epsilon) mix it into the inertial l=2
multipoles through Wigner d-matrices and spin-weighted harmonics. The
angles are the leading-order single-spin (Apostolatos et al. 1994) closed
form, with the in-plane spin summarized as chi_p (Schmidt, Ohme & Hannam
2015) on the larger body; ``angle_fn`` swaps in another model (the two-spin
ODE of :mod:`gwkit_torch.data.precession_ode`). chi_p = 0 reproduces
:func:`gwkit_torch.data.waveforms.phenomd_hplus_hcross`.

Parameters are (B, 1) against an (F,) grid (or scalars for one waveform);
the polarizations accumulate in complex64, as gwkit's.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gwkit_torch.data.imrphenomd import rdiv
from gwkit_torch.data.waveforms import MTSUN_SI, phenomd_h22


def _jnp_f32(x):
    """A host numpy value as the float32 tensor jnp turns it into when it
    meets a jnp operation (x64 off); tensors pass through."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x, np.float32))


def _sqrt_rounded(x: torch.Tensor) -> torch.Tensor:
    """sqrt rounded once to x's dtype (jnp's is; torch's float32 sqrt on the
    CPU is one ulp off for some inputs). A float32 square root taken in
    float64 and rounded is the correctly rounded one."""
    return torch.sqrt(x.double()).to(x.dtype)


def chi_p(m1, m2, s1x, s1y, s2x, s2y):
    """Effective precession spin (Schmidt et al. 2015, eq. 3.3-3.4); m1 >= m2.

    Given host numpy arrays, what gwkit leaves to numpy stays float64 and
    what its jnp operations compute is float32, as in gwkit; tensors keep
    their dtype throughout."""
    q = m2 / m1
    a1 = 2.0 + 1.5 * q
    a2 = 2.0 + (rdiv(1.5, q) if torch.is_tensor(q) else 1.5 / q)
    s1_perp = _jnp_f32(m1 ** 2) * _sqrt_rounded(_jnp_f32(s1x ** 2 + s1y ** 2))
    s2_perp = _jnp_f32(m2 ** 2) * _sqrt_rounded(_jnp_f32(s2x ** 2 + s2y ** 2))
    return torch.maximum(_jnp_f32(a1) * s1_perp, _jnp_f32(a2) * s2_perp) / _jnp_f32(a1 * m1 ** 2)


def precession_angles(freqs: torch.Tensor, m1, m2, chi_eff_z, chip, alpha0=0.0,
                      f_ref: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(alpha, cos_beta, epsilon) on the frequency grid (leading order).

    ``chi_eff_z`` = S_z / M^2 with S_z = chi1z m1^2 + chi2z m2^2; ``chip``
    rides the larger body: S_perp = chip m1^2."""
    mtot = m1 + m2
    q = m2 / m1
    eta = (m1 * m2) / (mtot ** 2)
    mtot_s = mtot * MTSUN_SI
    # the grid clamped at f_ref/2: bins below f_lower are amplitude-masked,
    # and v^-3 at the DC bins would poison the f32 epsilon cumsum
    f_safe = torch.clamp(freqs, min=0.5 * f_ref)
    v = (math.pi * mtot_s * f_safe) ** (1.0 / 3.0)
    v_ref = (math.pi * mtot_s * f_ref) ** (1.0 / 3.0)

    coef = (5.0 / 96.0) * (2.0 + 1.5 * q)
    alpha = alpha0 - coef * (v ** -3 - v_ref ** -3)

    ell = eta / v                       # |L| / M^2
    s_z = chi_eff_z                     # S_z / M^2
    s_perp = chip * (m1 / mtot) ** 2    # S_perp / M^2
    cos_beta = (ell + s_z) / torch.sqrt((ell + s_z) ** 2 + s_perp ** 2)

    # minimal-rotation condition, integrated on the grid
    dalpha = torch.diff(alpha, dim=-1, prepend=alpha[..., :1])
    eps = torch.cumsum(cos_beta * dalpha, dim=-1)
    # gauge: eps aligned with alpha at the start, so beta -> 0 is phase-free
    eps = eps + (alpha[..., :1] - eps[..., :1])
    return alpha, cos_beta, eps


def _wigner_d2_row(cos_b, sin_b):
    """[d^2_{m,2}(beta) for m = -2..2]; sum of squares is exactly 1."""
    return [
        ((1.0 - cos_b) / 2.0) ** 2,                 # m = -2
        (1.0 - cos_b) / 2.0 * sin_b,                # m = -1
        math.sqrt(3.0 / 8.0) * sin_b ** 2,          # m = 0
        (1.0 + cos_b) / 2.0 * sin_b,                # m = +1
        ((1.0 + cos_b) / 2.0) ** 2,                 # m = +2
    ]


def _sYlm_m2_row(theta):
    """[-2Y_{2,m}(theta, 0) for m = -2..2] (Goldberg convention, phi=0)."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    return [
        math.sqrt(5.0 / (64.0 * math.pi)) * (1.0 - c) ** 2,   # m = -2
        math.sqrt(5.0 / (16.0 * math.pi)) * s * (1.0 - c),    # m = -1
        math.sqrt(15.0 / (32.0 * math.pi)) * s ** 2,          # m = 0
        math.sqrt(5.0 / (16.0 * math.pi)) * s * (1.0 + c),    # m = +1
        math.sqrt(5.0 / (64.0 * math.pi)) * (1.0 + c) ** 2,   # m = +2
    ]


def phenomp_hplus_hcross(freqs: torch.Tensor, m1, m2, chi1z, chi2z, chip, distance_mpc, inclination,
                         tc=0.0, phic=0.0, alpha0=0.0, f_lower: float = 20.0,
                         angle_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precessing FD polarizations on the grid (PhenomP twist).

    ``inclination`` is theta_JN; ``alpha0`` the initial precession phase.
    ``angle_fn`` (optional): ``freqs -> (alpha, cos_beta, eps)`` replacing the
    leading-order closed form."""
    h = phenomd_h22(freqs, m1, m2, chi1z, chi2z, distance_mpc, tc, phic, f_lower)
    mtot = m1 + m2
    s_z = (chi1z * m1 ** 2 + chi2z * m2 ** 2) / mtot ** 2
    if angle_fn is not None:
        alpha, cos_b, eps = angle_fn(freqs)
    else:
        alpha, cos_b, eps = precession_angles(freqs, m1, m2, s_z, chip, alpha0, f_ref=f_lower)
    sin_b = torch.sqrt(torch.clamp(1.0 - cos_b ** 2, min=0.0))

    d2 = _wigner_d2_row(cos_b, sin_b)                  # d^2_{m,2}
    theta = torch.as_tensor(inclination, dtype=alpha.dtype, device=alpha.device)
    ys = _sYlm_m2_row(theta)                           # -2Y_{2,m}(thetaJN, 0), real
    hp_sum = torch.zeros(alpha.shape, dtype=torch.complex64, device=alpha.device)
    hc_sum = torch.zeros(alpha.shape, dtype=torch.complex64, device=alpha.device)
    for i, m in enumerate((-2, -1, 0, 1, 2)):
        phase_m = torch.exp(-1j * m * alpha)
        t_2m = ys[i] * phase_m * d2[i]
        # d^2_{m,-2}(beta) = (-1)^m d^2_{-m,2}(beta); the Y row is real at phi=0
        dm2 = ((-1.0) ** m) * d2[4 - i]
        t_m2m = ys[i] * torch.conj(phase_m) * dm2
        hp_sum = hp_sum + (t_2m + t_m2m)
        hc_sum = hc_sum + 1j * (t_2m - t_m2m)

    # hP normalization from the aligned limit: hp_aligned = h (1+c^2)/2 =
    # 0.5 hP (Y22 + Y2-2)  =>  hP = h / (2 sqrt(5/(64 pi)))
    h_p22 = h / (2.0 * np.sqrt(5.0 / (64.0 * np.pi)))
    tw = 0.5 * h_p22 * torch.exp(2j * eps)
    return tw * hp_sum, tw * hc_sum
