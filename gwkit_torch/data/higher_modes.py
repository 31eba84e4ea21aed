"""Aligned-spin FD waveforms with higher harmonics (PhenomHM-style), and
their precessing twist (counterpart of ``gwkit/data/higher_modes.py``;
London et al. 2018, arXiv:1708.00404).

Each co-precessing mode (l, m) is PhenomD's (2,2) amplitude and phase at a
mapped frequency: (2/m) f through the inspiral, the mode's own QNM
frequency through ringdown, linear between, with the phase C1-stitched
across the regions. Mode amplitudes follow the PN hierarchy
|H_lm/H_22|(v); polarizations assemble with spin-weight -2 harmonics and
h_{l,-m} = (-1)^l conj(h_lm). ``xphm_hplus_hcross`` rotates every mode
through the precession Euler angles (the XPHM capability).

Parameters are (B, 1) against an (F,) grid (or scalars for one waveform);
the polarizations accumulate in complex64, as gwkit's.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from gwkit_torch.data import imrphenomd
from gwkit_torch.data.imrphenomd import rdiv
from gwkit_torch.data.waveforms import C_SI, MPC_SI, MTSUN_SI

#: Modes carried by default: the (2,2) plus the four loudest subdominants
#: of IMRPhenomHM (London et al. 2018 table I).
DEFAULT_MODES: Tuple[Tuple[int, int], ...] = ((2, 2), (2, 1), (3, 3), (3, 2), (4, 4))


def sylm(l: int, m: int, theta) -> torch.Tensor:
    """Spin-weight -2 spherical harmonic ^{-2}Y_{lm}(theta, phi=0), real:
    sqrt((2l+1)/(4 pi)) d^l_{m,2}(theta) (Goldberg et al. 1967, the
    lalsuite convention)."""
    half = theta / 2.0
    d = wigner_d(l, m, 2, torch.cos(half), torch.sin(half))
    return math.sqrt((2 * l + 1) / (4.0 * math.pi)) * d


def pn_mode_ratio(l: int, m: int, v, eta, delta, pn_amplitude: bool = True):
    """|H_lm / H_22| of the non-spinning PN mode amplitudes, at the mode's
    orbital velocity v; the odd-m ratios carry the relative-PN modulus
    corrections through O(v^3) when ``pn_amplitude`` (gwkit's docstring
    gives the series and why (3,2)/(4,4) stay at leading order)."""
    if (l, m) == (2, 2):
        return torch.ones_like(v)
    corr = 1.0
    if pn_amplitude and m % 2 == 1:
        h22 = 1.0 + v ** 2 * (-107.0 / 42.0 + 55.0 * eta / 42.0) \
            + 2.0 * math.pi * v ** 3
        if (l, m) == (2, 1):
            hlm = 1.0 + v ** 2 * (-17.0 / 28.0 + 5.0 * eta / 7.0) \
                + math.pi * v ** 3
        else:  # (3, 3)
            hlm = 1.0 + v ** 2 * (-4.0 + 2.0 * eta) + 3.0 * math.pi * v ** 3
        corr = torch.abs(hlm) / torch.clamp(torch.abs(h22), min=0.3)
    if (l, m) == (2, 1):
        return (1.0 / 3.0) * delta * v * corr
    if (l, m) == (3, 3):
        return 0.75 * math.sqrt(15.0 / 14.0) * delta * v * corr
    if (l, m) == (3, 2):
        return (1.0 / 3.0) * math.sqrt(5.0 / 7.0) * (1.0 - 3.0 * eta) * v ** 2
    if (l, m) == (4, 4):
        return (8.0 / 9.0) * math.sqrt(10.0 / 7.0) * (1.0 - 3.0 * eta) * v ** 2
    raise ValueError(f"mode ({l},{m}) not modeled")


#: Constant phase of the leading complex PN amplitude H_lm relative to the
#: (real, positive) leading H_22.
MODE_PHASE = {(2, 2): 0.0, (2, 1): 0.5 * math.pi, (3, 3): -0.5 * math.pi,
              (3, 2): 0.0, (4, 4): math.pi}

#: (l,m,0) Kerr QNM fits, Berti/Cardoso/Will 2006 table VIII:
#: omega_R M_f = f1 + f2 (1-a)^f3.
QNM_FITS = {
    (2, 2): (1.5251, -1.1568, 0.1292),
    (2, 1): (0.6000, -0.2339, 0.4175),
    (3, 3): (1.8956, -1.3043, 0.1818),
    (3, 2): (1.1481, -0.5552, 0.3002),
    (4, 4): (2.3000, -1.5056, 0.2244),
}


def qnm_frequency_lm(l: int, m: int, final_a, erad):
    """Mode ringdown frequency Mf_RD(l,m) in initial-total-mass units (the
    convention of :func:`gwkit_torch.data.imrphenomd.qnm_ringdown`)."""
    c1, c2, c3 = QNM_FITS[(l, m)]
    a = torch.clamp(final_a, -0.999, 0.999)
    omega = c1 + c2 * (1.0 - a) ** c3
    return omega / (2.0 * math.pi * (1.0 - erad))


def _mode_freq_map(mf, l, m, coeffs, f_rdlm):
    """PhenomHM three-region map F(mf) from the lm mode's geometric frequency
    to the equivalent (2,2) one: (2/m) mf through the inspiral, kappa mf
    through ringdown (kappa = Mf_RD22/Mf_RDlm), linear and C0 between.
    Returns (F, f1, a_int, kappa)."""
    f_ins22 = imrphenomd.PHI_F_JOIN_INS
    f1 = (m / 2.0) * f_ins22
    f_rd22 = coeffs.f_rd
    kappa = f_rd22 / f_rdlm
    a_int = (f_rd22 - f_ins22) / (f_rdlm - f1)
    b_int = f_ins22 - a_int * f1
    f_map = torch.where(
        mf <= f1, (2.0 / m) * mf,
        torch.where(mf < f_rdlm, a_int * mf + b_int, kappa * mf))
    return f_map, f1, a_int, kappa


def phenomhm_modes(freqs: torch.Tensor, m1, m2, chi1, chi2, distance_mpc, tc=0.0, phic=0.0,
                   f_lower: float = 20.0, modes: Sequence[Tuple[int, int]] = DEFAULT_MODES,
                   ringdown_map: bool = True):
    """dict {(l, m): h_lm(f)} of positive-m FD modes (SPA, h = A e^{-i psi}).

    psi_lm = 2 pi f tc - (m/2) phic - pi/4 + (m/2) phi_22(F(f)) [+ stitch]
    and A_lm = sqrt(2/m) |H_lm/H_22|(v) A_22(F(f)), v capped at the 22
    amplitude peak; support starts at (m/2) f_lower."""
    mtot_s = (m1 + m2) * MTSUN_SI
    eta = (m1 * m2) / (m1 + m2) ** 2
    delta = torch.abs(m1 - m2) / (m1 + m2)
    mc_s = ((m1 * m2) ** (3.0 / 5.0) / (m1 + m2) ** (1.0 / 5.0)) * MTSUN_SI
    d_s = distance_mpc * MPC_SI / C_SI
    coeffs = imrphenomd.phenomd_coeffs(eta, chi1, chi2)
    af = imrphenomd.final_spin(eta, chi1, chi2)
    erad = imrphenomd.radiated_energy(eta, chi1, chi2)
    v_peak = (math.pi * imrphenomd._amp_peak_freq(coeffs)) ** (1.0 / 3.0)
    mf = mtot_s * torch.clamp(freqs, min=1e-3)  # output-grid geometric frequency
    # the phase-derivative anchors of the C1 stitching, the same for every mode
    dp_f1 = imrphenomd.phenomd_dphase(imrphenomd.PHI_F_JOIN_INS * torch.ones_like(coeffs.f_rd), coeffs)
    dp_rd = imrphenomd.phenomd_dphase(coeffs.f_rd, coeffs)

    out = {}
    for (l, m) in modes:
        scale = 2.0 / m
        half_m = m / 2.0
        if ringdown_map:
            f_rdlm = qnm_frequency_lm(l, m, af, erad)
            f_map, fb1, a_int, kappa = _mode_freq_map(mf, l, m, coeffs, f_rdlm)
            # C1 stitching: per-region linear-in-f (time shift) + constant
            # (phase shift), continuous in value and derivative
            tau2 = (1.0 - half_m * a_int) * dp_f1
            c2 = -tau2 * fb1
            tau3 = half_m * a_int * dp_rd + tau2 - half_m * kappa * dp_rd
            c3 = c2 + (tau2 - tau3) * f_rdlm
            stitch = torch.where(
                mf <= fb1, 0.0,
                torch.where(mf < f_rdlm, tau2 * mf + c2, tau3 * mf + c3))
            mf_cut = rdiv(imrphenomd.F_CUT, kappa)
        else:
            f_map = scale * mf
            stitch = 0.0
            mf_cut = imrphenomd.F_CUT / scale
        ampc = imrphenomd.phenomd_amplitude(f_map, coeffs)
        phase = half_m * imrphenomd.phenomd_phase(f_map, coeffs) + stitch
        carrier = (
            math.sqrt(5.0 / 24.0)
            * math.pi ** (-2.0 / 3.0)
            * mc_s ** (5.0 / 6.0)
            / d_s
            * (f_map / mtot_s) ** (-7.0 / 6.0)
        )
        v = torch.minimum((math.pi * f_map) ** (1.0 / 3.0), v_peak)
        ratio = pn_mode_ratio(l, m, v, eta, delta)
        # carrier*ampc is the aligned-h convention of phenomd_h22; the (2,2)
        # mode amplitude is h / (2 Y0), Y0 = sqrt(5/(64 pi))
        mode_units = 1.0 / (2.0 * math.sqrt(5.0 / (64.0 * math.pi)))
        amp = mode_units * math.sqrt(scale) * ratio * carrier * ampc
        band = (freqs >= half_m * f_lower) & (mf <= mf_cut)
        psi = (2.0 * math.pi * freqs * tc - half_m * phic - math.pi / 4.0
               + phase - MODE_PHASE[(l, m)])
        out[(l, m)] = torch.where(band, amp, 0.0) * torch.exp(-1j * psi)
    return out


def _zeros_c64(like: torch.Tensor) -> torch.Tensor:
    return torch.zeros(like.shape, dtype=torch.complex64, device=like.device)


def phenomhm_hplus_hcross(freqs: torch.Tensor, m1, m2, chi1, chi2, distance_mpc, inclination, tc=0.0,
                          phic=0.0, f_lower: float = 20.0,
                          modes: Sequence[Tuple[int, int]] = DEFAULT_MODES) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aligned-spin FD polarizations with higher harmonics; modes=((2,2),)
    reproduces phenomd_hplus_hcross."""
    hlms = phenomhm_modes(freqs, m1, m2, chi1, chi2, distance_mpc, tc, phic, f_lower, modes)
    first = next(iter(hlms.values()))
    theta = torch.as_tensor(inclination, dtype=first.real.dtype, device=first.device)
    hp = hc = _zeros_c64(first)
    for (l, m), hlm in hlms.items():
        yp = sylm(l, m, theta)
        ym = sylm(l, -m, theta)  # real at phi=0, so conj(Y) = Y
        sym = (-1.0) ** l
        hp = hp + 0.5 * hlm * (yp + sym * ym)
        hc = hc + 0.5j * hlm * (yp - sym * ym)
    return hp, hc


def wigner_d(l: int, mp: int, m: int, cos_half, sin_half) -> torch.Tensor:
    """Wigner small-d d^l_{mp,m}(beta) from half-angle cos/sin (Jacobi sum;
    Python-float coefficients for the static l, mp, m)."""
    fact = math.factorial
    norm = math.sqrt(fact(l + mp) * fact(l - mp) * fact(l + m) * fact(l - m))
    out = torch.zeros_like(cos_half)
    for k in range(max(0, m - mp), min(l + m, l - mp) + 1):
        denom = fact(l + m - k) * fact(k) * fact(mp - m + k) * fact(l - mp - k)
        coef = ((-1.0) ** (mp - m + k)) * norm / denom
        out = out + (coef * cos_half ** (2 * l + m - mp - 2 * k)
                     * sin_half ** (mp - m + 2 * k))
    return out


def xphm_hplus_hcross(freqs: torch.Tensor, m1, m2, chi1z, chi2z, chip, distance_mpc, inclination, tc=0.0,
                      phic=0.0, alpha0=0.0, f_lower: float = 20.0,
                      modes: Sequence[Tuple[int, int]] = DEFAULT_MODES,
                      angle_fn=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precessing FD polarizations with higher harmonics (XPHM capability):
    each co-precessing (l, m) rotated through the Euler angles at its
    (2/m)-mapped frequency with the full Wigner row d^l_{m',+-m}. chip = 0
    reproduces phenomhm_hplus_hcross; modes=((2,2),) reproduces
    phenomp_hplus_hcross. ``angle_fn`` replaces the leading-order angles
    (``chip``/``alpha0`` then unused)."""
    from gwkit_torch.data.imrphenomp import precession_angles

    hlms = phenomhm_modes(freqs, m1, m2, chi1z, chi2z, distance_mpc, tc, phic, f_lower, modes)
    mtot = m1 + m2
    s_z = (chi1z * m1 ** 2 + chi2z * m2 ** 2) / mtot ** 2
    first = next(iter(hlms.values()))
    theta = torch.as_tensor(inclination, dtype=first.real.dtype, device=first.device)
    hp = hc = _zeros_c64(first)
    for (l, m), hlm in hlms.items():
        f_r = (2.0 / m) * torch.clamp(freqs, min=1e-3)
        if angle_fn is not None:
            alpha, cos_b, eps = angle_fn(f_r)
        else:
            alpha, cos_b, eps = precession_angles(f_r, m1, m2, s_z, chip, alpha0, f_ref=f_lower)
        # half-angle forms for the generic Wigner row (beta in [0, pi])
        ch = torch.sqrt(torch.clamp((1.0 + cos_b) / 2.0, min=0.0))
        sh = torch.sqrt(torch.clamp((1.0 - cos_b) / 2.0, min=0.0))
        sym = (-1.0) ** l
        tw = 0.5 * hlm * torch.exp(1j * m * eps)
        hp_sum = hc_sum = _zeros_c64(alpha)
        for mp in range(-l, l + 1):
            y = sylm(l, mp, theta)
            phase_mp = torch.exp(-1j * mp * alpha)
            t_pos = y * phase_mp * wigner_d(l, mp, m, ch, sh)
            t_neg = y * torch.conj(phase_mp) * wigner_d(l, mp, -m, ch, sh)
            hp_sum = hp_sum + (t_pos + sym * t_neg)
            hc_sum = hc_sum + 1j * (t_pos - sym * t_neg)
        hp = hp + tw * hp_sum
        hc = hc + tw * hc_sum
    return hp, hc
