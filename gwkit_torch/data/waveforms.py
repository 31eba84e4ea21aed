"""Compact-binary waveform generation, frequency domain, batched on the card
(counterpart of ``gwkit/data/waveforms.py``).

Approximants: ``imrphenomd`` (default; :mod:`gwkit_torch.data.imrphenomd`),
``taylorf2`` (restricted stationary-phase inspiral to f_ISCO), the
precessing twist ``imrphenomp`` (:mod:`gwkit_torch.data.imrphenomp`), the
aligned higher harmonics ``imrphenomhm`` and both together,
``imrphenomxphm`` (:mod:`gwkit_torch.data.higher_modes`), and the
``-twospin`` variants of the precessing two, whose Euler angles come from the
two-spin precession ODE (:mod:`gwkit_torch.data.precession_ode`).

The FD waveform is synthesized on the rFFT grid and inverse-FFT'd, so a
whole parameter table is one batched irfft. The models put complex values
at Nyquist; the C2R transform drops their imaginary parts, as pocketfft
(the CPU's, and gwkit's) does and as cuFFT does on the H100
(``chip_smoke.py`` phase 9 holds the two against each other). gwkit writes each model for one
waveform and ``jax.vmap``s it; here the batch axis is explicit: parameters
are (B,) tensors, used as (B, 1) against the (F,) grid, and the
polarizations are (B, F) complex.

Conventions: h+(f) = A(f) (1+cos^2 i)/2 e^{-i Psi}, hx = i A cos(i) e^{-i Psi};
SI units; tc places the coalescence within the segment.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Dict, Tuple

import numpy as np
import torch

from gwkit_torch.data import imrphenomd
from gwkit_torch.data.imrphenomd import rdiv
from gwkit_torch.device import DeviceLike, resolve_device

G_SI = 6.674e-11
C_SI = 299792458.0
MSUN_SI = 1.98892e30
MPC_SI = 3.085677581491367e22
MTSUN_SI = G_SI * MSUN_SI / C_SI ** 3  # solar mass in seconds ~4.925e-6
EULER_GAMMA = 0.5772156649015329


def chirp_mass(m1, m2):
    return (m1 * m2) ** (3.0 / 5.0) / (m1 + m2) ** (1.0 / 5.0)


def sym_mass_ratio(m1, m2):
    return (m1 * m2) / (m1 + m2) ** 2


def f_isco(m1, m2):
    """Innermost-stable-circular-orbit GW frequency (Hz)."""
    mtot_s = (m1 + m2) * MTSUN_SI
    if torch.is_tensor(mtot_s):
        return rdiv(1.0, 6.0 ** 1.5 * np.pi * mtot_s)
    return 1.0 / (6.0 ** 1.5 * np.pi * mtot_s)


def taylorf2_phase(f: torch.Tensor, m1, m2, tc=0.0, phic=0.0) -> torch.Tensor:
    """3.5PN TaylorF2 phase Psi(f) (stationary-phase approximation)."""
    mtot = m1 + m2
    eta = sym_mass_ratio(m1, m2)
    m_s = mtot * MTSUN_SI
    v = torch.clamp((math.pi * m_s * f) ** (1.0 / 3.0), min=1e-4)
    eta2, eta3 = eta * eta, eta * eta * eta
    v_lso = (1.0 / 6.0) ** 0.5  # v at ISCO

    p0 = 1.0
    p2 = (3715.0 / 756.0 + 55.0 * eta / 9.0)
    p3 = -16.0 * math.pi
    p4 = 15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta2 / 72.0
    p5 = math.pi * (38645.0 / 756.0 - 65.0 * eta / 9.0) * (1.0 + 3.0 * torch.log(v / v_lso))
    p6 = (
        11583231236531.0 / 4694215680.0
        - 640.0 * math.pi ** 2 / 3.0
        - 6848.0 * EULER_GAMMA / 21.0
        - 6848.0 / 21.0 * torch.log(4.0 * v)
        + eta * (-15737765635.0 / 3048192.0 + 2255.0 * math.pi ** 2 / 12.0)
        + 76055.0 * eta2 / 1728.0
        - 127825.0 * eta3 / 1296.0
    )
    p7 = math.pi * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0 - 74045.0 * eta2 / 756.0)

    series = p0 + p2 * v ** 2 + p3 * v ** 3 + p4 * v ** 4 + p5 * v ** 5 + p6 * v ** 6 + p7 * v ** 7
    return 2.0 * math.pi * f * tc - phic - math.pi / 4.0 + rdiv(3.0, 128.0 * eta * v ** 5) * series


def _carrier(mc_s, d_s, freqs):
    """The Newtonian f^{-7/6} amplitude."""
    return (math.sqrt(5.0 / 24.0) * math.pi ** (-2.0 / 3.0) * mc_s ** (5.0 / 6.0) / d_s
            * torch.clamp(freqs, min=1e-3) ** (-7.0 / 6.0))


def taylorf2_hplus_hcross(freqs: torch.Tensor, m1, m2, distance_mpc, inclination, tc=0.0, phic=0.0,
                          f_lower: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """FD polarizations on the grid; parameters (B, 1) for a batch."""
    mc_s = chirp_mass(m1, m2) * MTSUN_SI
    d_s = distance_mpc * MPC_SI / C_SI
    amp = _carrier(mc_s, d_s, freqs)
    band = (freqs >= f_lower) & (freqs < f_isco(m1, m2))
    psi = taylorf2_phase(freqs, m1, m2, tc=tc, phic=phic)
    h = torch.where(band, amp, 0.0) * torch.exp(-1j * psi)
    cosi = torch.cos(inclination)
    return h * (1.0 + cosi ** 2) / 2.0, 1j * h * cosi


def phenomd_h22(freqs: torch.Tensor, m1, m2, chi1, chi2, distance_mpc, tc=0.0, phic=0.0,
                f_lower: float = 20.0) -> torch.Tensor:
    """Banded IMRPhenomD SPA carrier h = A(f) e^{-i Psi(f)}, shared by the
    aligned polarizations and the precessing twists."""
    mtot_s = (m1 + m2) * MTSUN_SI
    eta = sym_mass_ratio(m1, m2)
    mc_s = chirp_mass(m1, m2) * MTSUN_SI
    d_s = distance_mpc * MPC_SI / C_SI
    mf = mtot_s * torch.clamp(freqs, min=1e-3)
    ampc, phase = imrphenomd.phenomd_amp_phase(mf, eta, chi1, chi2)
    carrier = _carrier(mc_s, d_s, freqs)
    f_cut = rdiv(imrphenomd.F_CUT, mtot_s)
    band = (freqs >= f_lower) & (freqs <= f_cut)
    psi = 2.0 * math.pi * freqs * tc - phic - math.pi / 4.0 + phase
    return torch.where(band, carrier * ampc, 0.0) * torch.exp(-1j * psi)


def phenomd_hplus_hcross(freqs: torch.Tensor, m1, m2, chi1, chi2, distance_mpc, inclination, tc=0.0, phic=0.0,
                         f_lower: float = 20.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """IMRPhenomD FD polarizations (dominant-mode inclination weighting);
    the merger peak lands at ``tc``."""
    h = phenomd_h22(freqs, m1, m2, chi1, chi2, distance_mpc, tc, phic, f_lower)
    cosi = torch.cos(inclination)
    return h * (1.0 + cosi ** 2) / 2.0, 1j * h * cosi


APPROXIMANTS = (
    "taylorf2", "imrphenomd", "imrphenomp", "imrphenomhm", "imrphenomxphm",
    "imrphenomp-twospin", "imrphenomxphm-twospin",
)


_APPROXIMANT_ALIASES = {
    # the reference's SEOBNRv4 family has no implementation here; it maps to
    # IMRPhenomD, the same physical role (aligned-spin BBH IMR), with a warning
    "seobnrv4": "imrphenomd",
    "seobnrv4_opt": "imrphenomd",
    "seobnrv4_rom": "imrphenomd",
    "seobnrv4_pseudofourpn": "imrphenomd",
}

_warned_aliases: set = set()


def canonical_approximant(name: str) -> str:
    """Lower-case and alias-resolve an approximant string (one warning per
    distinct substitution)."""
    key = name.lower()
    sub = _APPROXIMANT_ALIASES.get(key)
    if sub is not None:
        if key not in _warned_aliases:
            _warned_aliases.add(key)
            logging.warning(
                "approximant %r has no gwkit implementation; substituting %s "
                "(same physical role: aligned-spin BBH IMR — see "
                "docs/MIGRATION.md)", name, sub)
        return sub
    return key


def fd_polarizations_switch(freqs, approximant: str, f_lower, m1, m2, dist, incl, tc, phic,
                            chi1, chi2, chip, alpha0, s1x=None, s1y=None, s2x=None, s2y=None):
    """FD (hp, hc) of shape (B, F) for every supported approximant.

    Parameters are (B,) tensors (the in-plane spins of the '-twospin'
    variants default to zero). The '-twospin' variants replace the
    leading-order chi_p Euler angles with the two-spin ODE solution,
    integrated once per batch."""
    approximant = canonical_approximant(approximant)
    zeros = torch.zeros_like(m1)
    if approximant.endswith("-twospin"):
        from gwkit_torch.data.precession_ode import precession_angles_numerical

        spins = [zeros if s is None else s.float() for s in (s1x, s1y, s2x, s2y)]
        angle_fn = precession_angles_numerical(
            m1, m2, torch.stack([spins[0], spins[1], chi1.float()], dim=-1),
            torch.stack([spins[2], spins[3], chi2.float()], dim=-1), alpha0=alpha0[:, None], f_ref=f_lower)
    else:
        angle_fn = None
    m1, m2, dist, incl, tc, phic, chi1, chi2, chip, alpha0 = (
        x[:, None] for x in (m1, m2, dist, incl, tc, phic, chi1, chi2, chip, alpha0))

    if approximant == "taylorf2":
        return taylorf2_hplus_hcross(freqs, m1, m2, dist, incl, tc=tc, phic=phic, f_lower=f_lower)
    if approximant in ("imrphenomp", "imrphenomp-twospin"):
        from gwkit_torch.data.imrphenomp import phenomp_hplus_hcross

        return phenomp_hplus_hcross(freqs, m1, m2, chi1, chi2, chip, dist, incl, tc=tc, phic=phic,
                                    alpha0=alpha0, f_lower=f_lower, angle_fn=angle_fn)
    if approximant == "imrphenomhm":
        from gwkit_torch.data.higher_modes import phenomhm_hplus_hcross

        return phenomhm_hplus_hcross(freqs, m1, m2, chi1, chi2, dist, incl, tc=tc, phic=phic, f_lower=f_lower)
    if approximant in ("imrphenomxphm", "imrphenomxphm-twospin"):
        from gwkit_torch.data.higher_modes import xphm_hplus_hcross

        return xphm_hplus_hcross(freqs, m1, m2, chi1, chi2, chip, dist, incl, tc=tc, phic=phic,
                                 alpha0=alpha0, f_lower=f_lower, angle_fn=angle_fn)
    return phenomd_hplus_hcross(freqs, m1, m2, chi1, chi2, dist, incl, tc=tc, phic=phic, f_lower=f_lower)


def _synthesize_batch(n: int, delta_t: float, m1, m2, dist, incl, tc, phic, f_lower,
                      approximant: str = "imrphenomd", chi1=None, chi2=None, chip=None, alpha0=None,
                      s1x=None, s1y=None, s2x=None, s2y=None):
    delta_f = 1.0 / (n * delta_t)
    freqs = torch.arange(n // 2 + 1, dtype=torch.float32, device=m1.device) * delta_f
    zeros = torch.zeros_like(m1)
    chi1, chi2, chip, alpha0 = (zeros if a is None else a for a in (chi1, chi2, chip, alpha0))
    hp, hc = fd_polarizations_switch(freqs, approximant, f_lower, m1, m2, dist, incl, tc, phic,
                                     chi1, chi2, chip, alpha0, s1x, s1y, s2x, s2y)
    return torch.fft.irfft(hp, n) / delta_t, torch.fft.irfft(hc, n) / delta_t


def td_polarizations(params: Dict[str, np.ndarray], duration: float, sample_rate: float,
                     f_lower: float = 20.0, approximant: str = "imrphenomd",
                     device: DeviceLike = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched time-domain h+, hx of shape (B, N), f32 on the device
    (``None``: the card, raising without one).

    ``params``: arrays 'mass1','mass2','distance' (Mpc), 'inclination',
    'tc' (s, within [0, duration)), 'coa_phase', and for spinning
    approximants 'spin1z','spin2z' (default 0). The precessing
    approximants also read 'chi_p' and 'alpha0'; the '-twospin' variants
    instead read 'spin1x','spin1y','spin2x','spin2y' and integrate the
    two-spin precession ODE for the Euler angles."""
    dev = resolve_device(device)
    n = int(round(duration * sample_rate))
    b = len(params["mass1"])

    def as32(k, default=None):
        return torch.as_tensor(np.asarray(params.get(k, np.full(b, default))), dtype=torch.float32, device=dev)

    return _synthesize_batch(
        n, 1.0 / sample_rate,
        as32("mass1"), as32("mass2"), as32("distance"),
        as32("inclination", 0.0), as32("tc", duration / 2), as32("coa_phase", 0.0),
        f_lower, approximant,
        as32("spin1z", 0.0), as32("spin2z", 0.0),
        as32("chi_p", 0.0), as32("alpha0", 0.0),
        as32("spin1x", 0.0), as32("spin1y", 0.0),
        as32("spin2x", 0.0), as32("spin2y", 0.0),
    )


@dataclasses.dataclass
class SourceDistribution:
    """MLGWSC-1-style injection parameter sampler (ds ini semantics:
    component masses U(10,50), isotropic sky/orientation, uniform chirp
    distance in [130, 350] Mpc).

    ``spin_max`` bounds the spin magnitude (0 = non-spinning, dataset 1).
    ``isotropic_spins=False`` samples aligned components U(-spin_max,
    spin_max) (dataset 2); ``True`` samples isotropic spin vectors with
    magnitude U(0, spin_max) (datasets 3/4), keeping the z components for
    the co-precessing aligned model, the in-plane parts summarized as
    chi_p/alpha0 for the precession twist and carried in full for the
    '-twospin' variants. Host numpy on a ``np.random.Generator``; chi_p's
    last steps run in float32, where gwkit's run in jnp."""

    mass_min: float = 10.0
    mass_max: float = 50.0
    chirp_distance_range: Tuple[float, float] = (130.0, 350.0)
    f_lower: float = 20.0
    spin_max: float = 0.0
    isotropic_spins: bool = False
    approximant: str = "imrphenomd"

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        m1 = rng.uniform(self.mass_min, self.mass_max, n)
        m2 = rng.uniform(self.mass_min, self.mass_max, n)
        m1, m2 = np.maximum(m1, m2), np.minimum(m1, m2)
        dc = rng.uniform(*self.chirp_distance_range, n)
        mc = chirp_mass(m1, m2)
        mc_bns = chirp_mass(1.4, 1.4)
        distance = dc * (mc / mc_bns) ** (5.0 / 6.0)
        chip = np.zeros(n)
        alpha0 = np.zeros(n)
        extra: Dict[str, np.ndarray] = {}
        if self.spin_max <= 0.0:
            s1z = np.zeros(n)
            s2z = np.zeros(n)
        elif self.isotropic_spins:
            from gwkit_torch.data.imrphenomp import chi_p as _chi_p

            a1 = rng.uniform(0, self.spin_max, n)
            a2 = rng.uniform(0, self.spin_max, n)
            cos1 = rng.uniform(-1, 1, n)
            cos2 = rng.uniform(-1, 1, n)
            phi1 = rng.uniform(0, 2 * np.pi, n)
            phi2 = rng.uniform(0, 2 * np.pi, n)
            sin1 = np.sqrt(1.0 - cos1 ** 2)
            sin2 = np.sqrt(1.0 - cos2 ** 2)
            s1z, s2z = a1 * cos1, a2 * cos2
            s1x, s1y = a1 * sin1 * np.cos(phi1), a1 * sin1 * np.sin(phi1)
            s2x, s2y = a2 * sin2 * np.cos(phi2), a2 * sin2 * np.sin(phi2)
            chip = _chi_p(m1, m2, s1x, s1y, s2x, s2y).numpy()
            alpha0 = phi1  # precession phase of the dominant (larger-body) spin
            extra = {
                "spin1x": s1x.astype(np.float32),
                "spin1y": s1y.astype(np.float32),
                "spin2x": s2x.astype(np.float32),
                "spin2y": s2y.astype(np.float32),
            }
        else:
            s1z = rng.uniform(-self.spin_max, self.spin_max, n)
            s2z = rng.uniform(-self.spin_max, self.spin_max, n)
        return {
            **extra,
            "chi_p": chip.astype(np.float32),
            "alpha0": alpha0.astype(np.float32),
            "mass1": m1.astype(np.float32),
            "mass2": m2.astype(np.float32),
            "spin1z": s1z.astype(np.float32),
            "spin2z": s2z.astype(np.float32),
            "chirp_distance": dc.astype(np.float32),
            "distance": distance.astype(np.float32),
            "ra": rng.uniform(0, 2 * np.pi, n).astype(np.float32),
            "dec": np.arcsin(rng.uniform(-1, 1, n)).astype(np.float32),
            "inclination": np.arccos(rng.uniform(-1, 1, n)).astype(np.float32),
            "polarization": rng.uniform(0, 2 * np.pi, n).astype(np.float32),
            "coa_phase": rng.uniform(0, 2 * np.pi, n).astype(np.float32),
        }
