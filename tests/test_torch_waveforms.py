"""Port parity for the aligned waveform models: ``gwkit_torch.data.
imrphenomd`` and ``gwkit_torch.data.waveforms`` against gwkit's (CPU).

Tolerances: the IMRPhenomD pieces in float64 (gwkit under jax x64, as its
own tests run them) within 1e-10 of the largest value, the phase's
derivative (written out here, ``jax.grad`` in gwkit) included;
``td_polarizations`` for every approximant (the two '-twospin' ones in
tests/test_torch_precession.py) in float32 within 2e-3 of each
waveform's max |h|: phases reach 1e3-1e4 rad, where one float32 ulp is
1e-4-1e-3 rad, so two correct evaluation orders differ by about that much
(gwkit's own jit, which fuses multiplies and adds, and its eager path
differ at the 1e-3 level on these inputs). ``canonical_approximant`` and ``SourceDistribution.sample``
for the four challenge populations are equal bit for bit, chi_p included
(its last steps in float32, where gwkit's are jnp).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwkit.data import imrphenomd as gw_phd
from gwkit.data import waveforms as gw_wf
from gwkit.data.generate import challenge_distribution
from gwkit_torch.data import imrphenomd as phd
from gwkit_torch.data import waveforms as wf

# (eta, chi1, chi2): equal mass, unequal with spins both ways, near the edges of the calibration
POINTS = [(0.25, 0.0, 0.0), (0.2, 0.5, -0.3), (0.1, 0.9, 0.2), (0.16, -0.8, 0.7), (0.0555, 0.3, 0.95)]
MF = np.linspace(1e-4, 0.3, 1500)


@contextlib.contextmanager
def enable_x64():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", prev)


def _rel(got, want, tol=1e-10):
    """|got - want| <= tol * max |want| (complex values by modulus)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def _t64(x):
    return torch.tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("point", POINTS)
def test_imrphenomd_pieces_match_gwkit_in_f64(point):
    eta, c1, c2 = point
    with enable_x64():
        for fn in ("chi_pn", "final_spin", "radiated_energy"):
            _rel(getattr(phd, fn)(_t64(eta), _t64(c1), _t64(c2)), getattr(gw_phd, fn)(eta, c1, c2))
        af, erad = gw_phd.final_spin(eta, c1, c2), gw_phd.radiated_energy(eta, c1, c2)
        for g, w in zip(phd.qnm_ringdown(_t64(float(af)), _t64(float(erad))), gw_phd.qnm_ringdown(af, erad)):
            _rel(g, w)
        cg, ct = gw_phd.phenomd_coeffs(eta, c1, c2), phd.phenomd_coeffs(_t64(eta), c1, c2)
        assert ct._fields == cg._fields
        for k in cg._fields:
            _rel(getattr(ct, k), getattr(cg, k))
        v = np.linspace(0.05, 0.6, 300)
        _rel(phd.taylorf2_series(_t64(v), _t64(eta), _t64(c1), _t64(c2)), gw_phd.taylorf2_series(jnp.asarray(v), eta, c1, c2))
        mf = jnp.asarray(MF)
        for name in ("_phase_ins", "_phase_int", "_phase_mrd", "_amp_ins", "_amp_mrd", "phenomd_phase",
                     "phenomd_amplitude"):
            _rel(getattr(phd, name)(_t64(MF), ct), getattr(gw_phd, name)(mf, cg))
        _rel(phd._amp_peak_freq(ct), gw_phd._amp_peak_freq(cg))
        for got, want in zip(phd.phenomd_amp_phase(_t64(MF), _t64(eta), c1, c2),
                             gw_phd.phenomd_amp_phase(mf, eta, c1, c2)):
            _rel(got, want)
        # the phase's derivative where the higher modes stitch (and inside each region)
        dphi = jax.grad(lambda x: gw_phd.phenomd_phase(x, cg))
        for f in (gw_phd.PHI_F_JOIN_INS, float(cg.f_rd), 0.004, 0.03, 0.15):
            _rel(phd.phenomd_dphase(_t64(f), ct), dphi(jnp.asarray(f)))
        for name in ("phase_ins", "phase_int", "phase_mrd", "amp_ins", "amp_mrd"):
            d = jax.grad(lambda x: getattr(gw_phd, "_" + name)(x, cg))
            _rel(getattr(phd, "_d" + name)(_t64(0.05), ct), d(jnp.asarray(0.05)))


def test_imrphenomd_coefficients_broadcast_over_a_batch():
    eta = torch.tensor([[p[0]] for p in POINTS], dtype=torch.float64)
    c1 = torch.tensor([[p[1]] for p in POINTS], dtype=torch.float64)
    c2 = torch.tensor([[p[2]] for p in POINTS], dtype=torch.float64)
    amp, phase = phd.phenomd_amp_phase(_t64(MF), eta, c1, c2)
    assert amp.shape == phase.shape == (len(POINTS), len(MF))
    for i, p in enumerate(POINTS):
        a1, p1 = phd.phenomd_amp_phase(_t64(MF), _t64(p[0]), p[1], p[2])
        torch.testing.assert_close(amp[i], a1, rtol=1e-13, atol=0)
        torch.testing.assert_close(phase[i], p1, rtol=1e-13, atol=1e-9)


def test_waveform_helpers_match_gwkit_in_f64():
    m1, m2 = np.array([36.0, 12.5, 48.0]), np.array([29.0, 11.0, 10.5])
    for fn in ("chirp_mass", "sym_mass_ratio", "f_isco"):
        np.testing.assert_array_equal(getattr(wf, fn)(m1, m2), getattr(gw_wf, fn)(m1, m2))
        _rel(getattr(wf, fn)(_t64(m1), _t64(m2)), getattr(gw_wf, fn)(m1, m2), 1e-15)
    for k in ("G_SI", "C_SI", "MSUN_SI", "MPC_SI", "MTSUN_SI", "EULER_GAMMA"):
        assert getattr(wf, k) == getattr(gw_wf, k)
    f = np.linspace(0.0, 512.0, 2049)
    with enable_x64():
        for i in range(2):
            args = (m1[i], m2[i], 0.3 * i - 0.2, 0.1, 410.0)
            _rel(wf.taylorf2_phase(_t64(f), *map(_t64, (m1[i], m2[i], 3.0, 0.4))),
                 gw_wf.taylorf2_phase(jnp.asarray(f), m1[i], m2[i], 3.0, 0.4))
            for got, want in ((wf.phenomd_h22(_t64(f), *map(_t64, args), _t64(3.0), _t64(0.4)),
                               gw_wf.phenomd_h22(jnp.asarray(f), *args, 3.0, 0.4)),
                              *zip(wf.phenomd_hplus_hcross(_t64(f), *map(_t64, args), _t64(0.7), _t64(3.0), _t64(0.4)),
                                   gw_wf.phenomd_hplus_hcross(jnp.asarray(f), *args, 0.7, 3.0, 0.4)),
                              *zip(wf.taylorf2_hplus_hcross(_t64(f), *map(_t64, (m1[i], m2[i], 410.0, 0.7, 3.0, 0.4))),
                                   gw_wf.taylorf2_hplus_hcross(jnp.asarray(f), m1[i], m2[i], 410.0, 0.7, 3.0, 0.4))):
                assert got.dtype == torch.complex128
                _rel(got.numpy(), np.asarray(want))


def _params(n=3, seed=3):
    p = gw_wf.SourceDistribution(spin_max=0.99, isotropic_spins=True).sample(np.random.default_rng(seed), n)
    p["tc"] = np.array([3.0, 2.2, 3.5][:n], np.float32)
    return p


def check_td_polarizations(approximant):
    """``td_polarizations`` of three ds3/4 sources, 4 s at 1024 Hz, against
    gwkit's in float32: within 2e-3 of each waveform's max |h|."""
    p = _params()
    want = [np.asarray(h) for h in gw_wf.td_polarizations(p, 4.0, 1024.0, 20.0, approximant)]
    got = wf.td_polarizations(p, 4.0, 1024.0, 20.0, approximant, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape == (3, 4096)
        g = g.numpy()
        scale = np.abs(w).max(axis=-1, keepdims=True)
        assert (np.abs(g - w) <= 2e-3 * scale).all(), float((np.abs(g - w) / scale).max())


# the '-twospin' variants, which integrate the precession ODE, are held in
# tests/test_torch_precession.py by the same check
@pytest.mark.parametrize("approximant", [a for a in gw_wf.APPROXIMANTS if not a.endswith("-twospin")])
def test_td_polarizations_match_gwkit_in_f32(approximant):
    assert wf.APPROXIMANTS == gw_wf.APPROXIMANTS
    check_td_polarizations(approximant)


def test_canonical_approximant_is_gwkit_s(caplog):
    for name in ("IMRPhenomD", "imrphenomxphm-twospin", "TaylorF2", "SEOBNRv4_opt", "seobnrv4", "SEOBNRv4_ROM",
                 "seobnrv4_pseudofourpn", "other"):
        assert wf.canonical_approximant(name) == gw_wf.canonical_approximant(name)
    assert wf._APPROXIMANT_ALIASES == gw_wf._APPROXIMANT_ALIASES


@pytest.mark.parametrize("dataset", [1, 2, 3, 4])
def test_source_distribution_is_gwkit_s_bit_for_bit(dataset):
    gd = challenge_distribution(dataset)
    d = wf.SourceDistribution(**{f: getattr(gd, f) for f in gd.__dataclass_fields__})
    assert [f for f in d.__dataclass_fields__] == [f for f in gd.__dataclass_fields__]
    got, want = d.sample(np.random.default_rng(5), 4000), gd.sample(np.random.default_rng(5), 4000)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
