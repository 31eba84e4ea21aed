"""Port parity for the precessing and higher-mode models:
``gwkit_torch.data.imrphenomp``, ``gwkit_torch.data.higher_modes`` and
``gwkit_torch.data.precession_ode`` against gwkit's (CPU).

Tolerances: the harmonics, Wigner rows and both twists' polarizations in
float64 (gwkit under jax x64) within 1e-10 of the largest value; ``chi_p``
in float32 bit for bit; the closed-form angles in float32 within 1e-6 of the
largest alpha and cos(beta) and 1e-5 of the largest epsilon (a cumsum of
float32 terms, whose summation order differs between the packages); the
ODE (float32 in both packages) within 1e-5 absolute on the trajectory
(unit-scale vectors, 384 RK4 steps) and 2e-5 of the largest angle after
interpolation; the port's ``interp`` equal to ``jnp.interp`` bit for bit
at the ends, at the grid points and on batched grids; the aligned limit
frozen exactly (alpha 0.7, cos(beta) 1, eps 0.7). The '-twospin'
``td_polarizations`` are held by test_torch_waveforms.py's check (2e-3 of
max |h|).
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gwkit.data import higher_modes as gw_hm
from gwkit.data import imrphenomp as gw_p
from gwkit.data import precession_ode as gw_ode
from gwkit_torch.data import higher_modes as hm
from gwkit_torch.data import imrphenomp as pp
from gwkit_torch.data import precession_ode as ode
from test_torch_waveforms import check_td_polarizations

FREQS = np.linspace(0.0, 512.0, 2049)
# (m1, m2, chi1z, chi2z, chip, alpha0, inclination)
SOURCES = [(36.0, 29.0, 0.2, -0.1, 0.5, 0.3, 0.7), (48.0, 11.0, -0.4, 0.6, 0.8, 2.1, 2.2),
           (20.0, 19.5, 0.0, 0.0, 0.0, 0.0, 1.1)]
# (m1, m2, s1 vector, s2 vector)
SPINS = [(36.0, 29.0, [0.4, 0.0, 0.2], [0.0, 0.3, -0.1]), (40.0, 10.0, [0.05, 0.0, 0.0], [0.0, 0.0, 0.0]),
         (20.0, 15.0, [0.6, -0.5, 0.3], [-0.4, 0.7, 0.1])]


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
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max(), np.abs(got - want).max() / np.abs(want).max()


def _t64(x):
    return torch.tensor(x, dtype=torch.float64)


def test_chi_p_is_gwkit_s_bit_for_bit():
    rng = np.random.default_rng(0)
    m1, m2 = rng.uniform(10, 50, 20000), rng.uniform(10, 50, 20000)
    m1, m2 = np.maximum(m1, m2), np.minimum(m1, m2)
    s = [rng.uniform(-0.7, 0.7, 20000) for _ in range(4)]
    np.testing.assert_array_equal(pp.chi_p(m1, m2, *s).numpy(), np.asarray(gw_p.chi_p(m1, m2, *s)))  # host f64 in
    f32 = [x.astype(np.float32) for x in (m1, m2, *s)]
    np.testing.assert_array_equal(pp.chi_p(*map(torch.from_numpy, f32)).numpy(),
                                  np.asarray(gw_p.chi_p(*map(jnp.asarray, f32))))


def test_harmonics_and_wigner_rows_match_gwkit_in_f64():
    beta = np.linspace(0.0, np.pi, 101)
    with enable_x64():
        for got, want in zip(pp._wigner_d2_row(_t64(np.cos(beta)), _t64(np.sin(beta))),
                             gw_p._wigner_d2_row(jnp.cos(beta), jnp.sin(beta))):
            _rel(got, want)
        for got, want in zip(pp._sYlm_m2_row(_t64(beta)), gw_p._sYlm_m2_row(jnp.asarray(beta))):
            _rel(got, want)
        for l in (2, 3, 4):
            for m in range(-l, l + 1):
                _rel(hm.sylm(l, m, _t64(beta)), gw_hm.sylm(l, m, jnp.asarray(beta)))
                for mp in range(-l, l + 1):
                    _rel(hm.wigner_d(l, mp, m, _t64(np.cos(beta / 2)), _t64(np.sin(beta / 2))),
                         gw_hm.wigner_d(l, mp, m, jnp.cos(beta / 2), jnp.sin(beta / 2)), 1e-12)
        v = np.linspace(0.05, 0.6, 50)
        for (l, m) in hm.DEFAULT_MODES:
            _rel(hm.pn_mode_ratio(l, m, _t64(v), _t64(0.2), _t64(0.45)),
                 gw_hm.pn_mode_ratio(l, m, jnp.asarray(v), 0.2, 0.45))
            _rel(hm.qnm_frequency_lm(l, m, _t64(0.7), _t64(0.05)), gw_hm.qnm_frequency_lm(l, m, 0.7, 0.05))
    assert hm.MODE_PHASE == gw_hm.MODE_PHASE and hm.QNM_FITS == gw_hm.QNM_FITS
    assert hm.DEFAULT_MODES == gw_hm.DEFAULT_MODES


def _batched(rows, k):
    return torch.tensor([[r[k]] for r in rows], dtype=torch.float64)


def test_twists_and_modes_match_gwkit_in_f64():
    """phenomp, phenomhm (its modes and polarizations) and xphm on a (B, 1)
    batch against gwkit one waveform at a time."""
    f = _t64(FREQS)
    sources = SOURCES[:2]  # eager jax in x64 takes seconds a model; the equal-mass source is held in f32
    m1, m2, c1, c2, chip, a0, incl = (_batched(sources, k) for k in range(7))
    kw = dict(tc=_t64(3.0), phic=_t64(0.4), f_lower=20.0)
    got_p = pp.phenomp_hplus_hcross(f, m1, m2, c1, c2, chip, 400.0, incl, alpha0=a0, **kw)
    got_hm = hm.phenomhm_hplus_hcross(f, m1, m2, c1, c2, 400.0, incl, **kw)
    got_x = hm.xphm_hplus_hcross(f, m1, m2, c1, c2, chip, 400.0, incl, alpha0=a0, **kw)
    got_modes = hm.phenomhm_modes(f, m1, m2, c1, c2, 400.0, **kw)
    got_modes_lo = hm.phenomhm_modes(f, m1, m2, c1, c2, 400.0, ringdown_map=False, **kw)
    got_angles = pp.precession_angles(f, m1, m2, (c1 * m1 ** 2 + c2 * m2 ** 2) / (m1 + m2) ** 2, chip, a0)
    with enable_x64():
        fj = jnp.asarray(FREQS)
        for i, (sm1, sm2, sc1, sc2, schip, sa0, sincl) in enumerate(sources):
            kwj = dict(tc=3.0, phic=0.4, f_lower=20.0)
            for got, want in ((got_p, gw_p.phenomp_hplus_hcross(fj, sm1, sm2, sc1, sc2, schip, 400.0, sincl,
                                                                 alpha0=sa0, **kwj)),
                              (got_hm, gw_hm.phenomhm_hplus_hcross(fj, sm1, sm2, sc1, sc2, 400.0, sincl, **kwj)),
                              (got_x, gw_hm.xphm_hplus_hcross(fj, sm1, sm2, sc1, sc2, schip, 400.0, sincl,
                                                              alpha0=sa0, **kwj))):
                for g, w in zip(got, want):
                    assert g.dtype == torch.complex128
                    _rel(g[i].numpy(), w)
            for got, want in ((got_modes, gw_hm.phenomhm_modes(fj, sm1, sm2, sc1, sc2, 400.0, **kwj)),
                              (got_modes_lo, gw_hm.phenomhm_modes(fj, sm1, sm2, sc1, sc2, 400.0, ringdown_map=False,
                                                                  **kwj))):
                assert list(got) == list(want)
                for k in want:
                    _rel(got[k][i].numpy(), want[k])
            s_z = (sc1 * sm1 ** 2 + sc2 * sm2 ** 2) / (sm1 + sm2) ** 2
            for g, w in zip(got_angles, gw_p.precession_angles(fj, sm1, sm2, s_z, schip, sa0)):
                _rel(g[i].numpy(), w)


def test_closed_form_angles_match_gwkit_in_f32():
    f = FREQS.astype(np.float32)
    m1, m2, c1, c2, chip, a0, _ = (_batched(SOURCES, k).float() for k in range(7))
    s_z = (c1 * m1 ** 2 + c2 * m2 ** 2) / (m1 + m2) ** 2
    got = pp.precession_angles(torch.from_numpy(f), m1, m2, s_z, chip, a0)
    for i in range(len(SOURCES)):
        want = gw_p.precession_angles(jnp.asarray(f), *(jnp.float32(x[i, 0]) for x in (m1, m2, s_z, chip, a0)))
        for g, w, tol in zip(got, want, (1e-6, 1e-6, 1e-5)):
            assert g.dtype == torch.float32
            _rel(g[i].numpy(), w, tol)


def _spins():
    m1, m2 = torch.tensor([s[0] for s in SPINS]), torch.tensor([s[1] for s in SPINS])
    return m1, m2, torch.tensor([s[2] for s in SPINS]), torch.tensor([s[3] for s in SPINS])


def test_ode_trajectory_and_angles_match_gwkit():
    m1, m2, s1, s2 = _spins()
    got = ode.integrate_precession(m1, m2, s1, s2, 20.0, 1024.0)
    alpha0 = torch.tensor([[0.7], [0.1], [2.0]])
    angles = ode.precession_angles_numerical(m1, m2, s1, s2, alpha0=alpha0)(torch.from_numpy(FREQS.astype(np.float32)))
    for i, (sm1, sm2, sv1, sv2) in enumerate(SPINS):
        want = gw_ode.integrate_precession(sm1, sm2, sv1, sv2, 20.0, 1024.0)
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and g[i].shape == w.shape
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), rtol=0, atol=1e-5)
        fn = gw_ode.precession_angles_numerical(sm1, sm2, sv1, sv2, alpha0=float(alpha0[i, 0]))
        for g, w in zip(angles, fn(jnp.asarray(FREQS.astype(np.float32)))):
            _rel(g[i].numpy(), w, 2e-5)
    # rotation to +z and the derivatives, batched, against gwkit's per vector
    vec = torch.tensor([[0.3, -0.2, 0.9], [0.0, 0.0, 1.0], [0.1, 0.5, -0.2]])
    for i in range(3):
        np.testing.assert_allclose(ode._rotation_to_z(vec)[i].numpy(), np.asarray(gw_ode._rotation_to_z(jnp.asarray(vec[i].numpy()))),
                                   rtol=0, atol=1e-6)


def test_aligned_limit_is_exactly_frozen():
    fn = ode.precession_angles_numerical(torch.tensor([36.0]), torch.tensor([29.0]), torch.tensor([[0.0, 0.0, 0.4]]),
                                         torch.tensor([[0.0, 0.0, -0.1]]), alpha0=0.7)
    a, cb, e = fn(torch.from_numpy(FREQS.astype(np.float32)))
    assert (a == np.float32(0.7)).all() and (cb == 1.0).all() and (e == np.float32(0.7)).all()


def test_interp_is_jnp_interp():
    xp = np.array([0.5, 1.0, 2.0, 4.0, 4.0, 8.0], np.float32)  # a zero-width interval: jnp's dx0 branch
    fp = np.array([3.0, -1.0, 2.0, 5.0, 7.0, 0.0], np.float32)
    x = np.concatenate([[-3.0, 0.5, 8.0, 9.0], xp, np.random.default_rng(0).uniform(0, 9, 200)]).astype(np.float32)
    want = np.asarray(jnp.interp(x, xp, fp))
    np.testing.assert_array_equal(ode.interp(torch.from_numpy(x), torch.from_numpy(xp)[None], torch.from_numpy(fp)[None])[0].numpy(), want)
    np.testing.assert_array_equal(want[:4], [3.0, 3.0, 0.0, 0.0])  # ends clamped to fp[0], fp[-1]
    # a query on a grid point takes its value (on a repeated point, the last one's)
    np.testing.assert_array_equal(want[4:4 + len(xp)], fp[[0, 1, 2, 4, 4, 5]])
    # batched sorted grids, each row its own, and a query shared by every row
    rng = np.random.default_rng(1)
    xpb = np.sort(rng.uniform(0, 10, (4, 30)), axis=1).astype(np.float32)
    fpb = rng.normal(size=(4, 30)).astype(np.float32)
    xb = rng.uniform(-1, 11, (4, 50)).astype(np.float32)
    gotb = ode.interp(torch.from_numpy(xb), torch.from_numpy(xpb), torch.from_numpy(fpb)).numpy()
    shared = ode.interp(torch.from_numpy(xb[0]), torch.from_numpy(xpb), torch.from_numpy(fpb)).numpy()
    for i in range(4):
        np.testing.assert_array_equal(gotb[i], np.asarray(jnp.interp(xb[i], xpb[i], fpb[i])))
        np.testing.assert_array_equal(shared[i], np.asarray(jnp.interp(xb[0], xpb[i], fpb[i])))


@pytest.mark.parametrize("approximant", ["imrphenomp-twospin", "imrphenomxphm-twospin"])
def test_twospin_td_polarizations_match_gwkit_in_f32(approximant):
    check_td_polarizations(approximant)
