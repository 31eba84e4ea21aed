"""IMRPhenomD: closed-form frequency-domain inspiral-merger-ringdown waveform
(counterpart of ``gwkit/data/imrphenomd.py``; Husa et al. 2016,
arXiv:1508.07250, and Khan et al. 2016, arXiv:1508.07253).

Aligned-spin (2,2)-mode amplitude and phase in three C^1-connected regions
of geometric frequency Mf each, with gwkit's documented deviations from
lalsuite (the Berti QNM fit instead of the interpolated table; the 3PN
inspiral-amplitude term non-spinning only).

Batching: the coefficients are per waveform. Pass parameters of shape
(B, 1) (or scalars for one waveform) and a frequency grid that broadcasts
against them, (F,) or (B, F); every function is elementwise, so the
coefficients broadcast over the grid. gwkit takes the connection constants
and the peak-time shift with ``jax.grad`` of the region ansaetze; here the
derivatives are written out (``_dphase_*``, ``_damp_*``), equal to the
autodiff ones up to rounding.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

PHI_F_JOIN_INS = 0.018  # inspiral->intermediate phase boundary (Mf)
AMP_F_JOIN_INS = 0.014  # inspiral->intermediate amplitude boundary (Mf)
F_CUT = 0.2             # model validity cutoff (Mf)
EULER_GAMMA = 0.5772156649015329

# ---------------------------------------------------------------------------
# Calibrated parameter fits: lambda(eta, chi_PN) with xi = chi_PN - 1,
# 11 coefficients per parameter (Khan et al. 2016, Table V), ordered
# (l00, l10 | l01, l11, l21 | l02, l12, l22 | l03, l13, l23).
# ---------------------------------------------------------------------------
_FITS = {
    # inspiral amplitude, pseudo-PN rho_i
    "rho1": (3931.8979897196696, -17395.758706812805,
             3132.375545898835, 343965.86092361377, -1.2162565819981997e6,
             -70698.00600428853, 1.383907177859705e6, -3.9662761890979446e6,
             -60017.52423652596, 803515.1181825735, -2.091710365941658e6),
    "rho2": (-40105.47653771657, 112253.0169706701,
             23561.696065836168, -3.476180699403351e6, 1.137593670849482e7,
             754313.1127166454, -1.308476044625268e7, 3.6444584853928134e7,
             596226.612472288, -7.4277901143564405e6, 1.8928977514040343e7),
    "rho3": (83208.35471266537, -191237.7264145924,
             -210916.2454782992, 8.71797508352568e6, -2.6914942420669552e7,
             -1.9889806527362722e6, 3.0888029960154563e7, -8.390870279256162e7,
             -1.4535031953446497e6, 1.7063528990822574e7, -4.2748659731120914e7),
    # intermediate amplitude collocation value
    "v2": (0.8149838730507785, 2.5747553517454658,
           1.1610198035496786, -2.3627771785551537, 6.771038707057573,
           0.7570782938606834, -2.7256896890432474, 7.1140380397149965,
           0.1766934149293479, -0.7978690983168183, 2.1162391502005153),
    # merger-ringdown amplitude
    "gamma1": (0.006927402739328343, 0.03020474290328911,
               0.006308024337706171, -0.12074130661131138, 0.26271598905781324,
               0.0034151773647198794, -0.10779338611188374, 0.27098966966891747,
               0.0007374185938559283, -0.02749621038376281, 0.0733150789135702),
    "gamma2": (1.010344404799477, 0.0008993122007234548,
               0.283949116804459, -4.049752962958005, 13.207828172665366,
               0.10396278486805426, -7.025059158961947, 24.784892370130475,
               0.03093202475605892, -2.6924023896851663, 9.609374464684983),
    "gamma3": (1.3081615607036106, -0.005537729694807678,
               -0.06782917938621007, -0.6689834970767117, 3.403147966134083,
               -0.05296577374411866, -0.9923793203111362, 4.820681208409587,
               -0.006134139870393713, -0.38429253308696365, 1.7561754421985984),
    # inspiral phase, pseudo-PN sigma_i
    "sigma1": (2096.551999295543, 1463.7493168261553,
               1312.5493286098522, 18307.330017082117, -43534.1440746107,
               -833.2889543511114, 32047.31997183187, -108609.45037520859,
               452.25136398112204, 8353.439546391714, -44531.3250037322),
    "sigma2": (-10114.056472621156, -44631.01109458185,
               -6541.308761668722, -266959.23419307504, 686328.3229317984,
               3405.6372187679685, -437507.7208209015, 1.6318171307344697e6,
               -7462.648563007646, -114585.25177153319, 674402.4689098676),
    "sigma3": (22933.658273436497, 230960.00814979506,
               14961.083974183695, 1.1940181342318142e6, -3.1042239693052764e6,
               -3038.166617199259, 1.8720322849093592e6, -7.309145012085539e6,
               42738.22871475411, 467502.018616601, -3.064853498512499e6),
    "sigma4": (-14621.71522218357, -377812.8579387104,
               -9608.682631509726, -1.7108925257214056e6, 4.332924601416521e6,
               -22366.683262266528, -2.5019716386377467e6, 1.0274495902259542e7,
               -85360.30079034246, -570025.3441737515, 4.396844346849777e6),
    # intermediate phase beta_i
    "beta1": (97.89747327985583, -42.659730877489224,
              153.48421037904913, -1417.0620760768954, 2752.8614143665027,
              138.7406469558649, -1433.6585075135881, 2857.7418952430758,
              41.025109467376126, -423.680737974639, 850.3594335657173),
    "beta2": (-3.282701958759534, -9.051384468245866,
              -12.415449742258042, 55.4716447709787, -106.05109938966335,
              -11.953044553690658, 76.80704618365418, -155.33172948098394,
              -3.4129261592393263, 25.572377569952536, -54.408036707740465),
    "beta3": (-2.5156429818799565e-5, 1.9750256942201327e-5,
              -1.8370671469295915e-5, 2.1886317041311973e-5, 8.250240316860033e-5,
              7.157371250566708e-6, -5.5780000112270685e-5, 1.9142082884072178e-4,
              5.447166261464217e-6, -3.220610095021982e-5, 7.974016714984341e-5),
    # merger-ringdown phase alpha_i
    "alpha1": (43.31514709695348, 638.6332679188081,
               -32.85768747216059, 2415.8938269370315, -5766.875169379177,
               -61.85459307173841, 2953.967762459948, -8986.29057591497,
               -21.571435779762044, 981.2158224673428, -3239.5664895930286),
    "alpha2": (-0.07020209449091723, -0.16269798450687084,
               -0.1872514685185499, 1.138313650449945, -2.8334196304430046,
               -0.17137955686840617, 1.7197549338119527, -4.539717148261272,
               -0.049983437357548705, 0.6062072055948309, -1.682769616644546),
    "alpha3": (9.5988072383479, -397.05438595557433,
               16.202126189517813, -1574.8286986717037, 3600.3410843831093,
               27.092429659075467, -1786.482357315139, 5152.919378666511,
               11.175710130033895, -577.7999423177481, 1808.730762932043),
    "alpha4": (-0.02989487384493607, 1.4022106448583738,
               -0.07356049468633846, 0.8337006542278661, 0.2240008282397391,
               -0.055202870001177226, 0.5667186343606578, 0.7186931973380503,
               -0.015507437354325743, 0.15750322779277187, 0.21076815715176228),
    "alpha5": (0.9974408278363099, -0.007884449714907203,
               -0.059046901195591035, 1.3958712396764088, -4.516631601676276,
               -0.05585343136869692, 1.7516580039343603, -5.990208965347804,
               -0.017945336522161195, 0.5965097794825992, -2.0608879367971804),
}


def scalar(c: float, like: torch.Tensor) -> torch.Tensor:
    """``c`` as a 0-dim tensor of ``like``'s dtype on the CPU (an operand
    any device takes without a copy)."""
    return torch.tensor(c, dtype=like.dtype)


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x rounded once, as jnp divides (torch's ``c / x`` is
    ``x.reciprocal() * c``, two roundings)."""
    return torch.div(scalar(c, x), x)


def _fit(name, eta, xi):
    l = _FITS[name]
    eta2 = eta * eta
    return (l[0] + l[1] * eta
            + xi * (l[2] + l[3] * eta + l[4] * eta2)
            + xi * xi * (l[5] + l[6] * eta + l[7] * eta2)
            + xi * xi * xi * (l[8] + l[9] * eta + l[10] * eta2))


def _delta(eta):
    return torch.sqrt(torch.clamp(1.0 - 4.0 * eta, min=0.0))


def chi_pn(eta, chi1, chi2):
    """Effective PN spin parameter used by the calibration fits."""
    delta = _delta(eta)
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    return chi_s * (1.0 - eta * 76.0 / 113.0) + delta * chi_a


def final_spin(eta, chi1, chi2):
    """Remnant dimensionless spin (Husa et al. 2016 `FinalSpin0815`)."""
    delta = _delta(eta)
    m1, m2 = 0.5 * (1.0 + delta), 0.5 * (1.0 - delta)
    s = m1 * m1 * chi1 + m2 * m2 * chi2
    eta2, eta3 = eta * eta, eta * eta * eta
    return (3.4641016151377544 * eta - 4.399247300629289 * eta2
            + 9.397292189321194 * eta3 - 13.180949901606242 * eta2 * eta2
            + eta * s * ((rdiv(1.0, torch.clamp(eta, min=1e-6)) - 0.0850917821418767
                          - 5.837029316602263 * eta)
                         + (0.1014665242971878 - 2.0967746996832157 * eta) * s
                         + (-1.3546806617824356 + 4.108962025369336 * eta) * s * s
                         + (-0.8676969352555539 + 2.064046835273906 * eta) * s * s * s))


def radiated_energy(eta, chi1, chi2):
    """Fraction of the total mass radiated (Husa et al. `EradRational0815`)."""
    delta = _delta(eta)
    m1, m2 = 0.5 * (1.0 + delta), 0.5 * (1.0 - delta)
    s = m1 * m1 * chi1 + m2 * m2 * chi2
    eta2, eta3 = eta * eta, eta * eta * eta
    num = (eta * (0.055974469826360077 + 0.5809510763115132 * eta
                  - 0.9606726679372312 * eta2 + 3.352411249771192 * eta3)
           * (1.0 + (-0.0030302335878845507 - 2.0066110851351073 * eta
                     + 7.7050567802399215 * eta2) * s))
    den = 1.0 + (-0.6714403054720589 - 1.4756929437702908 * eta
                 + 7.304676214885011 * eta2) * s
    return num / den


def qnm_ringdown(final_a, erad):
    """(f_RD, f_damp) of the (2,2,0) QNM in initial-total-mass units
    (Berti, Cardoso & Will 2006 fit, scaled by 1/(1 - E_rad))."""
    a = torch.clamp(final_a, -0.999, 0.999)
    one_m_a = 1.0 - a
    omega = 1.5251 - 1.1568 * one_m_a ** 0.1292
    quality = 0.7000 + 1.4187 * one_m_a ** (-0.4990)
    scale = rdiv(1.0, 2.0 * math.pi * (1.0 - erad))
    f_rd = omega * scale
    f_damp = omega / (2.0 * quality) * scale
    return f_rd, f_damp


class PhenomDCoeffs(NamedTuple):
    eta: torch.Tensor
    chi1: torch.Tensor
    chi2: torch.Tensor
    f_rd: torch.Tensor
    f_damp: torch.Tensor
    rho1: torch.Tensor
    rho2: torch.Tensor
    rho3: torch.Tensor
    v2: torch.Tensor
    gamma1: torch.Tensor
    gamma2: torch.Tensor
    gamma3: torch.Tensor
    sigma1: torch.Tensor
    sigma2: torch.Tensor
    sigma3: torch.Tensor
    sigma4: torch.Tensor
    beta1: torch.Tensor
    beta2: torch.Tensor
    beta3: torch.Tensor
    alpha1: torch.Tensor
    alpha2: torch.Tensor
    alpha3: torch.Tensor
    alpha4: torch.Tensor
    alpha5: torch.Tensor


def phenomd_coeffs(eta, chi1, chi2) -> PhenomDCoeffs:
    """The 19 calibrated parameters and the ringdown frequencies, each of
    the parameters' shape ((B, 1) for a batch; floats take eta's dtype)."""
    eta = torch.as_tensor(eta)
    chi1, chi2 = (torch.as_tensor(c, dtype=eta.dtype, device=eta.device) for c in (chi1, chi2))
    xi = chi_pn(eta, chi1, chi2) - 1.0
    af = final_spin(eta, chi1, chi2)
    erad = radiated_energy(eta, chi1, chi2)
    f_rd, f_damp = qnm_ringdown(af, erad)
    vals = {k: _fit(k, eta, xi) for k in _FITS}
    return PhenomDCoeffs(eta=eta, chi1=chi1, chi2=chi2, f_rd=f_rd, f_damp=f_damp, **vals)


# ---------------------------------------------------------------------------
# Phase
# ---------------------------------------------------------------------------

def _tf2_terms(eta, chi1, chi2):
    """The spin-dependent TaylorF2 coefficients: p2, p3, p4, the 2.5PN
    coefficient without its (1 + 3 ln v), the 3PN coefficient's parts before
    and after its -6848/21 ln(4 v) term, and p7."""
    delta = _delta(eta)
    chi_s = 0.5 * (chi1 + chi2)
    chi_a = 0.5 * (chi1 - chi2)
    eta2, eta3 = eta * eta, eta * eta * eta
    chi_s2, chi_a2, chi_sa = chi_s * chi_s, chi_a * chi_a, chi_s * chi_a
    pi = math.pi

    p2 = 3715.0 / 756.0 + 55.0 * eta / 9.0
    p3 = (-16.0 * pi
          + 113.0 * delta * chi_a / 3.0 + (113.0 / 3.0 - 76.0 * eta / 3.0) * chi_s)
    p4 = (15293365.0 / 508032.0 + 27145.0 * eta / 504.0 + 3085.0 * eta2 / 72.0
          + (-405.0 / 8.0 + 200.0 * eta) * chi_a2
          - 405.0 / 4.0 * delta * chi_sa
          + (-405.0 / 8.0 + 5.0 * eta / 2.0) * chi_s2)
    p5_base = (pi * (38645.0 / 756.0 - 65.0 * eta / 9.0)
               - (732985.0 / 2268.0 - 24260.0 * eta / 81.0 - 340.0 * eta2 / 9.0) * chi_s
               - (732985.0 / 2268.0 - 140.0 * eta / 9.0) * delta * chi_a)
    p6_head = 11583231236531.0 / 4694215680.0 - 640.0 * pi ** 2 / 3.0 - 6848.0 * EULER_GAMMA / 21.0
    p6_tail = (eta * (-15737765635.0 / 3048192.0 + 2255.0 * pi ** 2 / 12.0)
               + 76055.0 * eta2 / 1728.0 - 127825.0 * eta3 / 1296.0
               + pi * (2270.0 / 3.0 - 520.0 * eta) * chi_s
               + pi * 2270.0 / 3.0 * delta * chi_a
               + (75515.0 / 288.0 - 232415.0 * eta / 504.0 + 1255.0 * eta2 / 9.0) * chi_s2
               + (75515.0 / 288.0 - 263245.0 * eta / 252.0 - 480.0 * eta2) * chi_a2
               + (75515.0 / 144.0 - 8225.0 * eta / 18.0) * delta * chi_sa)
    p7 = (pi * (77096675.0 / 254016.0 + 378515.0 * eta / 1512.0
                - 74045.0 * eta2 / 756.0)
          + (-25150083775.0 / 3048192.0 + 10566655595.0 * eta / 762048.0
             - 1042165.0 * eta2 / 3024.0 + 5345.0 * eta3 / 36.0) * chi_s
          + (-25150083775.0 / 3048192.0 + 26804935.0 * eta / 6048.0
             - 1985.0 * eta2 / 48.0) * delta * chi_a)
    return p2, p3, p4, p5_base, p6_head, p6_tail, p7


def taylorf2_series(v, eta, chi1, chi2):
    """3.5PN TaylorF2 aligned-spin phasing series Sum c_k v^k (c_0 = 1)."""
    p2, p3, p4, p5_base, p6_head, p6_tail, p7 = _tf2_terms(eta, chi1, chi2)
    p5 = p5_base * (1.0 + 3.0 * torch.log(v))
    p6 = p6_head - 6848.0 / 21.0 * torch.log(4.0 * v) + p6_tail
    v2_ = v * v
    return (1.0 + p2 * v2_ + p3 * v2_ * v + p4 * v2_ * v2_ + p5 * v2_ * v2_ * v
            + p6 * v2_ * v2_ * v2_ + p7 * v2_ * v2_ * v2_ * v)


def _dtaylorf2_series(v, eta, chi1, chi2):
    """d/dv of :func:`taylorf2_series`."""
    p2, p3, p4, p5_base, p6_head, p6_tail, p7 = _tf2_terms(eta, chi1, chi2)
    p6 = p6_head - 6848.0 / 21.0 * torch.log(4.0 * v) + p6_tail
    v2_ = v * v
    v4 = v2_ * v2_
    return (2.0 * p2 * v + 3.0 * p3 * v2_ + 4.0 * p4 * v2_ * v
            + p5_base * (5.0 * (1.0 + 3.0 * torch.log(v)) + 3.0) * v4
            + (6.0 * p6 - 6848.0 / 21.0) * v4 * v + 7.0 * p7 * v4 * v2_)


def _phase_ins(mf, c: PhenomDCoeffs):
    """Inspiral phase: TaylorF2 + calibrated pseudo-PN sigma terms."""
    v = (math.pi * mf) ** (1.0 / 3.0)
    tf2 = rdiv(3.0, 128.0 * c.eta * v ** 5) * taylorf2_series(v, c.eta, c.chi1, c.chi2)
    sig = (c.sigma1 * mf + 0.75 * c.sigma2 * mf ** (4.0 / 3.0)
           + 0.6 * c.sigma3 * mf ** (5.0 / 3.0) + 0.5 * c.sigma4 * mf * mf) / c.eta
    return tf2 + sig


def _dphase_ins(mf, c: PhenomDCoeffs):
    v = (math.pi * mf) ** (1.0 / 3.0)
    s = taylorf2_series(v, c.eta, c.chi1, c.chi2)
    ds = _dtaylorf2_series(v, c.eta, c.chi1, c.chi2)
    dtf2_dv = rdiv(3.0, 128.0 * c.eta) * (ds / v ** 5 - 5.0 * s / v ** 6)
    dsig = (c.sigma1 + c.sigma2 * mf ** (1.0 / 3.0)
            + c.sigma3 * mf ** (2.0 / 3.0) + c.sigma4 * mf) / c.eta
    return dtf2_dv * (math.pi / (3.0 * v * v)) + dsig


def _phase_int(mf, c: PhenomDCoeffs):
    return (c.beta1 * mf + c.beta2 * torch.log(mf)
            - c.beta3 / (3.0 * mf ** 3)) / c.eta


def _dphase_int(mf, c: PhenomDCoeffs):
    return (c.beta1 + c.beta2 / mf + c.beta3 / mf ** 4) / c.eta


def _phase_mrd(mf, c: PhenomDCoeffs):
    return (c.alpha1 * mf - c.alpha2 / mf
            + 4.0 / 3.0 * c.alpha3 * mf ** 0.75
            + c.alpha4 * torch.atan((mf - c.alpha5 * c.f_rd) / c.f_damp)) / c.eta


def _dphase_mrd(mf, c: PhenomDCoeffs):
    x = (mf - c.alpha5 * c.f_rd) / c.f_damp
    return (c.alpha1 + c.alpha2 / mf ** 2 + c.alpha3 * mf ** -0.25
            + c.alpha4 / (c.f_damp * (1.0 + x * x))) / c.eta


def _amp_peak_freq(c: PhenomDCoeffs):
    """Frequency of the amplitude peak (`fmaxCalc` in lalsuite)."""
    g2 = torch.clamp(c.gamma2, min=1e-6)
    below = c.f_rd + c.f_damp * c.gamma3 * (torch.sqrt(torch.clamp(1.0 - g2 * g2, min=0.0)) - 1.0) / g2
    above = c.f_rd - c.f_damp * c.gamma3 / g2
    return torch.abs(torch.where(c.gamma2 <= 1.0, below, above))


def _phase_connection(c: PhenomDCoeffs):
    """(c1_int, c2_int, c1_mrd, c2_mrd, f_peak, t0): the C^1 connection
    constants of the intermediate and merger-ringdown phases and the
    peak-time shift."""
    f1 = scalar(PHI_F_JOIN_INS, c.eta)
    f2 = 0.5 * c.f_rd
    c2_int = _dphase_ins(f1, c) - _dphase_int(f1, c)
    c1_int = _phase_ins(f1, c) - _phase_int(f1, c) - c2_int * f1
    c2_mrd = _dphase_int(f2, c) + c2_int - _dphase_mrd(f2, c)
    c1_mrd = (_phase_int(f2, c) + c1_int + c2_int * f2
              - _phase_mrd(f2, c) - c2_mrd * f2)
    f_peak = _amp_peak_freq(c)
    t0 = _dphase_mrd(f_peak, c) + c2_mrd
    return c1_int, c2_int, c1_mrd, c2_mrd, f_peak, t0


def phenomd_phase(mf: torch.Tensor, c: PhenomDCoeffs):
    """Full C^1 phase phi(Mf), peak-aligned: d(phi)/d(Mf) = 0 at the
    amplitude peak, so the merger sits at t = tc when 2 pi f tc is added."""
    mf = torch.clamp(mf, 1e-6, 0.5)
    c1_int, c2_int, c1_mrd, c2_mrd, f_peak, t0 = _phase_connection(c)
    phi = torch.where(
        mf < PHI_F_JOIN_INS,
        _phase_ins(mf, c),
        torch.where(mf < 0.5 * c.f_rd,
                    _phase_int(mf, c) + c1_int + c2_int * mf,
                    _phase_mrd(mf, c) + c1_mrd + c2_mrd * mf))
    return phi - t0 * (mf - f_peak)


def phenomd_dphase(mf: torch.Tensor, c: PhenomDCoeffs):
    """d(phenomd_phase)/d(Mf) inside (1e-6, 0.5) (gwkit takes it with
    ``jax.grad`` of :func:`phenomd_phase` in its higher modes)."""
    _, c2_int, _, c2_mrd, _, t0 = _phase_connection(c)
    d = torch.where(
        mf < PHI_F_JOIN_INS,
        _dphase_ins(mf, c),
        torch.where(mf < 0.5 * c.f_rd,
                    _dphase_int(mf, c) + c2_int,
                    _dphase_mrd(mf, c) + c2_mrd))
    return d - t0


# ---------------------------------------------------------------------------
# Amplitude
# ---------------------------------------------------------------------------

def _amp_ins_terms(c: PhenomDCoeffs):
    """The PN amplitude coefficients a23, a1, a43, a53, a2."""
    eta, chi1, chi2 = c.eta, c.chi1, c.chi2
    delta = _delta(eta)
    eta2, eta3 = eta * eta, eta * eta * eta
    chi12, chi22 = chi1 * chi1, chi2 * chi2
    pi = math.pi

    a23 = (-969.0 + 1804.0 * eta) / 672.0 * pi ** (2.0 / 3.0)
    a1 = (chi1 * (81.0 * (1.0 + delta) - 44.0 * eta)
          + chi2 * (81.0 * (1.0 - delta) - 44.0 * eta)) / 48.0 * pi
    a43 = ((-27312085.0 + 24.0 * (-1975055.0 + 857304.0 * eta) * eta
            - 10287648.0 * (chi12 * (1.0 + delta) + chi22 * (1.0 - delta)))
           / 8128512.0) * pi ** (4.0 / 3.0)
    a53 = ((chi2 * (-285197.0 * (-1.0 + delta) + 4.0 * (-91902.0 + 1579.0 * eta) * eta)
            + chi1 * (285197.0 * (1.0 + delta) - 4.0 * (91902.0 + 1579.0 * eta) * eta)
            + 42840.0 * (-1.0 + 4.0 * eta) * pi) / 32256.0) * pi ** (5.0 / 3.0)
    a2 = (-177520268561.0 / 8583708672.0
          + (545384828789.0 / 5007163392.0 - 205.0 * pi ** 2 / 48.0) * eta
          - 3248849057.0 * eta2 / 178827264.0
          + 34473079.0 * eta3 / 6386688.0) * pi ** 2
    return a23, a1, a43, a53, a2


def _amp_ins(mf, c: PhenomDCoeffs):
    """Inspiral amplitude correction factor (multiplies the f^{-7/6} carrier):
    PN re-expansion through (pi f)^2 plus the calibrated rho_i terms."""
    a23, a1, a43, a53, a2 = _amp_ins_terms(c)
    x = mf ** (1.0 / 3.0)
    return (1.0 + a23 * x * x + a1 * mf + a43 * x * mf + a53 * x * x * mf
            + a2 * mf * mf
            + c.rho1 * mf ** (7.0 / 3.0) + c.rho2 * mf ** (8.0 / 3.0)
            + c.rho3 * mf ** 3)


def _damp_ins(mf, c: PhenomDCoeffs):
    a23, a1, a43, a53, a2 = _amp_ins_terms(c)
    x = mf ** (1.0 / 3.0)
    return (2.0 / 3.0 * a23 / x + a1 + 4.0 / 3.0 * a43 * x + 5.0 / 3.0 * a53 * x * x
            + 2.0 * a2 * mf
            + 7.0 / 3.0 * c.rho1 * mf ** (4.0 / 3.0) + 8.0 / 3.0 * c.rho2 * mf ** (5.0 / 3.0)
            + 3.0 * c.rho3 * mf * mf)


def _amp_mrd(mf, c: PhenomDCoeffs):
    """Merger-ringdown amplitude: damped Lorentzian around f_RD."""
    fdg3 = c.f_damp * c.gamma3
    dfr = mf - c.f_rd
    return (torch.exp(-dfr * c.gamma2 / fdg3)
            * fdg3 * c.gamma1 / (dfr * dfr + fdg3 * fdg3))


def _damp_mrd(mf, c: PhenomDCoeffs):
    fdg3 = c.f_damp * c.gamma3
    dfr = mf - c.f_rd
    return _amp_mrd(mf, c) * (-c.gamma2 / fdg3 - 2.0 * dfr / (dfr * dfr + fdg3 * fdg3))


def phenomd_amplitude(mf: torch.Tensor, c: PhenomDCoeffs):
    """Dimensionless amplitude correction A(Mf)/[A_Newt f^{-7/6} carrier].

    The intermediate region is a quartic from C^1 collocation (values at
    f1/f_mid/f3, derivatives at f1/f3) in x = (f-f1)/(f3-f1); gwkit solves
    the 5x5 system per waveform, the port applies its exact (integral)
    inverse."""
    mf = torch.clamp(mf, 1e-6, 0.5)
    f1 = scalar(AMP_F_JOIN_INS, c.eta)
    f3 = torch.clamp(_amp_peak_freq(c), min=AMP_F_JOIN_INS + 1e-3)
    width = f3 - f1

    v1, d1 = _amp_ins(f1, c), _damp_ins(f1, c) * width
    v2, v3, d3 = c.v2, _amp_mrd(f3, c), _damp_mrd(f3, c) * width
    # the collocation matrix's inverse is integral:
    # p(x) = sum a_k x^k with p(0)=v1, p'(0)=d1, p(1/2)=v2, p(1)=v3, p'(1)=d3
    a = (v1, d1,
         -11.0 * v1 - 4.0 * d1 + 16.0 * v2 - 5.0 * v3 + d3,
         18.0 * v1 + 5.0 * d1 - 32.0 * v2 + 14.0 * v3 - 3.0 * d3,
         -8.0 * v1 - 2.0 * d1 + 16.0 * v2 - 8.0 * v3 + 2.0 * d3)

    x = (mf - f1) / width
    poly = a[0] + x * (a[1] + x * (a[2] + x * (a[3] + x * a[4])))
    return torch.where(mf < AMP_F_JOIN_INS, _amp_ins(mf, c),
                       torch.where(mf < f3, poly, _amp_mrd(mf, c)))


def phenomd_amp_phase(mf: torch.Tensor, eta, chi1, chi2):
    """(amplitude correction, phase) on a geometric grid."""
    c = phenomd_coeffs(eta, chi1, chi2)
    return phenomd_amplitude(mf, c), phenomd_phase(mf, c)
