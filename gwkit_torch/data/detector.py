"""Ground-based detector geometry: antenna patterns and time delays
(counterpart of ``gwkit/data/detector.py``, kept as its own numpy copy).

Host code on per-injection scalars, as in gwkit: the published LALDetector
response tensors and locations (Earth-fixed frame), and

h(t) = F+(ra,dec,psi,t) h+(t) + Fx(ra,dec,psi,t) hx(t), with arrival-time
delay dt = -(r_det . n_src)/c relative to the geocenter.
"""
from __future__ import annotations

import numpy as np

C_SI = 299792458.0

# LALDetector response tensors (d = (u x u - v x v)/2) and locations (m).
DETECTORS = {
    "H1": {
        "response": np.array(
            [
                [-0.3926141, -0.0776134, -0.2473886],
                [-0.0776134, 0.3195244, 0.2279981],
                [-0.2473886, 0.2279981, 0.0730903],
            ]
        ),
        "location": np.array([-2.16141492636e6, -3.83469517889e6, 4.60035022664e6]),
    },
    "L1": {
        "response": np.array(
            [
                [0.4112809, 0.1402097, 0.2472943],
                [0.1402097, -0.1090056, -0.1816157],
                [0.2472943, -0.1816157, -0.3022755],
            ]
        ),
        "location": np.array([-74276.0447238, -5.49628371971e6, 3.22425701744e6]),
    },
    "V1": {
        "response": np.array(
            [
                [0.2438740, -0.0990838, -0.2325762],
                [-0.0990838, -0.4478258, 0.1878331],
                [-0.2325762, 0.1878331, 0.2039518],
            ]
        ),
        "location": np.array([4.54637409900e6, 8.42989697626e5, 4.37857696241e6]),
    },
}

_GPS_EPOCH_GMST = 18.697374558  # GMST (hours) at GPS 630720013 (J2000 epoch)
_GPS_J2000 = 630763213.0  # GPS seconds at J2000 (2000-01-01 11:58:55.816 UTC)


def gmst_rad(gps_time) -> np.ndarray:
    """Greenwich mean sidereal time (radians) from GPS seconds.

    IAU 1982 linear approximation; accurate to <1e-4 rad over the O3 era,
    well below the antenna patterns' astrophysical relevance here.
    """
    days = (np.asarray(gps_time, np.float64) - _GPS_J2000) / 86400.0
    gmst_hours = _GPS_EPOCH_GMST + 24.06570982441908 * days
    return (gmst_hours % 24.0) * np.pi / 12.0


def antenna_pattern(detector: str, ra, dec, psi, gps_time):
    """F+, Fx for (arrays of) sky location / polarization / time."""
    d = DETECTORS[detector]["response"]
    gha = gmst_rad(gps_time) - np.asarray(ra)  # Greenwich hour angle

    cosgha, singha = np.cos(gha), np.sin(gha)
    cosdec, sindec = np.cos(dec), np.sin(dec)
    cospsi, sinpsi = np.cos(psi), np.sin(psi)

    # wave-frame basis vectors (X, Y) in Earth-fixed coordinates
    x0 = -cospsi * singha - sinpsi * cosgha * sindec
    x1 = -cospsi * cosgha + sinpsi * singha * sindec
    x2 = sinpsi * cosdec
    y0 = sinpsi * singha - cospsi * cosgha * sindec
    y1 = sinpsi * cosgha + cospsi * singha * sindec
    y2 = cospsi * cosdec
    x = np.stack([x0, x1, x2], axis=-1)
    y = np.stack([y0, y1, y2], axis=-1)

    dx = x @ d
    fplus = np.sum(x * dx, axis=-1) - np.einsum("...i,ij,...j->...", y, d, y)
    fcross = 2.0 * np.einsum("...i,ij,...j->...", x, d, y)
    return fplus, fcross


def time_delay_from_earth_center(detector: str, ra, dec, gps_time):
    """Arrival-time delay (s) at the detector relative to the geocenter."""
    loc = DETECTORS[detector]["location"]
    gha = gmst_rad(gps_time) - np.asarray(ra)
    cosdec = np.cos(dec)
    # unit vector TOWARD the source
    n = np.stack([cosdec * np.cos(gha), -cosdec * np.sin(gha), np.sin(dec) * np.ones_like(np.asarray(gha))], axis=-1)
    return -(n @ loc) / C_SI


def project_wave(detector: str, hplus, hcross, ra, dec, psi, gps_time):
    """Project plus/cross polarizations onto the detector (no time shift)."""
    fp, fc = antenna_pattern(detector, ra, dec, psi, gps_time)
    return fp[..., None] * np.asarray(hplus) + fc[..., None] * np.asarray(hcross)
