"""Injection-population config ingestion (counterpart of
``gwkit/data/population.py``, kept as its own copy: host code).

The reference drives challenge populations through
``pycbc_create_injections --config ds{N}.ini``
(MLGWSC-1/generate_data.py:772-790); the ini files themselves live in the
public gwastro/ml-mock-data-challenge-1 repo. gwkit's four built-in
populations (:func:`gwkit_torch.data.generate.challenge_distribution`) cover the
shipped datasets, and this module opens the same *custom-population* door:
:func:`load_population` reads either

* a **pycbc_create_injections-style ini** — ``[static_params]``
  (approximant, f_lower) plus ``[prior-<param>]`` sections with the
  challenge's field names (``min-mass1``/``max-mass1``,
  ``min-chirp_distance``/``max-chirp_distance``, aligned
  ``min-spin1z``/``max-spin1z`` or isotropic ``max-spin1_a`` +
  ``uniform_solidangle`` angle sections), or
* a **JSON dict** of :class:`gwkit_torch.data.waveforms.SourceDistribution`
  fields (``{"mass_min": 5, "mass_max": 20, ...}``),

and returns the ``SourceDistribution`` it describes, so "ds2 but masses
U(5,20)" is a config file, not a source edit:

    python -m gwkit_torch.cli.generate_data challenge --population my_pop.ini ...
"""
from __future__ import annotations

import configparser
import dataclasses
import json
import logging
import os
from typing import Dict

from gwkit_torch.data.waveforms import SourceDistribution

#: lalsuite approximant names -> gwkit waveform models
_APPROXIMANTS: Dict[str, str] = {
    "taylorf2": "taylorf2",
    "imrphenomd": "imrphenomd",
    "imrphenomhm": "imrphenomhm",
    "imrphenompv2": "imrphenomp",
    "imrphenomp": "imrphenomp",
    "imrphenomxphm": "imrphenomxphm",
    "imrphenomxphm-twospin": "imrphenomxphm-twospin",
    "imrphenomp-twospin": "imrphenomp-twospin",
}

#: angle parameters gwkit always samples isotropically — their prior
#: sections are accepted (and checked for the expected prior family) but
#: carry no tunable knobs in SourceDistribution
_ISOTROPIC_ANGLES = frozenset({
    "ra+dec", "ra", "dec", "inclination", "coa_phase", "polarization",
    "spin1_polar+spin1_azimuthal", "spin2_polar+spin2_azimuthal",
})


def _json_population(path: str) -> SourceDistribution:
    with open(path) as f:
        cfg = json.load(f)
    fields = {f.name for f in dataclasses.fields(SourceDistribution)}
    unknown = set(cfg) - fields
    if unknown:
        raise ValueError(
            f"unknown SourceDistribution fields in {path}: {sorted(unknown)}; "
            f"valid fields: {sorted(fields)}")
    if "chirp_distance_range" in cfg:
        cfg["chirp_distance_range"] = tuple(cfg["chirp_distance_range"])
    if "approximant" in cfg:
        cfg["approximant"] = normalize_approximant(cfg["approximant"])
    return SourceDistribution(**cfg)


def normalize_approximant(name: str) -> str:
    key = name.strip().lower()
    if key not in _APPROXIMANTS:
        raise ValueError(
            f"unsupported approximant {name!r}; gwkit models: "
            f"{sorted(set(_APPROXIMANTS.values()))}")
    return _APPROXIMANTS[key]


def _prior_bounds(sec: configparser.SectionProxy, param: str):
    return float(sec[f"min-{param}"]), float(sec[f"max-{param}"])


def _ini_population(path: str) -> SourceDistribution:
    cp = configparser.ConfigParser()
    with open(path) as f:
        cp.read_file(f, source=path)

    kwargs: dict = {}
    if cp.has_section("static_params"):
        static = cp["static_params"]
        if "approximant" in static:
            kwargs["approximant"] = normalize_approximant(static["approximant"])
        if "f_lower" in static:
            kwargs["f_lower"] = float(static["f_lower"])

    mass_lo, mass_hi = [], []
    spin_max = 0.0
    isotropic = False
    for section in cp.sections():
        if not section.startswith("prior-"):
            continue
        param = section[len("prior-"):]
        sec = cp[section]
        prior = sec.get("name", "uniform").strip().lower()
        if param in ("mass1", "mass2"):
            if prior != "uniform":
                raise ValueError(f"[{section}]: only uniform mass priors are supported")
            lo, hi = _prior_bounds(sec, param)
            mass_lo.append(lo)
            mass_hi.append(hi)
        elif param == "chirp_distance":
            if prior != "uniform":
                raise ValueError(f"[{section}]: only uniform chirp_distance is supported")
            kwargs["chirp_distance_range"] = _prior_bounds(sec, param)
        elif param in ("spin1z", "spin2z"):
            if prior != "uniform":
                raise ValueError(f"[{section}]: only uniform aligned-spin priors are supported")
            lo, hi = _prior_bounds(sec, param)
            spin_max = max(spin_max, abs(lo), abs(hi))
        elif param in ("spin1_a", "spin2_a"):
            if prior != "uniform":
                raise ValueError(f"[{section}]: only uniform spin-magnitude priors are supported")
            lo, hi = _prior_bounds(sec, param)
            if lo != 0.0:
                raise ValueError(
                    f"[{section}]: gwkit samples spin magnitude U(0, max); "
                    f"min-{param} must be 0")
            spin_max = max(spin_max, hi)
            isotropic = True
        elif param in _ISOTROPIC_ANGLES:
            # always sampled isotropically by SourceDistribution.sample;
            # accept the challenge's uniform/solid-angle/sky declarations
            if prior not in ("uniform", "uniform_angle", "cos_angle",
                             "sin_angle", "uniform_solidangle", "uniform_sky"):
                raise ValueError(
                    f"[{section}]: prior family {prior!r} differs from the "
                    f"isotropic sampling gwkit applies to {param}")
        elif param == "tc":
            logging.info("[%s]: injection times come from the segment grid "
                         "(make_injection_table); section ignored", section)
        else:
            raise ValueError(
                f"[{section}]: parameter {param!r} is not supported; "
                "supported priors: mass1/mass2, chirp_distance, "
                "spin1z/spin2z, spin1_a/spin2_a (+solid-angle sections), "
                "isotropic sky/orientation angles")
    if mass_lo:
        kwargs["mass_min"] = min(mass_lo)
        kwargs["mass_max"] = max(mass_hi)
    if spin_max > 0.0:
        kwargs["spin_max"] = spin_max
        kwargs["isotropic_spins"] = isotropic
        if isotropic and "approximant" not in kwargs:
            # the challenge pairs isotropic spins with a precessing model
            kwargs["approximant"] = "imrphenomxphm"
    return SourceDistribution(**kwargs)


def load_population(path: str) -> SourceDistribution:
    """Read a population config (.ini in pycbc_create_injections layout, or
    .json of SourceDistribution fields) into a SourceDistribution."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".json":
        return _json_population(path)
    if ext in (".ini", ".cfg"):
        return _ini_population(path)
    raise ValueError(f"population config must be .ini or .json, got {path!r}")
