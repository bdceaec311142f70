"""Minimal length-unit conversions for the scalebar.

A pinned copy of ``topsy_tpu/units.py``.

The reference leans on pynbody's unit system (reference:
src/topsy/scalebar.py:27-29); here the handful of length units the scalebar
needs are implemented directly so pynbody stays optional.  If an unknown unit
string appears and pynbody is installed, it is used as a fallback parser.
"""

from __future__ import annotations

import logging

logger = logging.getLogger(__name__)

_KM = 1.0
_AU = 1.495978707e8          # km
_PC = 3.0856775814913673e13  # km

LENGTH_UNITS_KM = {
    "m": 1e-3,
    "cm": 1e-5,
    "km": _KM,
    "au": _AU,
    "pc": _PC,
    "kpc": 1e3 * _PC,
    "Mpc": 1e6 * _PC,
    "Gpc": 1e9 * _PC,
}


def unit_in_units(unit: str, base: str) -> float:
    """Value of 1 ``unit`` expressed in ``base`` units."""
    u = _to_km(unit)
    b = _to_km(base)
    return u / b


def _to_km(unit: str) -> float:
    unit = unit.strip()
    if unit in LENGTH_UNITS_KM:
        return LENGTH_UNITS_KM[unit]
    # scaled forms like "3.085678e+19 m" or "kpc a" (comoving); try pynbody,
    # else parse the leading float/unit pair
    try:
        import pynbody.units as punits
        return float(punits.Unit(unit).in_units("km"))
    except Exception:
        pass
    parts = unit.split()
    try:
        if len(parts) == 2:
            return float(parts[0]) * _to_km(parts[1])
        return float(unit)  # bare number of km
    except ValueError:
        logger.warning("Unknown length unit %r; assuming kpc", unit)
        return LENGTH_UNITS_KM["kpc"]
