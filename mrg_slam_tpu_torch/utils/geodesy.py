"""Geodetic conversions: WGS84 -> UTM and local ENU.

Counterpart of the JAX package's utils/geodesy.py, the same plain Python
and numpy. Replaces GeographicLib/geodesy (gps_processor.cpp:4-5,
141-168): UTM via the standard Karney/Krüger series (sub-millimeter
within a zone), ENU via ECEF with a first-fix origin.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np

# WGS84
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)
_K0 = 0.9996
_E = math.sqrt(_E2)


def utm_zone(lat: float, lon: float) -> int:
    return int((lon + 180.0) // 6.0) + 1


def latlon_to_utm(lat: float, lon: float,
                  zone: Optional[int] = None) -> Tuple[float, float, int]:
    """-> (easting, northing, zone). Transverse-Mercator series (Krüger)."""
    z = zone if zone is not None else utm_zone(lat, lon)
    lon0 = math.radians((z - 1) * 6 - 180 + 3)
    phi = math.radians(lat)
    lam = math.radians(lon) - lon0

    n = _F / (2 - _F)
    A1 = _A / (1 + n) * (1 + n**2 / 4 + n**4 / 64)
    alpha = [
        n / 2 - 2 * n**2 / 3 + 5 * n**3 / 16,
        13 * n**2 / 48 - 3 * n**3 / 5,
        61 * n**3 / 240,
    ]
    t = math.sinh(math.atanh(math.sin(phi))
                  - (2 * math.sqrt(n) / (1 + n))
                  * math.atanh((2 * math.sqrt(n) / (1 + n)) * math.sin(phi)))
    xi = math.atan2(t, math.cos(lam))
    eta = math.atanh(math.sin(lam) / math.sqrt(1 + t * t))
    x = xi
    y = eta
    for j, a in enumerate(alpha, start=1):
        x += a * math.sin(2 * j * xi) * math.cosh(2 * j * eta)
        y += a * math.cos(2 * j * xi) * math.sinh(2 * j * eta)
    easting = _K0 * A1 * y + 500000.0
    northing = _K0 * A1 * x
    if lat < 0:
        northing += 10000000.0
    return easting, northing, z


def geodetic_to_ecef(lat: float, lon: float, h: float) -> np.ndarray:
    phi, lam = math.radians(lat), math.radians(lon)
    sp, cp = math.sin(phi), math.cos(phi)
    sl, cl = math.sin(lam), math.cos(lam)
    N = _A / math.sqrt(1 - _E2 * sp * sp)
    return np.asarray([(N + h) * cp * cl, (N + h) * cp * sl,
                       (N * (1 - _E2) + h) * sp])


class LocalCartesian:
    """GeographicLib::LocalCartesian equivalent: ENU around an origin."""

    def __init__(self, lat0: float, lon0: float, h0: float = 0.0):
        self.origin_geodetic = (lat0, lon0, h0)
        self._ecef0 = geodetic_to_ecef(lat0, lon0, h0)
        phi, lam = math.radians(lat0), math.radians(lon0)
        sp, cp = math.sin(phi), math.cos(phi)
        sl, cl = math.sin(lam), math.cos(lam)
        self._R = np.asarray([
            [-sl, cl, 0.0],
            [-sp * cl, -sp * sl, cp],
            [cp * cl, cp * sl, sp],
        ])

    def forward(self, lat: float, lon: float, h: float = 0.0) -> np.ndarray:
        """-> ENU [east, north, up]."""
        return self._R @ (geodetic_to_ecef(lat, lon, h) - self._ecef0)
