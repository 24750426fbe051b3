"""Coordinate reference system transforms: EPSG:4326 ⇄ EPSG:25831.

The reference projects WGS84 lon/lat into ETRS89 / UTM zone 31N metres
with proj4j (``sncb/common/CRSUtils.java:19-56``). As in the JAX
package's ``utils/crs.py``, the transverse Mercator projection is the
Krüger n-series to 6th order (Karney 2011), which agrees with proj to
below a millimetre over the UTM zone. Every function takes ``xp``: numpy
(the default) on host arrays, or ``torch`` on tensors of any device, so
the same operations run vectorised on the card; float64 gives the
metre-level results the SNCB queries need.

EPSG:25831: ETRS89 on GRS80, central meridian 3°E, k0 = 0.9996, false
easting 500 000 m. ETRS89 is taken as WGS84 (no datum shift, as proj4j).
"""

from __future__ import annotations

import numpy as np

# GRS80 ellipsoid (ETRS89; WGS84 differs by <0.1 mm in flattening).
_A = 6378137.0
_F = 1.0 / 298.257222101
_N = _F / (2.0 - _F)
_E = float(np.sqrt(_F * (2.0 - _F)))  # first eccentricity

# Rectifying radius A and Krüger series coefficients to n^6
# (standard Karney 2011 series).
_n = _N
_RECT_A = _A / (1 + _n) * (1 + _n**2 / 4 + _n**4 / 64 + _n**6 / 256)
_ALPHA = (
    _n / 2 - 2 * _n**2 / 3 + 5 * _n**3 / 16 + 41 * _n**4 / 180
    - 127 * _n**5 / 288 + 7891 * _n**6 / 37800,
    13 * _n**2 / 48 - 3 * _n**3 / 5 + 557 * _n**4 / 1440 + 281 * _n**5 / 630
    - 1983433 * _n**6 / 1935360,
    61 * _n**3 / 240 - 103 * _n**4 / 140 + 15061 * _n**5 / 26880
    + 167603 * _n**6 / 181440,
    49561 * _n**4 / 161280 - 179 * _n**5 / 168 + 6601661 * _n**6 / 7257600,
    34729 * _n**5 / 80640 - 3418889 * _n**6 / 1995840,
    212378941 * _n**6 / 319334400,
)
_BETA = (
    _n / 2 - 2 * _n**2 / 3 + 37 * _n**3 / 96 - _n**4 / 360 - 81 * _n**5 / 512
    + 96199 * _n**6 / 604800,
    _n**2 / 48 + _n**3 / 15 - 437 * _n**4 / 1440 + 46 * _n**5 / 105
    - 1118711 * _n**6 / 3870720,
    17 * _n**3 / 480 - 37 * _n**4 / 840 - 209 * _n**5 / 4480
    + 5569 * _n**6 / 90720,
    4397 * _n**4 / 161280 - 11 * _n**5 / 504 - 830251 * _n**6 / 7257600,
    4583 * _n**5 / 161280 - 108847 * _n**6 / 3991680,
    20648693 * _n**6 / 638668800,
)

K0 = 0.9996
FALSE_EASTING = 500_000.0


def utm_forward(lon_deg, lat_deg, lon0_deg: float = 3.0, xp=np):
    """WGS84/ETRS89 lon, lat (degrees) → (easting, northing) meters.

    ``xp`` selects the array library: numpy by default, ``torch`` for
    tensors (on their device). The default lon0 = 3°E is UTM zone 31N
    (EPSG:25831).
    """
    lat = xp.deg2rad(lat_deg)
    lam = xp.deg2rad(lon_deg - lon0_deg)
    s = xp.sin(lat)
    # Conformal latitude.
    t = xp.sinh(xp.arctanh(s) - _E * xp.arctanh(_E * s))
    xi_p = xp.arctan2(t, xp.cos(lam))
    eta_p = xp.arcsinh(xp.sin(lam) / xp.sqrt(t * t + xp.cos(lam) ** 2))
    xi = xi_p
    eta = eta_p
    for j, a in enumerate(_ALPHA, start=1):
        xi = xi + a * xp.sin(2 * j * xi_p) * xp.cosh(2 * j * eta_p)
        eta = eta + a * xp.cos(2 * j * xi_p) * xp.sinh(2 * j * eta_p)
    easting = FALSE_EASTING + K0 * _RECT_A * eta
    northing = K0 * _RECT_A * xi
    return easting, northing


def utm_inverse(easting, northing, lon0_deg: float = 3.0, xp=np):
    """(easting, northing) meters → WGS84/ETRS89 lon, lat degrees."""
    xi = northing / (K0 * _RECT_A)
    eta = (easting - FALSE_EASTING) / (K0 * _RECT_A)
    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        xi_p = xi_p - b * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        eta_p = eta_p - b * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
    chi = xp.arcsin(xp.sin(xi_p) / xp.cosh(eta_p))  # conformal latitude
    lam = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
    # Conformal → geodetic latitude by fixed-point on sin(lat):
    # artanh(sin lat) = artanh(sin chi) + e·artanh(e·sin lat).
    psi0 = xp.arctanh(xp.sin(chi))
    s = xp.sin(chi)
    for _ in range(6):
        s = xp.tanh(psi0 + _E * xp.arctanh(_E * s))
    lat = xp.arcsin(xp.clip(s, -1.0, 1.0))
    return xp.rad2deg(lam) + lon0_deg, xp.rad2deg(lat)


def wgs84_to_epsg25831(lon_deg, lat_deg, xp=np):
    """The CRSUtils.toMetric transform (CRSUtils.java:40-46)."""
    return utm_forward(lon_deg, lat_deg, lon0_deg=3.0, xp=xp)


def epsg25831_to_wgs84(easting, northing, xp=np):
    """The inverse of ``wgs84_to_epsg25831``."""
    return utm_inverse(easting, northing, lon0_deg=3.0, xp=xp)
