"""Parity of the PyTorch port's CRS transforms (``utils/crs.py``) and
``haversine_distance`` with the JAX package's.

The same lon/lat points, made with numpy from a seed, go through both
packages in float64. Tolerances:
- the port with ``xp=np`` runs the JAX module's numpy code and is held
  EXACTLY equal to it;
- the port with ``xp=torch`` (on the CPU here), and
  ``haversine_distance``, are held to ``rtol=1e-12`` against the JAX
  package's numpy and ``jax.numpy`` runs (``tests/test_crs.py:89``):
  torch's and numpy's transcendental functions may round differently in
  the last bits;
- a forward/inverse round trip returns within 1e-11 degrees
  (``tests/test_crs.py:58``).
The JAX package's own ``tests/test_crs.py`` cases run against the port.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialflink_tpu.ops.distances import haversine_distance as j_hav
from spatialflink_tpu.utils import crs as jcrs

from spatialflink_tpu_torch.ops.distances import haversine_distance
from spatialflink_tpu_torch.utils import crs

RTOL = 1e-12


def _lonlat(seed, n=2000):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 8.0, n), rng.uniform(45.0, 55.0, n)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches(seed):
    lon, lat = _lonlat(seed)
    e_j, n_j = jcrs.wgs84_to_epsg25831(lon, lat)
    e_n, n_n = crs.wgs84_to_epsg25831(lon, lat)
    assert np.array_equal(e_n, e_j) and np.array_equal(n_n, n_j)
    e_t, n_t = crs.wgs84_to_epsg25831(torch.from_numpy(lon),
                                      torch.from_numpy(lat), xp=torch)
    assert e_t.dtype == torch.float64
    np.testing.assert_allclose(e_t.numpy(), e_j, rtol=RTOL)
    np.testing.assert_allclose(n_t.numpy(), n_j, rtol=RTOL)
    e_x, n_x = jcrs.wgs84_to_epsg25831(jnp.asarray(lon), jnp.asarray(lat),
                                       xp=jnp)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_x), rtol=RTOL)
    np.testing.assert_allclose(n_t.numpy(), np.asarray(n_x), rtol=RTOL)


@pytest.mark.parametrize("lon0", [3.0, -3.0, 9.0])
def test_inverse_matches_and_round_trips(lon0):
    lon, lat = _lonlat(int(lon0) + 10)
    lon = lon - 3.0 + lon0
    e, n = jcrs.utm_forward(lon, lat, lon0_deg=lon0)
    lo_j, la_j = jcrs.utm_inverse(e, n, lon0_deg=lon0)
    lo_n, la_n = crs.utm_inverse(e, n, lon0_deg=lon0)
    assert np.array_equal(lo_n, lo_j) and np.array_equal(la_n, la_j)
    et, nt = crs.utm_forward(torch.from_numpy(lon), torch.from_numpy(lat),
                             lon0_deg=lon0, xp=torch)
    lo_t, la_t = crs.utm_inverse(et, nt, lon0_deg=lon0, xp=torch)
    np.testing.assert_allclose(lo_t.numpy(), lo_j, rtol=RTOL)
    np.testing.assert_allclose(la_t.numpy(), la_j, rtol=RTOL)
    assert np.abs(lo_t.numpy() - lon).max() < 1e-11
    assert np.abs(la_t.numpy() - lat).max() < 1e-11
    lo_e, la_e = crs.epsg25831_to_wgs84(*crs.wgs84_to_epsg25831(lon, lat))
    assert np.abs(lo_e - lon).max() < 1e-11


def test_reference_cases_of_the_jax_tests():
    """tests/test_crs.py's anchors through the port."""
    e, n = crs.utm_forward(3.0, 0.0)
    assert e == pytest.approx(500_000.0, abs=1e-6)
    assert n == pytest.approx(0.0, abs=1e-6)
    _, n = crs.utm_forward(3.0, 45.0)
    assert n == pytest.approx(4_984_944.378 * 0.9996, abs=0.01)
    lam = math.radians(1.0)
    eta_p = math.asinh(math.tan(lam))
    eta = eta_p + sum(a * math.sinh(2 * j * eta_p)
                      for j, a in enumerate(crs._ALPHA, start=1))
    e, n = crs.utm_forward(4.0, 0.0)
    assert e == pytest.approx(crs.FALSE_EASTING + crs.K0 * crs._RECT_A * eta,
                              abs=1e-6)
    assert n == pytest.approx(0.0, abs=1e-9)
    e, n = crs.wgs84_to_epsg25831(4.357, 50.845)
    assert 590_000 < e < 600_000 and 5_630_000 < n < 5_640_000
    e0, n0 = crs.wgs84_to_epsg25831(4.36, 50.85)
    e1, n1 = crs.wgs84_to_epsg25831(4.36, 50.85 + 100.0 / 111_250.0)
    assert math.hypot(e1 - e0, n1 - n0) == pytest.approx(100.0, rel=2e-3)
    assert (crs._RECT_A, crs._ALPHA, crs._BETA, crs._E) == \
        (jcrs._RECT_A, jcrs._ALPHA, jcrs._BETA, float(jcrs._E))


@pytest.mark.parametrize("seed", [3, 4])
def test_haversine_matches(seed):
    rng = np.random.default_rng(seed)
    a = np.stack([rng.uniform(-180, 180, 3000), rng.uniform(-89, 89, 3000)],
                 axis=1)
    b = a + rng.normal(scale=[[1e-4, 1e-4]] * 3000) * \
        (rng.uniform(size=(3000, 1)) < 0.5) + \
        rng.uniform(-40, 40, (3000, 2)) * (rng.uniform(size=(3000, 1)) < 0.3)
    b[:, 1] = np.clip(b[:, 1], -90, 90)
    want = np.asarray(j_hav(jnp.asarray(a), jnp.asarray(b)))
    got = haversine_distance(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    got_r = haversine_distance(torch.from_numpy(a[:5]),
                               torch.from_numpy(b[:5]), radius=1.0)
    np.testing.assert_allclose(
        got_r.numpy(), np.asarray(j_hav(jnp.asarray(a[:5]),
                                        jnp.asarray(b[:5]), radius=1.0)),
        rtol=RTOL)


def test_haversine_reference_case_and_broadcast():
    """tests/test_distances.py:81 through the port, and broadcasting."""
    a = torch.tensor([4.3517, 50.8503], dtype=torch.float64)
    b = torch.tensor([4.4025, 51.2194], dtype=torch.float64)
    d = float(haversine_distance(a, b))
    rlat1, rlat2 = math.radians(50.8503), math.radians(51.2194)
    expect = math.acos(math.sin(rlat1) * math.sin(rlat2) + math.cos(rlat1)
                       * math.cos(rlat2) * math.cos(math.radians(0.0508))
                       ) * 6371008.7714
    assert d == pytest.approx(expect, rel=1e-6) and 40000 < d < 43000
    grid = haversine_distance(a[None, None, :], b.expand(3, 4, 2))
    assert grid.shape == (3, 4) and bool((grid == d).all())
    assert float(haversine_distance(a, a)) == 0.0
