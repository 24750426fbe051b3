"""SNCB railway domain: event types, CRS enrichment, zone loading.

Counterparts of ``GeoFlink/sncb/common/``: GpsEvent (GpsEvent.java:3-23),
EnrichedEvent (EnrichedEvent.java:5-17), CRSUtils (CRSUtils.java:19-56),
CSVToGpsEventMapFunction (CSVToGpsEventMapFunction.java:13-31),
PolygonLoader (PolygonLoader.java:24-138) — plus the ``MnGpsEvent`` type the
reference's com.mn layer imports but never defines (see SURVEY.md §2.5).

Buffered zones: the reference buffers metric polygons by N meters with JTS
``buffer()`` and tests PreparedGeometry containment. A point is inside
``poly.buffer(r)`` iff it is inside ``poly`` or within ``r`` of its
boundary, so ``BufferedZone`` stores the metric polygon and the radius,
and ``contains_any_zone`` tests a whole batch on the card: float64
point→polygon distances (``ops/polygon.py:point_polygon_distance``)
against each zone's radius, then the any over zones. Float64 always:
EPSG:25831 northings reach ~5.6e6 m, where a float32 ulp is 0.5 m.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.ops.polygon import (
    BLOCK_LANES,
    BLOCK_LANES_CPU,
    pack_rings,
    point_polygon_distance,
)
from spatialflink_tpu_torch.streams.serde import parse_wkt
from spatialflink_tpu_torch.utils.crs import wgs84_to_epsg25831

RESOURCE_DIR = os.path.join(os.path.dirname(__file__), "resources")


@dataclass
class GpsEvent:
    """deviceId, lon, lat, ts(ms), gpsSpeed(m/s), brake pressures FA/FF (bar)."""

    device_id: str = ""
    lon: float = 0.0
    lat: float = 0.0
    ts: int = 0
    gps_speed: Optional[float] = None
    fa: Optional[float] = None
    ff: Optional[float] = None

    # Window assembler compatibility.
    @property
    def timestamp(self) -> int:
        return self.ts

    @property
    def obj_id(self) -> str:
        return self.device_id


# The type com.mn imports but the reference never defines
# (InstrumentedMN_Q1.java:3; usage at :67-72,128-133).
MnGpsEvent = GpsEvent


@dataclass
class EnrichedEvent:
    """raw + WGS84 coords + metric (EPSG:25831) coords."""

    raw: GpsEvent
    x_wgs84: float = 0.0
    y_wgs84: float = 0.0
    x_metric: float = 0.0
    y_metric: float = 0.0

    @property
    def timestamp(self) -> int:
        return self.raw.ts


def csv_to_gps_event(line: str, delimiter: str = ",") -> GpsEvent:
    """14-column CSV schema: ts(0, already ms in the data replay), deviceId(1),
    PCFA(3), PCFF(4), speed(11), lat(12), lon(13)
    (CSVToGpsEventMapFunction.java:13-31; unparseable numerics → 0 like the
    reference's catch-all)."""
    f = line.split(delimiter)

    def flt(i):
        try:
            return float(f[i].strip())
        except (ValueError, IndexError):
            return 0.0

    def lng(i):
        try:
            return int(f[i].strip())
        except (ValueError, IndexError):
            return 0

    return GpsEvent(
        device_id=f[1].strip() if len(f) > 1 else "",
        lon=flt(13),
        lat=flt(12),
        ts=lng(0),
        gps_speed=flt(11),
        fa=flt(3),
        ff=flt(4),
    )


class CRSUtils:
    """EPSG:4326 → EPSG:25831 enrichment (CRSUtils.java:19-56)."""

    @staticmethod
    def to_metric(lon, lat):
        return wgs84_to_epsg25831(lon, lat)

    @staticmethod
    def enrich(ev: GpsEvent) -> EnrichedEvent:
        e, n = wgs84_to_epsg25831(ev.lon, ev.lat)
        return EnrichedEvent(
            raw=ev, x_wgs84=ev.lon, y_wgs84=ev.lat,
            x_metric=float(e), y_metric=float(n),
        )

    @staticmethod
    def enrich_batch(events: Sequence[GpsEvent]) -> np.ndarray:
        """(N, 2) metric coordinates for a batch (vectorized transform)."""
        lon = np.array([e.lon for e in events])
        lat = np.array([e.lat for e in events])
        east, north = wgs84_to_epsg25831(lon, lat)
        return np.stack([east, north], axis=1)


@dataclass
class BufferedZone:
    """A metric-CRS polygon with a buffer radius.

    Containment test (≡ PreparedGeometry.contains over the buffered
    geometry): inside the polygon OR within ``buffer_m`` of its boundary.
    ``contains_batch`` tests a metric point batch on ``device``.
    """

    rings_metric: List[np.ndarray]
    buffer_m: float = 0.0
    name: str = ""

    def packed(self, pad_to=None):
        return pack_rings(self.rings_metric, pad_to=pad_to)

    def contains_batch(self, xy_metric: np.ndarray,
                       device="cuda") -> np.ndarray:
        return contains_any_zone([self], xy_metric, device=device)


def _pack_zones(zones: Sequence[BufferedZone]):
    """Every zone's packed rings stacked to one vertex count: (Z, V, 2)
    float64 vertices, (Z, V - 1) edge flags, and the Z buffer radii."""
    vmax = max(sum(len(r) + 1 for r in z.rings_metric) for z in zones)
    verts = np.zeros((len(zones), vmax, 2))
    evs = np.zeros((len(zones), vmax - 1), bool)
    for i, z in enumerate(zones):
        verts[i], evs[i] = z.packed(pad_to=vmax)
    return verts, evs, [float(z.buffer_m) for z in zones]


def _zone_hit_kernel(pts: torch.Tensor, verts: torch.Tensor,
                     evs: torch.Tensor, bufs: Sequence[float]
                     ) -> torch.Tensor:
    """(N,) bool on the points' device: within ``bufs[z]`` of zone z's
    polygon (0 inside it) for any z, in float64. The points go through in
    blocks of at most ``BLOCK_LANES`` point × edge lanes
    (``BLOCK_LANES_CPU`` on the CPU)."""
    n = len(pts)
    hit = torch.zeros(n, dtype=torch.bool, device=pts.device)
    lanes = BLOCK_LANES if pts.is_cuda else BLOCK_LANES_CPU
    step = max(1, lanes // (verts.shape[1] - 1))
    for i0 in range(0, n, step):
        p = pts[i0:i0 + step]
        for z, buf in enumerate(bufs):
            hit[i0:i0 + step] |= (
                point_polygon_distance(p, verts[z], evs[z]) <= buf)
    return hit


def contains_any_zone(zones: Sequence[BufferedZone], xy_metric: np.ndarray,
                      device="cuda") -> np.ndarray:
    """(N,) host bool: point within any buffered zone, computed on
    ``device`` in float64 (the card unless the caller asks for the CPU;
    a missing card raises)."""
    dev = resolve_device(device)
    if not zones or not len(xy_metric):
        return np.zeros(len(xy_metric), bool)
    verts, evs, bufs = _pack_zones(zones)
    pts = torch.from_numpy(np.asarray(xy_metric, np.float64)).to(dev)
    hit = _zone_hit_kernel(pts, torch.from_numpy(verts).to(dev),
                           torch.from_numpy(evs).to(dev), bufs)
    return hit.cpu().numpy()


def contains_any_zone_np(zones: Sequence[BufferedZone],
                         xy_metric: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`contains_any_zone`, the host route a caller
    picks with ``backend="numpy"`` (the JAX package's composed DAG fails
    over to it). Same semantics: inside any zone's polygon OR within its
    ``buffer_m`` of the boundary; results match the device path to float
    ulps."""
    if not zones or not len(xy_metric):
        return np.zeros(len(xy_metric), bool)
    pts = np.asarray(xy_metric, np.float64)
    hit = np.zeros(len(pts), bool)
    for z in zones:
        verts, ev = z.packed()
        x, y = pts[:, 0:1], pts[:, 1:2]
        x1, y1 = verts[:-1, 0][None, :], verts[:-1, 1][None, :]
        x2, y2 = verts[1:, 0][None, :], verts[1:, 1][None, :]
        # Even-odd ray cast (ops/polygon.py:points_in_polygon, host form).
        spans = (y1 > y) != (y2 > y)
        dy = y2 - y1
        t = np.where(dy != 0, (y - y1) / np.where(dy != 0, dy, 1.0), 0.0)
        inside = (
            np.sum(spans & (x < x1 + t * (x2 - x1)) & ev[None, :], axis=1)
            % 2 == 1
        )
        # Min distance to any valid edge (segment projection clamp).
        exy = np.stack([x2 - x1, y2 - y1], axis=-1)[0]  # (E, 2)
        p1 = verts[:-1]  # (E, 2)
        seg_len2 = np.maximum(np.sum(exy * exy, axis=-1), 1e-300)
        rel = pts[:, None, :] - p1[None, :, :]  # (N, E, 2)
        tt = np.clip(np.sum(rel * exy[None, :, :], axis=-1)
                     / seg_len2[None, :], 0.0, 1.0)
        near = p1[None, :, :] + tt[..., None] * exy[None, :, :]
        d2 = np.sum((pts[:, None, :] - near) ** 2, axis=-1)
        d2 = np.where(ev[None, :], d2, np.inf)
        hit |= inside | (np.sqrt(np.min(d2, axis=1)) <= z.buffer_m)
    return hit


class PolygonLoader:
    """Load GeoJSON FeatureCollections / WKT files, reproject rings to
    EPSG:25831, attach a buffer radius (PolygonLoader.java:24-138)."""

    @staticmethod
    def _reproject_rings(rings: Sequence[np.ndarray]) -> List[np.ndarray]:
        out = []
        for r in rings:
            r = np.asarray(r, float)
            e, n = wgs84_to_epsg25831(r[:, 0], r[:, 1])
            out.append(np.stack([e, n], axis=1))
        return out

    @classmethod
    def load_geojson_buffered(cls, path: str, buffer_m: float) -> List[BufferedZone]:
        with open(cls._resolve(path)) as f:
            obj = json.load(f)
        zones: List[BufferedZone] = []
        feats = (
            obj["features"] if obj.get("type") == "FeatureCollection"
            else [obj] if obj.get("type") == "Feature" else [{"geometry": obj}]
        )
        for feat in feats:
            geom = feat.get("geometry", feat)
            name = (feat.get("properties") or {}).get("name", "")
            gtype = geom.get("type")
            if gtype == "Polygon":
                ring_sets = [geom["coordinates"]]
            elif gtype == "MultiPolygon":
                ring_sets = geom["coordinates"]
            else:
                continue
            for rings in ring_sets:
                zones.append(
                    BufferedZone(
                        rings_metric=cls._reproject_rings(
                            [np.asarray(r, float) for r in rings]
                        ),
                        buffer_m=buffer_m,
                        name=name,
                    )
                )
        return zones

    @classmethod
    def load_wkt_buffered(cls, path: str, buffer_m: float) -> List[BufferedZone]:
        with open(cls._resolve(path)) as f:
            text = f.read().strip()
        obj = parse_wkt(text)
        polys = obj.polygons() if hasattr(obj, "polygons") else [obj]
        return [
            BufferedZone(
                rings_metric=cls._reproject_rings(p.rings), buffer_m=buffer_m
            )
            for p in polys
        ]

    @staticmethod
    def _resolve(path: str) -> str:
        """Accept absolute paths or names of bundled resources."""
        if os.path.exists(path):
            return path
        cand = os.path.join(RESOURCE_DIR, path)
        if os.path.exists(cand):
            return cand
        raise FileNotFoundError(path)


def gps_events_to_points(events: Sequence[GpsEvent]) -> List[Point]:
    """GpsEvent → spatial Point on WGS84 coords (the per-query map functions
    in Q1..Q5, e.g. Q1_HighRisk.java:39-49)."""
    return [
        Point(obj_id=e.device_id, timestamp=e.ts, x=e.lon, y=e.lat) for e in events
    ]
