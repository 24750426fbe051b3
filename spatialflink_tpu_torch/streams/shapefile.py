"""ESRI shapefile reader and writer (``spatialStreams/
ShapeFileInputFormat.java:1-253``), as in the JAX package's
``streams/shapefile.py``.

The binary .shp format for bounded streams: a 100-byte header (file code
9994 big-endian, version 1000 little-endian, shape type), then records of
(record number BE, content length BE in 16-bit words, shape type LE,
shape data LE). Shape types 1 = Point, 3 = PolyLine, 5 = Polygon and
8 = MultiPoint; null shapes (0) are skipped. Polygon rings are split into
exteriors and holes by winding (the shapefile spec: clockwise =
exterior), and the writer orients them so.
"""

from __future__ import annotations

import struct
from typing import Iterator, List

import numpy as np

from spatialflink_tpu_torch.models.objects import (
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.ops.polygon import signed_area

SHAPE_NULL = 0
SHAPE_POINT = 1
SHAPE_POLYLINE = 3
SHAPE_POLYGON = 5
SHAPE_MULTIPOINT = 8

_FILE_CODE = 9994
_VERSION = 1000


class ShapefileError(ValueError):
    pass


def _read_parts_points(body: bytes, offset: int):
    """Common PolyLine/Polygon layout: bbox(32B) numParts numPoints
    parts[numParts] points[numPoints*16B]."""
    num_parts, num_points = struct.unpack_from("<ii", body, offset + 32)
    parts = list(struct.unpack_from(f"<{num_parts}i", body, offset + 40))
    pts_off = offset + 40 + 4 * num_parts
    pts = np.frombuffer(body, dtype="<f8", count=num_points * 2, offset=pts_off)
    pts = pts.reshape(num_points, 2).astype(np.float64)
    parts.append(num_points)
    return [pts[parts[i] : parts[i + 1]] for i in range(num_parts)]


def read_shapefile(path: str) -> Iterator[SpatialObject]:
    """Yield spatial objects from a .shp file; objID = record number."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 100:
        raise ShapefileError("truncated shapefile header")
    file_code = struct.unpack_from(">i", data, 0)[0]
    if file_code != _FILE_CODE:
        raise ShapefileError(f"bad file code {file_code} (expected {_FILE_CODE})")
    version, shape_type = struct.unpack_from("<ii", data, 28)
    if version != _VERSION:
        raise ShapefileError(f"unsupported shapefile version {version}")

    pos = 100
    while pos + 8 <= len(data):
        rec_no, content_len = struct.unpack_from(">ii", data, pos)
        body_start = pos + 8
        body_len = content_len * 2  # 16-bit words → bytes
        pos = body_start + body_len
        if body_start + 4 > len(data):
            break
        rec_type = struct.unpack_from("<i", data, body_start)[0]
        oid = str(rec_no)
        if rec_type == SHAPE_NULL:
            continue
        if rec_type == SHAPE_POINT:
            x, y = struct.unpack_from("<dd", data, body_start + 4)
            yield Point(obj_id=oid, x=x, y=y)
        elif rec_type == SHAPE_MULTIPOINT:
            num_points = struct.unpack_from("<i", data, body_start + 36)[0]
            pts = np.frombuffer(
                data, dtype="<f8", count=num_points * 2, offset=body_start + 40
            ).reshape(num_points, 2)
            yield MultiPoint(obj_id=oid, coords=pts.astype(np.float64))
        elif rec_type == SHAPE_POLYLINE:
            parts = _read_parts_points(data, body_start + 4)
            if len(parts) == 1:
                yield LineString(obj_id=oid, coords=parts[0])
            else:
                yield MultiLineString(obj_id=oid, parts=parts)
        elif rec_type == SHAPE_POLYGON:
            parts = _read_parts_points(data, body_start + 4)
            # Group rings: clockwise (negative signed area) = exterior
            # starts a new polygon; counter-clockwise rings are holes of
            # the current polygon.
            polys: List[List[np.ndarray]] = []
            for ring in parts:
                if signed_area(ring) <= 0 or not polys:
                    polys.append([ring])
                else:
                    polys[-1].append(ring)
            if len(polys) == 1:
                yield Polygon(obj_id=oid, rings=polys[0])
            else:
                yield MultiPolygon.from_polygons(polys, obj_id=oid)
        else:
            raise ShapefileError(f"unsupported shape type {rec_type}")


def write_shapefile(path: str, objects: List[SpatialObject]) -> None:
    """Minimal .shp writer (testing + egress parity). Points, polylines,
    polygons, multipoints."""
    records = []
    shape_type = None
    for i, obj in enumerate(objects, start=1):
        if isinstance(obj, Point):
            st = SHAPE_POINT
            body = struct.pack("<idd", st, obj.x, obj.y)
        elif isinstance(obj, MultiPoint):
            st = SHAPE_MULTIPOINT
            pts = np.asarray(obj.coords, "<f8")
            bbox = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
            body = struct.pack("<i4di", st, *bbox, len(pts)) + pts.tobytes()
        elif isinstance(obj, (Polygon, LineString)):
            st = SHAPE_POLYGON if isinstance(obj, Polygon) else SHAPE_POLYLINE
            if isinstance(obj, MultiLineString):
                parts = obj.parts
            elif isinstance(obj, Polygon):
                # Spec winding: exterior rings clockwise, holes
                # counter-clockwise. For a plain Polygon, rings[0] is the
                # exterior; a MultiPolygon's ring list alternates via parts
                # (each member's first ring exterior).
                exterior_idx = set()
                if isinstance(obj, MultiPolygon) and obj.parts:
                    i = 0
                    for n_rings in obj.parts:
                        exterior_idx.add(i)
                        i += n_rings
                else:
                    exterior_idx.add(0)
                parts = []
                for ri, r in enumerate(obj.rings):
                    r = np.asarray(r, float)
                    if not np.array_equal(r[0], r[-1]):
                        r = np.vstack([r, r[:1]])
                    want_cw = ri in exterior_idx
                    is_cw = signed_area(r) < 0
                    parts.append(r if is_cw == want_cw else r[::-1])
            else:
                parts = [obj.coords]
            allp = np.vstack(parts)
            bbox = (allp[:, 0].min(), allp[:, 1].min(), allp[:, 0].max(), allp[:, 1].max())
            offsets = np.cumsum([0] + [len(p) for p in parts[:-1]]).astype("<i4")
            pts = np.vstack(parts).astype("<f8")
            body = (
                struct.pack("<i4dii", st, *bbox, len(parts), len(pts))
                + offsets.tobytes()
                + pts.tobytes()
            )
        else:
            raise ShapefileError(f"cannot write {type(obj).__name__}")
        shape_type = shape_type or st
        content_len = len(body) // 2
        records.append(struct.pack(">ii", i, content_len) + body)

    payload = b"".join(records)
    total_words = (100 + len(payload)) // 2
    header = struct.pack(">i", _FILE_CODE) + b"\x00" * 20 + struct.pack(">i", total_words)
    header += struct.pack("<ii", _VERSION, shape_type or SHAPE_NULL)
    header += struct.pack("<8d", 0, 0, 0, 0, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header + payload)
