"""GeoJSON / WKT / CSV / TSV serde: records to spatial objects and back.

Host-side parsers and emitters over the object model with the format
contracts of the reference's ``spatialStreams/Deserialization.java`` and
``Serialization.java``, copied from the JAX package's
``streams/serde.py`` so that both packages read and write the same
strings:
  - GeoJSON records arrive in the Kafka JSON envelope ``{"key":...,
    "value": {feature}}`` or as a bare feature or geometry
    (Deserialization.java:149-211); objID and timestamp come from
    configurable property names, the timestamp as a Java date format or
    epoch millis.
  - CSV/TSV schema = attribute positions [objID, timestamp, x, y]
    (Deserialization.java:291-325); quotes stripped, spaces around the
    delimiter tolerated. ``to_csv_point`` writes coordinates with
    ``repr``, so a CSV round trip is exact.
  - WKT records locate the geometry token anywhere in the line. ``to_wkt``
    writes coordinates with ``:g`` (six significant digits): a WKT round
    trip is lossy, as in the reference package.
"""

from __future__ import annotations

import json
import re
from datetime import datetime, timezone
from typing import List, Optional, Sequence, Union

import numpy as np

from spatialflink_tpu_torch.models.objects import (
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    SpatialObject,
)

# ---------------------------------------------------------------------------
# timestamps


def _java_date_format(fmt: str) -> str:
    """Java SimpleDateFormat → strftime for the tokens the reference's
    configs use (yyyy-MM-dd HH:mm:ss)."""
    return (
        fmt.replace("yyyy", "%Y")
        .replace("MM", "%m")
        .replace("dd", "%d")
        .replace("HH", "%H")
        .replace("mm", "%M")
        .replace("ss", "%S")
    )


def parse_timestamp(value, date_format: Optional[str], strict: bool = False) -> int:
    """Property value → epoch ms. ``date_format`` uses Java SimpleDateFormat
    conventions from the config (e.g. "yyyy-MM-dd HH:mm:ss"); None/"null"
    means the value is already epoch millis.

    Default behavior is reference parity: unparseable timestamps become 0
    (the reference swallows ParseException, Deserialization.java:190-196).
    ``strict=True`` raises instead, which makes the sources drop the record
    (they skip lines that raise ValueError).
    """
    if value is None:
        if strict:
            raise ValueError("missing timestamp")
        return 0
    if date_format and date_format != "null":
        try:
            dt = datetime.strptime(str(value), _java_date_format(date_format))
            return int(dt.replace(tzinfo=timezone.utc).timestamp() * 1000)
        except ValueError:
            if strict:
                raise
            return 0
    try:
        return int(value)
    except (TypeError, ValueError):
        if strict:
            raise ValueError(f"unparseable timestamp: {value!r}")
        return 0


def format_timestamp(ts_ms: int, date_format: Optional[str]) -> str:
    if date_format and date_format != "null":
        return datetime.fromtimestamp(ts_ms / 1000, tz=timezone.utc).strftime(
            _java_date_format(date_format)
        )
    return str(ts_ms)


# ---------------------------------------------------------------------------
# GeoJSON


def _geometry_from_geojson(geom: dict, obj_id=None, ts=0) -> SpatialObject:
    gtype = geom.get("type", "")
    coords = geom.get("coordinates")
    if gtype == "Point":
        return Point(obj_id=obj_id, timestamp=ts, x=coords[0], y=coords[1])
    if gtype == "MultiPoint":
        return MultiPoint(obj_id=obj_id, timestamp=ts, coords=np.asarray(coords, float))
    if gtype == "LineString":
        return LineString(obj_id=obj_id, timestamp=ts, coords=np.asarray(coords, float))
    if gtype == "MultiLineString":
        return MultiLineString(
            obj_id=obj_id, timestamp=ts,
            parts=[np.asarray(p, float) for p in coords],
        )
    if gtype == "Polygon":
        return Polygon(
            obj_id=obj_id, timestamp=ts, rings=[np.asarray(r, float) for r in coords]
        )
    if gtype == "MultiPolygon":
        return MultiPolygon.from_polygons(
            [[np.asarray(r, float) for r in poly] for poly in coords],
            obj_id=obj_id, timestamp=ts,
        )
    if gtype == "GeometryCollection":
        return GeometryCollection(
            obj_id=obj_id, timestamp=ts,
            geometries=[_geometry_from_geojson(g) for g in geom.get("geometries", [])],
        )
    raise ValueError(f"unsupported GeoJSON geometry type: {gtype!r}")


def parse_geojson(
    record: Union[str, dict],
    timestamp_property: str = "timestamp",
    objid_property: str = "oID",
    date_format: Optional[str] = None,
) -> SpatialObject:
    """Parse a GeoJSON record (Kafka envelope, Feature, or bare geometry)."""
    obj = json.loads(record) if isinstance(record, str) else record
    if "value" in obj and isinstance(obj["value"], dict):  # Kafka envelope
        obj = obj["value"]
    props = obj.get("properties") or {}
    geom = obj.get("geometry", obj)  # Feature vs bare geometry
    oid = props.get(objid_property)
    if oid is not None:
        oid = str(oid)
    ts = parse_timestamp(props.get(timestamp_property), date_format)
    return _geometry_from_geojson(geom, obj_id=oid, ts=ts)


def _coords_to_geojson(obj: SpatialObject):
    if isinstance(obj, Point):
        return "Point", [obj.x, obj.y]
    if isinstance(obj, MultiPoint):
        return "MultiPoint", obj.coords.tolist()
    if isinstance(obj, MultiLineString):
        return "MultiLineString", [p.tolist() for p in (obj.parts or [obj.coords])]
    if isinstance(obj, LineString):
        return "LineString", obj.coords.tolist()
    if isinstance(obj, MultiPolygon):
        return "MultiPolygon", [
            [r.tolist() for r in poly.rings] for poly in obj.polygons()
        ]
    if isinstance(obj, Polygon):
        return "Polygon", [r.tolist() for r in obj.rings]
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def to_geojson(
    obj: SpatialObject,
    timestamp_property: str = "timestamp",
    objid_property: str = "oID",
    date_format: Optional[str] = None,
) -> str:
    """Emit a GeoJSON Feature string (Serialization.java's output schemas)."""
    if isinstance(obj, GeometryCollection):
        geometry = {
            "type": "GeometryCollection",
            "geometries": [
                dict(zip(("type", "coordinates"), _coords_to_geojson(g)))
                for g in obj.geometries
            ],
        }
    else:
        gtype, coords = _coords_to_geojson(obj)
        geometry = {"type": gtype, "coordinates": coords}
    feature = {
        "type": "Feature",
        "geometry": geometry,
        "properties": {
            objid_property: obj.obj_id,
            timestamp_property: format_timestamp(obj.timestamp, date_format),
        },
    }
    return json.dumps(feature)


# ---------------------------------------------------------------------------
# WKT

_WKT_TYPES = (
    "GEOMETRYCOLLECTION",
    "MULTIPOLYGON",
    "MULTILINESTRING",
    "MULTIPOINT",
    "POLYGON",
    "LINESTRING",
    "POINT",
)


def _parse_coord_seq(body: str) -> np.ndarray:
    pts = []
    for tok in body.split(","):
        parts = tok.strip().lstrip("(").rstrip(")").split()
        pts.append([float(parts[0]), float(parts[1])])
    return np.asarray(pts, float)


def _split_groups(body: str) -> List[str]:
    """Split a parenthesized group list at depth 0 commas: "(a),(b)" → [a, b]."""
    groups, depth, cur = [], 0, []
    for ch in body:
        if ch == "(":
            if depth > 0:
                cur.append(ch)
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth > 0:
                cur.append(ch)
            elif depth == 0:
                groups.append("".join(cur))
                cur = []
        elif ch == "," and depth == 0:
            pass
        elif depth > 0:
            cur.append(ch)
    return groups


def parse_wkt(text: str, obj_id=None, timestamp: int = 0) -> SpatialObject:
    """Parse the first WKT geometry found anywhere in ``text``."""
    upper = text.upper()
    for wt in _WKT_TYPES:
        pos = upper.find(wt)
        if pos >= 0:
            # Guard against finding "POINT" inside "MULTIPOINT" handled by
            # ordering; extract the balanced-paren body after the tag.
            rest = text[pos + len(wt):].lstrip()
            if not rest.startswith("("):
                continue
            depth, end = 0, 0
            for i, ch in enumerate(rest):
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                    if depth == 0:
                        end = i + 1
                        break
            body = rest[1 : end - 1]
            return _wkt_build(wt, body, obj_id, timestamp)
    raise ValueError(f"no WKT geometry in: {text[:80]!r}")


def _wkt_build(wt: str, body: str, obj_id, ts) -> SpatialObject:
    if wt == "POINT":
        xy = _parse_coord_seq(body)[0]
        return Point(obj_id=obj_id, timestamp=ts, x=xy[0], y=xy[1])
    if wt == "LINESTRING":
        return LineString(obj_id=obj_id, timestamp=ts, coords=_parse_coord_seq(body))
    if wt == "POLYGON":
        return Polygon(
            obj_id=obj_id, timestamp=ts,
            rings=[_parse_coord_seq(g) for g in _split_groups(body)],
        )
    if wt == "MULTIPOINT":
        if "(" in body:
            coords = np.concatenate(
                [_parse_coord_seq(g) for g in _split_groups(body)], axis=0
            )
        else:
            coords = _parse_coord_seq(body)
        return MultiPoint(obj_id=obj_id, timestamp=ts, coords=coords)
    if wt == "MULTILINESTRING":
        return MultiLineString(
            obj_id=obj_id, timestamp=ts,
            parts=[_parse_coord_seq(g) for g in _split_groups(body)],
        )
    if wt == "MULTIPOLYGON":
        polys = []
        for g in _split_groups(body):
            polys.append([_parse_coord_seq(r) for r in _split_groups(g)])
        return MultiPolygon.from_polygons(polys, obj_id=obj_id, timestamp=ts)
    if wt == "GEOMETRYCOLLECTION":
        geoms = []
        # Split at top-level geometry tags.
        idx = [
            m.start()
            for m in re.finditer(
                "|".join(_WKT_TYPES), body.upper()
            )
        ]
        # Keep only non-overlapping tag positions (MULTIPOINT contains POINT).
        starts = []
        for i in idx:
            if not starts or i >= starts[-1][1]:
                for wt2 in _WKT_TYPES:
                    if body.upper().startswith(wt2, i):
                        starts.append((i, i + len(wt2)))
                        break
        bounds = [s[0] for s in starts] + [len(body)]
        for a, b in zip(bounds[:-1], bounds[1:]):
            geoms.append(parse_wkt(body[a:b]))
        return GeometryCollection(obj_id=obj_id, timestamp=ts, geometries=geoms)
    raise ValueError(wt)


def _ring_wkt(r: np.ndarray) -> str:
    r = np.asarray(r, float)
    if not np.array_equal(r[0], r[-1]):
        r = np.vstack([r, r[:1]])
    return "(" + ", ".join(f"{x:g} {y:g}" for x, y in r) + ")"


def to_wkt(obj: SpatialObject) -> str:
    if isinstance(obj, Point):
        return f"POINT ({obj.x:g} {obj.y:g})"
    if isinstance(obj, MultiPoint):
        return "MULTIPOINT (" + ", ".join(f"{x:g} {y:g}" for x, y in obj.coords) + ")"
    if isinstance(obj, MultiLineString):
        parts = obj.parts or [obj.coords]
        return "MULTILINESTRING (" + ", ".join(
            "(" + ", ".join(f"{x:g} {y:g}" for x, y in p) + ")" for p in parts
        ) + ")"
    if isinstance(obj, LineString):
        return "LINESTRING (" + ", ".join(f"{x:g} {y:g}" for x, y in obj.coords) + ")"
    if isinstance(obj, MultiPolygon):
        return "MULTIPOLYGON (" + ", ".join(
            "(" + ", ".join(_ring_wkt(r) for r in p.rings) + ")" for p in obj.polygons()
        ) + ")"
    if isinstance(obj, Polygon):
        return "POLYGON (" + ", ".join(_ring_wkt(r) for r in obj.rings) + ")"
    if isinstance(obj, GeometryCollection):
        return "GEOMETRYCOLLECTION (" + ", ".join(to_wkt(g) for g in obj.geometries) + ")"
    raise TypeError(type(obj).__name__)


# ---------------------------------------------------------------------------
# CSV / TSV


def parse_csv_point(
    line: str,
    schema: Sequence[int] = (0, 1, 2, 3),
    delimiter: str = ",",
    date_format: Optional[str] = None,
    strict: bool = False,
) -> Point:
    """CSV/TSV → Point. ``schema`` = positions of [objID, timestamp, x, y]
    (csvTsvSchemaAttr; Deserialization.CSVTSVToTSpatial,
    Deserialization.java:291-325). Quotes stripped; whitespace around the
    delimiter tolerated."""
    fields = re.split(r"\s*" + re.escape(delimiter) + r"\s*", line.replace('"', "").strip())
    oid = fields[schema[0]]
    ts = parse_timestamp(fields[schema[1]], date_format, strict=strict)
    x = float(fields[schema[2]])
    y = float(fields[schema[3]])
    return Point(obj_id=oid, timestamp=ts, x=x, y=y)


def to_csv_point(p: Point, delimiter: str = ",") -> str:
    # repr(float(...)): plain floats keep full precision; numpy scalars
    # would render as "np.float64(…)" under numpy>=2.
    return delimiter.join(
        [str(p.obj_id), str(p.timestamp), repr(float(p.x)), repr(float(p.y))]
    )
