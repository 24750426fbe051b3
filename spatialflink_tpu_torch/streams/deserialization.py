"""The reference's static stream factories and output schemas
(``spatialStreams/Deserialization.java`` :47, :64, :82, :99, :588, :837,
:1208 and ``Serialization.java``), as in the JAX package's
``streams/deserialization.py``.

Each factory turns an iterable of raw records (JSON, WKT or CSV text
lines, or dicts) into an iterator of spatial objects of the requested
type in the configured format, skipping records that do not parse or
are of another type. ``to_output_record`` renders an object back as
GeoJSON, WKT or CSV.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional, Sequence, Type

from spatialflink_tpu_torch.models.objects import (
    GeometryCollection,
    LineString,
    MultiPoint,
    Point,
    Polygon,
    SpatialObject,
)
from spatialflink_tpu_torch.streams.serde import (
    parse_csv_point,
    parse_geojson,
    parse_wkt,
    to_csv_point,
    to_geojson,
    to_wkt,
)

_FORMATS = ("GeoJSON", "WKT", "CSV", "TSV")


def _typed_stream(
    records: Iterable,
    input_type: str,
    expected: Optional[Type[SpatialObject]],
    date_format: Optional[str],
    timestamp_property: str,
    objid_property: str,
    delimiter: str,
    csv_schema: Sequence[int],
) -> Iterator[SpatialObject]:
    if input_type not in _FORMATS:
        # Same failure mode as the reference's
        # IllegalArgumentException("inputType … is not support").
        raise ValueError(f"inputType {input_type!r} is not supported")
    for rec in records:
        try:
            if input_type == "GeoJSON":
                obj = parse_geojson(
                    rec, timestamp_property=timestamp_property,
                    objid_property=objid_property, date_format=date_format,
                )
            elif input_type == "WKT":
                obj = parse_wkt(rec if isinstance(rec, str) else str(rec))
            else:  # CSV / TSV → points only (the reference's CSVTSV mappers)
                delim = delimiter if input_type == "CSV" else "\t"
                obj = parse_csv_point(
                    rec, schema=csv_schema, delimiter=delim, date_format=date_format
                )
        except (ValueError, KeyError, IndexError):
            continue
        if expected is None or isinstance(obj, expected):
            yield obj


def point_stream(records, input_type="GeoJSON", date_format=None,
                 delimiter=",", csv_schema=(0, 1, 2, 3)):
    """Deserialization.PointStream (Deserialization.java:47)."""
    return _typed_stream(records, input_type, Point, date_format,
                         "timestamp", "oID", delimiter, csv_schema)


def trajectory_stream(records, input_type="GeoJSON", date_format=None,
                      delimiter=",", csv_schema=(0, 1, 2, 3),
                      timestamp_property="timestamp", objid_property="oID"):
    """Deserialization.TrajectoryStream (Deserialization.java:64) — points
    with objID/timestamp extracted from configurable property names."""
    return _typed_stream(records, input_type, Point, date_format,
                         timestamp_property, objid_property, delimiter, csv_schema)


def polygon_stream(records, input_type="GeoJSON", date_format=None,
                   timestamp_property="timestamp", objid_property="oID"):
    """Deserialization.PolygonStream (Deserialization.java:82)."""
    return _typed_stream(records, input_type, Polygon, date_format,
                         timestamp_property, objid_property, ",", (0, 1, 2, 3))


def linestring_stream(records, input_type="GeoJSON", date_format=None,
                      timestamp_property="timestamp", objid_property="oID"):
    """Deserialization.LineStringStream (Deserialization.java:588)."""
    return _typed_stream(records, input_type, LineString, date_format,
                         timestamp_property, objid_property, ",", (0, 1, 2, 3))


def multipoint_stream(records, input_type="GeoJSON", date_format=None,
                      timestamp_property="timestamp", objid_property="oID"):
    """Deserialization.MultiPointStream (Deserialization.java:1208)."""
    return _typed_stream(records, input_type, MultiPoint, date_format,
                         timestamp_property, objid_property, ",", (0, 1, 2, 3))


def geometry_collection_stream(records, input_type="GeoJSON", date_format=None,
                               timestamp_property="timestamp", objid_property="oID"):
    """Deserialization.GeometryCollectionStream (Deserialization.java:837)."""
    return _typed_stream(records, input_type, GeometryCollection, date_format,
                         timestamp_property, objid_property, ",", (0, 1, 2, 3))


# ---------------------------------------------------------------------------
# Output schemas (Serialization.java:17-726): object → wire format.


def to_output_record(obj: SpatialObject, output_format: str = "GeoJSON",
                     date_format=None, delimiter=",") -> str:
    if output_format == "GeoJSON":
        return to_geojson(obj, date_format=date_format)
    if output_format == "WKT":
        # The reference's WKT output schemas prepend objID + timestamp.
        return f"{obj.obj_id}{delimiter}{obj.timestamp}{delimiter}{to_wkt(obj)}"
    if output_format in ("CSV", "TSV"):
        d = delimiter if output_format == "CSV" else "\t"
        if isinstance(obj, Point):
            return to_csv_point(obj, delimiter=d)
        return f"{obj.obj_id}{d}{obj.timestamp}{d}{to_wkt(obj)}"
    raise ValueError(f"outputFormat {output_format!r} is not supported")
