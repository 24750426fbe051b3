"""Parity of the PyTorch port's serde (``streams/serde.py``,
``streams/deserialization.py``) and object model with the JAX package's.

The same objects, made with numpy from a seed, are built in both
packages' object models, written by both packages' emitters and read
back by both packages' parsers. Everything is held EXACTLY equal: the
strings written (GeoJSON, WKT with its lossy ``:g`` coordinates, CSV
with ``repr``), and the parsed objects' types, ids, timestamps and
coordinate arrays (values and dtypes). The JAX package's own
``tests/test_serde.py`` cases run against the port as well.
"""

import dataclasses
import json

import numpy as np
import pytest

from spatialflink_tpu.models import objects as jobj
from spatialflink_tpu.streams import deserialization as jdes
from spatialflink_tpu.streams import serde as jserde

from spatialflink_tpu_torch.models import objects as tobj
from spatialflink_tpu_torch.streams import deserialization as tdes
from spatialflink_tpu_torch.streams import serde as tserde

KAFKA_ENVELOPE = (
    '{"key":136138,"value":{"geometry":{"coordinates":[116.44412,39.93984],'
    '"type":"Point"},"properties":{"oID":"2560","timestamp":"2008-02-02 '
    '20:12:32"},"type":"Feature"}}'
)
DATE = "yyyy-MM-dd HH:mm:ss"


def _ring(rng, cx, cy, n, r, cw=False):
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    if cw:
        a = a[::-1]
    ring = np.stack([cx + r * np.cos(a), cy + r * np.sin(a)], axis=1)
    return np.vstack([ring, ring[:1]])


def objects(mod, seed=5):
    """One object of every type of ``mod`` (either package's object
    model), coordinates from ``seed``: full-precision floats and a few
    short decimals."""
    rng = np.random.default_rng(seed)
    c = lambda n: rng.uniform(-180, 180, (n, 2))  # noqa: E731
    ext = _ring(rng, 116.4, 40.0, 7, 0.3)
    hole = _ring(rng, 116.4, 40.0, 4, 0.05, cw=True)
    return [
        mod.Point(obj_id="p1", timestamp=1234, x=float(rng.uniform(-1, 1)),
                  y=116.25),
        mod.Point(obj_id="p2", timestamp=0, x=1e-7, y=-3.5e12),
        mod.LineString(obj_id="l", timestamp=7, coords=c(5)),
        mod.Polygon(obj_id="poly", timestamp=9, rings=[ext, hole]),
        mod.MultiPoint(obj_id="mp", timestamp=11, coords=c(4)),
        mod.MultiLineString(obj_id="ml", timestamp=13,
                            parts=[c(3), c(2), np.round(c(4), 2)]),
        mod.MultiPolygon.from_polygons(
            [[ext, hole], [_ring(rng, 3.0, 50.0, 5, 1.0)]],
            obj_id="mpoly", timestamp=15),
        mod.GeometryCollection(
            obj_id="gc", timestamp=17,
            geometries=[mod.Point(x=1.5, y=2.5),
                        mod.LineString(coords=np.round(c(3), 3)),
                        mod.Polygon(rings=[np.round(ext, 4)])]),
    ]


def assert_same(a, b):
    """Two objects, one of each package, equal field by field: type
    name, ids, timestamps, coordinate arrays (values and dtypes) and
    nested geometries."""
    assert type(a).__name__ == type(b).__name__
    fa = {f.name: getattr(a, f.name) for f in dataclasses.fields(a)}
    fb = {f.name: getattr(b, f.name) for f in dataclasses.fields(b)}
    assert fa.keys() == fb.keys()
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), k
        elif isinstance(x, list) and x and isinstance(x[0], np.ndarray):
            assert len(x) == len(y)
            for p, q in zip(x, y):
                assert p.dtype == q.dtype and np.array_equal(p, q), k
        elif k == "geometries":
            assert len(x) == len(y)
            for p, q in zip(x, y):
                assert_same(p, q)
        else:
            assert x == y and type(x) is type(y), k


@pytest.mark.parametrize("i", range(8))
def test_emitters_write_the_same_strings(i):
    j, t = objects(jobj)[i], objects(tobj)[i]
    assert tserde.to_geojson(t) == jserde.to_geojson(j)
    assert tserde.to_geojson(t, "ts", "id", DATE) == \
        jserde.to_geojson(j, "ts", "id", DATE)
    assert tserde.to_wkt(t) == jserde.to_wkt(j)
    for fmt in ("GeoJSON", "WKT", "CSV", "TSV"):
        assert tdes.to_output_record(t, fmt) == jdes.to_output_record(j, fmt)
    if isinstance(t, tobj.Point):
        assert tserde.to_csv_point(t, ";") == jserde.to_csv_point(j, ";")


@pytest.mark.parametrize("i", range(8))
def test_parsers_read_the_same_objects(i):
    j = objects(jobj)[i]
    for text in (jserde.to_geojson(j), jserde.to_geojson(j, date_format=DATE)):
        fmt = DATE if "-" in json.loads(text)["properties"]["timestamp"] \
            else None
        assert_same(tserde.parse_geojson(text, date_format=fmt),
                    jserde.parse_geojson(text, date_format=fmt))
    # WKT: lossy (six significant digits), the same loss in both.
    wkt = jserde.to_wkt(j)
    got = tserde.parse_wkt("7,99," + wkt + ",tail", obj_id="w", timestamp=3)
    assert_same(got, jserde.parse_wkt("7,99," + wkt + ",tail", obj_id="w",
                                      timestamp=3))
    assert tserde.to_wkt(got) == wkt
    # A GeoJSON round trip is exact.
    back = tserde.parse_geojson(tserde.to_geojson(objects(tobj)[i]))
    assert_same(back, jserde.parse_geojson(jserde.to_geojson(j)))


def test_csv_points_round_trip_exactly():
    rng = np.random.default_rng(9)
    xy = np.concatenate([rng.uniform(-180, 180, (200, 2)),
                         rng.normal(size=(50, 2)) * 1e-300,
                         np.round(rng.uniform(0, 10, (50, 2)), 3)])
    for i, (x, y) in enumerate(xy):
        tp = tobj.Point(obj_id=f"o{i}", timestamp=i * 37, x=x, y=y)
        line = tserde.to_csv_point(tp)
        assert line == jserde.to_csv_point(
            jobj.Point(obj_id=f"o{i}", timestamp=i * 37, x=x, y=y))
        back = tserde.parse_csv_point(line)
        assert (back.obj_id, back.timestamp, back.x, back.y) == \
            (f"o{i}", i * 37, x, y)
        assert_same(back, jserde.parse_csv_point(line))


@pytest.mark.parametrize("line,kw", [
    ('ignored, "veh7", a, b, 123456, 116.5, 40.1',
     dict(schema=[1, 4, 5, 6], delimiter=",")),
    ("veh1\t100\t1.0\t2.0", dict(schema=[0, 1, 2, 3], delimiter="\t")),
    ("a ; 2008-02-02 20:12:32 ; 3.25 ; -1e-3",
     dict(delimiter=";", date_format=DATE)),
    ("a,garbage,1,2", dict(date_format=DATE)),
])
def test_csv_schemas_delimiters_and_dates(line, kw):
    assert_same(tserde.parse_csv_point(line, **kw),
                jserde.parse_csv_point(line, **kw))


def test_strict_timestamps_raise_in_both():
    for mod in (jserde, tserde):
        with pytest.raises(ValueError):
            mod.parse_csv_point("a,garbage,1,2", date_format=DATE,
                                strict=True)
        with pytest.raises(ValueError):
            mod.parse_timestamp(None, None, strict=True)


@pytest.mark.parametrize("value,fmt", [
    ("123", None), (None, None), ("garbage", DATE),
    ("2008-02-02 20:12:32", DATE), (1201983152000, "null"), ("x", None),
    ("1999-12-31 23:59:59", DATE),
])
def test_timestamps(value, fmt):
    assert tserde.parse_timestamp(value, fmt) == \
        jserde.parse_timestamp(value, fmt)


@pytest.mark.parametrize("ts", [0, 1201983152000, 946684799000])
def test_format_timestamp(ts):
    for fmt in (None, DATE, "null"):
        assert tserde.format_timestamp(ts, fmt) == \
            jserde.format_timestamp(ts, fmt)


def test_reference_cases_of_the_jax_tests():
    """tests/test_serde.py's cases through the port."""
    p = tserde.parse_geojson(KAFKA_ENVELOPE, date_format=DATE)
    assert (p.x, p.y, p.obj_id, p.timestamp) == \
        (116.44412, 39.93984, "2560", 1201983152000)
    p = tserde.parse_geojson({
        "type": "Feature", "geometry": {"type": "Point", "coordinates":
                                        [1.0, 2.0]},
        "properties": {"oID": 77, "timestamp": 1234567}})
    assert p.obj_id == "77" and p.timestamp == 1234567
    p = tserde.parse_geojson('{"type": "Point", "coordinates": [3.5, 4.5]}')
    assert (p.x, p.y, p.obj_id) == (3.5, 4.5, None)
    p = tserde.parse_wkt("1351039728.980,9471001,POINT (13.45 52.1),extra")
    assert (p.x, p.y) == (13.45, 52.1)
    gc = tserde.parse_wkt(tserde.to_wkt(objects(tobj)[7]))
    assert [type(g).__name__ for g in gc.geometries] == \
        ["Point", "LineString", "Polygon"]
    with pytest.raises(ValueError):
        tserde.parse_wkt("no geometry here")
    with pytest.raises(ValueError):
        tserde.parse_geojson('{"type": "Curve", "coordinates": []}')
    with pytest.raises(TypeError):
        tserde.to_wkt(tobj.SpatialObject())


def _records():
    recs = [jserde.to_geojson(o) for o in objects(jobj)]
    recs += [jdes.to_output_record(o, "WKT") for o in objects(jobj)]
    recs += ["not json at all", "a,1,2.0,3.0", "b,x,1,2",
             '{"type":"Feature","geometry":{"type":"Point","coordinates":'
             '[3,4]},"properties":{"vid":"x","t":5}}']
    return recs


@pytest.mark.parametrize("fmt", ["GeoJSON", "WKT", "CSV", "TSV"])
@pytest.mark.parametrize("factory", [
    "point_stream", "trajectory_stream", "polygon_stream",
    "linestring_stream", "multipoint_stream", "geometry_collection_stream"])
def test_stream_factories(factory, fmt):
    recs = _records()
    if fmt == "TSV":
        recs = recs + ["t\t5\t1.5\t2.5"]
    if fmt == "GeoJSON":  # a dict record (the Kafka ObjectNode analog)
        recs = recs + [{"type": "Point", "coordinates": [1, 2]}]
    kw = {}
    if factory == "trajectory_stream":
        kw = dict(timestamp_property="t", objid_property="vid")
    got = list(getattr(tdes, factory)(recs, input_type=fmt, **kw))
    want = list(getattr(jdes, factory)(recs, input_type=fmt, **kw))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_same(a, b)


def test_unsupported_formats_raise():
    with pytest.raises(ValueError, match="not supported"):
        list(tdes.point_stream([], input_type="XML"))
    with pytest.raises(ValueError, match="not supported"):
        tdes.to_output_record(tobj.Point(), "XML")
