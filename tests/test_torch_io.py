"""Parity of the PyTorch port's ingest with the JAX package's: the
shapefile reader and writer, the sources, ``csv_chunk_source``, the rest
of the object model, the grid's cell-length constructor and cell names,
and ``signed_area``.

The same objects and files, made with numpy from a seed, go through both
packages. Everything is held EXACTLY equal: the bytes a writer produces,
the objects a reader yields (types, ids, coordinate arrays), the events a
source yields, the chunks a parser sees, areas, grids and cells. The JAX
package's own cases (``tests/test_io_and_state.py:25-66, 191``,
``tests/test_coverage_gaps.py:135``, ``tests/test_operators.py:205``,
``tests/test_grid.py``) run against the port as well.
"""

import socket
import threading

import numpy as np
import pytest
import torch

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models import objects as jobj
from spatialflink_tpu.ops.polygon import signed_area as j_signed_area
from spatialflink_tpu.streams import shapefile as jshp
from spatialflink_tpu.streams import soa as jsoa
from spatialflink_tpu.streams import sources as jsrc
from spatialflink_tpu.streams.serde import parse_csv_point as j_parse_csv

from spatialflink_tpu_torch.grid import UniformGrid as TGrid
from spatialflink_tpu_torch.models import objects as tobj
from spatialflink_tpu_torch.ops.polygon import (
    pack_rings,
    points_in_polygon,
    signed_area,
)
from spatialflink_tpu_torch.streams import shapefile as tshp
from spatialflink_tpu_torch.streams import soa as tsoa
from spatialflink_tpu_torch.streams import sources as tsrc
from spatialflink_tpu_torch.streams.serde import parse_csv_point

from test_torch_serde import assert_same, objects

BEIJING = dict(min_x=115.50, max_x=117.60, min_y=39.60, max_y=41.10)


def _shape_objects(mod):
    """What a shapefile holds: points, polylines, polygons (holes, and
    members of a multipolygon) and multipoints, from the serde set."""
    return [o for o in objects(mod) if not isinstance(
        o, (mod.GeometryCollection,))]


@pytest.mark.parametrize("i", range(7))
def test_shapefile_write_and_read_match(tmp_path, i):
    t_objs = _shape_objects(tobj)[i:i + 1]
    j_objs = _shape_objects(jobj)[i:i + 1]
    tp, jp = tmp_path / "t.shp", tmp_path / "j.shp"
    tshp.write_shapefile(str(tp), t_objs)
    jshp.write_shapefile(str(jp), j_objs)
    assert tp.read_bytes() == jp.read_bytes()
    got = list(tshp.read_shapefile(str(jp)))
    want = list(jshp.read_shapefile(str(jp)))
    assert len(got) == len(want) == 1
    for a, b in zip(got, want):
        assert_same(a, b)


def test_shapefile_many_polygons_bit_for_bit(tmp_path):
    """A ring set read back equals the rings written, bit for bit, with
    every exterior clockwise in the file and read back as written
    (counter-clockwise rings are reversed by the writer)."""
    rng = np.random.default_rng(3)
    rings = []
    for i in range(40):
        a = np.sort(rng.uniform(0, 2 * np.pi, 6))
        if i % 2:
            a = a[::-1]
        r = np.stack([116 + 0.01 * np.cos(a), 40 + 0.01 * np.sin(a)], 1)
        rings.append(np.vstack([r, r[:1]]))
    path = str(tmp_path / "p.shp")
    tshp.write_shapefile(path, [tobj.Polygon(rings=[r]) for r in rings])
    back = list(tshp.read_shapefile(path))
    assert len(back) == len(rings)
    for k, (r, b) in enumerate(zip(rings, back)):
        want = r if signed_area(r) < 0 else r[::-1]
        assert np.array_equal(b.rings[0], want)
        assert b.obj_id == str(k + 1)
    jback = list(jshp.read_shapefile(path))
    for a, b in zip(back, jback):
        assert_same(a, b)


def test_shapefile_reference_cases(tmp_path):
    """tests/test_io_and_state.py:25-66 and :191 through the port."""
    p = str(tmp_path / "pts.shp")
    tshp.write_shapefile(p, [tobj.Point(x=1.5, y=2.5),
                             tobj.Point(x=-3.0, y=4.0)])
    back = list(tshp.read_shapefile(p))
    assert isinstance(back[0], tobj.Point)
    assert (back[0].x, back[0].y, back[0].obj_id) == (1.5, 2.5, "1")
    poly = tobj.Polygon(rings=[
        np.array([[0, 0], [4, 0], [4, 4], [0, 4], [0, 0]], float),
        np.array([[1, 1], [2, 1], [2, 2], [1, 2], [1, 1]], float),
    ])
    p = str(tmp_path / "hole.shp")
    tshp.write_shapefile(p, [poly])
    (back,) = tshp.read_shapefile(p)
    assert type(back) is tobj.Polygon and len(back.rings) == 2
    verts, ev = pack_rings(back.rings)
    inside = points_in_polygon(torch.tensor([[1.5, 1.5], [3.0, 3.0]],
                                            dtype=torch.float64),
                               torch.from_numpy(verts), torch.from_numpy(ev))
    assert inside.tolist() == [False, True]
    bad = tmp_path / "bad.shp"
    bad.write_bytes(b"\x00" * 120)
    with pytest.raises(ValueError, match="file code"):
        list(tshp.read_shapefile(str(bad)))
    with pytest.raises(tshp.ShapefileError):
        tshp.write_shapefile(str(bad), [tobj.GeometryCollection()])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_signed_area_matches(seed):
    rng = np.random.default_rng(seed)
    ring = rng.uniform(-10, 10, (int(rng.integers(3, 40)), 2))
    assert signed_area(ring) == j_signed_area(ring)
    assert signed_area(ring[::-1]) == j_signed_area(ring[::-1])


def test_collection_and_csv_sources(tmp_path):
    items = objects(tobj)
    assert list(tsrc.collection_source(items)) == items
    lines = ["oid,ts,x,y", "a,100,1.0,2.0", "", "GARBAGE", "b,200,3.5,-4.25",
             "c,x,1,2", "d,300,5,6", "e,400,7,8"]
    path = tmp_path / "in.csv"
    path.write_text("\n".join(lines) + "\n")
    for kw in ({}, dict(skip_header=True), dict(limit=2)):
        got = list(tsrc.csv_source(str(path), parse_csv_point, **kw))
        want = list(jsrc.csv_source(str(path), j_parse_csv, **kw))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert_same(a, b)


def _serve(payload: bytes):
    server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    server.bind(("127.0.0.1", 0))
    server.listen(1)

    def run():
        conn, _ = server.accept()
        for i in range(0, len(payload), 7):  # lines split across sends
            conn.sendall(payload[i:i + 7])
        conn.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return server, t


def test_socket_source_loopback():
    """tests/test_coverage_gaps.py:135 through the port, both packages
    reading the same bytes."""
    payload = b"a,100,1.0,2.0\nGARBAGE\n\nb,200,3.0,4.0\nc,300,5.5,6"
    out = []
    for src, parse in ((tsrc, parse_csv_point), (jsrc, j_parse_csv)):
        server, t = _serve(payload)
        out.append(list(src.socket_source(
            "127.0.0.1", server.getsockname()[1], parse)))
        t.join(timeout=5)
        server.close()
        assert not t.is_alive()
    assert [(p.obj_id, p.x) for p in out[0]] == [("a", 1.0), ("b", 3.0)]
    for a, b in zip(*out):
        assert_same(a, b)


@pytest.mark.parametrize("kw", [
    dict(target_eps=1000, duration_ms=2000, num_devices=5, seed=42),
    dict(target_eps=333, duration_ms=1500, num_devices=3, seed=7,
         start_ts=10_000),
])
def test_synthetic_gps_source(kw):
    """tests/test_operators.py:205 through the port: the same events as
    the JAX source, deterministic, at the target rate."""
    t_src = tsrc.SyntheticGpsSource(0, 10, 0, 10, **kw)
    j_src = jsrc.SyntheticGpsSource(0, 10, 0, 10, **kw)
    a, b = list(t_src), list(t_src)
    want = list(j_src)
    assert len(a) == t_src.total_events == len(want)
    key = lambda p: (p.obj_id, p.timestamp, p.x, p.y)  # noqa: E731
    assert [key(p) for p in a] == [key(p) for p in b] == \
        [key(p) for p in want]
    assert all(type(p.x) is float and p.ingestion_time > 0 for p in a)
    assert {p.obj_id for p in a} == {f"dev{i}" for i in
                                     range(kw["num_devices"])}


def test_synthetic_gps_source_events_and_realtime():
    def mk(**f):
        return tuple(sorted(f.items()))
    kw = dict(target_eps=2000, duration_ms=1000, num_devices=4, seed=9)
    got = list(tsrc.SyntheticGpsSource(1, 2, 3, 4, make_event=mk, **kw))
    want = list(jsrc.SyntheticGpsSource(1, 2, 3, 4, make_event=mk, **kw))
    assert got == want
    rt = list(tsrc.SyntheticGpsSource(1, 2, 3, 4, realtime=True,
                                      target_eps=20_000, duration_ms=100))
    assert len(rt) == 2000


class _NumpyParser:
    """A buffer-at-a-time parser of ``oid,ts,x,y`` lines, as the native
    parsers the JAX package's ``csv_chunk_source`` is normally given."""

    def __init__(self):
        self.blocks = []

    def parse(self, block: bytes):
        self.blocks.append(block)
        rows = np.array([ln.split(b",") for ln in block.split(b"\n")
                         if ln.strip()], dtype=np.float64).reshape(-1, 4)
        return {"oid": rows[:, 0].astype(np.int32),
                "ts": rows[:, 1].astype(np.int64),
                "x": rows[:, 2], "y": rows[:, 3]}


@pytest.mark.parametrize("chunk_bytes,tail_newline", [
    (64, True), (64, False), (1000, True), (7, False), (1 << 22, True)])
def test_csv_chunk_source(tmp_path, chunk_bytes, tail_newline):
    rng = np.random.default_rng(chunk_bytes)
    n = 300
    xy = rng.uniform(115, 118, (n, 2))
    text = "\n".join(f"{i % 17},{i * 3},{x!r},{y!r}"
                     for i, (x, y) in enumerate(xy.tolist()))
    path = tmp_path / "pts.csv"
    path.write_text(text + ("\n" if tail_newline else ""))
    tp, jp = _NumpyParser(), _NumpyParser()
    got = list(tsoa.csv_chunk_source(str(path), tp, chunk_bytes))
    want = list(jsoa.csv_chunk_source(str(path), jp, chunk_bytes))
    assert tp.blocks == jp.blocks and len(got) == len(want)
    for a, b in zip(got, want):
        assert all(np.array_equal(a[k], b[k]) for k in a)
    x = np.concatenate([c["x"] for c in got])
    assert np.array_equal(x, xy[:, 0])
    assert np.array_equal(np.concatenate([c["ts"] for c in got]),
                          np.arange(n) * 3)


def test_object_model_additions():
    t, j = objects(tobj), objects(jobj)
    for a, b in zip(t, j):
        assert a.bbox() == b.bbox()
    grid_t, grid_j = TGrid(50, **BEIJING), JGrid(50, **BEIJING)
    for a, b in zip(t, j):
        if not isinstance(a, tobj.Point):
            assert a.grid_cells(grid_t) == b.grid_cells(grid_j)
    p = t[0]
    assert np.array_equal(p.coords, np.array([p.x, p.y]))
    assert p.coords.dtype == np.float64
    assert np.array_equal(t[3].exterior, t[3].rings[0])
    members = t[6].polygons()
    for a, b in zip(members, j[6].polygons()):
        assert_same(a, b)
    assert [len(m.rings) for m in members] == [2, 1]
    assert isinstance(tobj.MultiPoint(coords=[[1, 2]]).coords, np.ndarray)
    assert tobj.Point().ingestion_time is None


@pytest.mark.parametrize("cell", [0.021, 0.5, 0.0007, 3.0])
def test_grid_from_cell_length(cell):
    bbs = [BEIJING, dict(min_x=0.0, max_x=1.0, min_y=-3.0, max_y=2.0),
           dict(min_x=2.0, max_x=4.0, min_y=2.0, max_y=4.0)]
    for bb in bbs:
        g = TGrid.from_cell_length(cell, **bb)
        want = JGrid.from_cell_length(cell, **bb)
        assert (g.n, g.min_x, g.max_x, g.min_y, g.max_y, g.cell_length) == (
            want.n, want.min_x, want.max_x, want.min_y, want.max_y,
            want.cell_length)
        assert repr(g) == repr(want)


def test_grid_cell_names_round_trip():
    g, j = TGrid(100, **BEIJING), JGrid(100, **BEIJING)
    for flat in (0, 1, 99, 100, 4321, 9999):
        name = g.cell_name(flat)
        assert name == j.cell_name(flat)
        assert g.cell_from_name(name) == j.cell_from_name(name) == flat
    assert repr(g).startswith("UniformGrid(n=100, cell=0.021")
