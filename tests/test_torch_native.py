"""The port's binding of the native engines (``spatialflink_tpu_torch/
native.py``) against the JAX package's (``spatialflink_tpu/native.py``),
on the CPU. Both bind the same ``native/libsfnative.so``.

Contracts held, with the same seeded buffers and streams through both:
- the GPS, point and WKT parsers: every array bit-equal, the interners'
  names equal, skips counted alike; interning stable across calls;
- ``traj_stats_native`` bit-equal to the JAX binding and to the port's
  numpy engine, on sorted and shuffled streams;
- ``TJoinQuery.run_soa_panes(backend="native")`` bit-equal to the JAX
  ``backend="native"`` operator. Both sides hand ``sf_tjoin_panes`` the
  float32 centred coordinates: the port's pane fields are float32, and
  the JAX operator runs inside ``jax.enable_x64(False)`` with
  ``dtype=np.float32``, so its ``f_dtype`` is float32 too. Against the
  port's device engine (on the CPU): the same pairs, the float64 minima
  within ``F32_DISTANCE_RTOL`` (3 float32 roundings) of the device
  engine's float32 ones;
- ``"auto"`` on a CPU device takes the native engine in both pane paths;
- the ABI guard refuses a library whose ``sf_abi_version()`` is not 4
  (or that has none), and caches the refusal; a forced ``"native"``
  raises when the library is unavailable, while ``"auto"`` falls back
  (the numpy engine for tStats, the device engine for the tJoin);
- every buffer handed to C is one the port owns (a torch tensor, a view
  or a strided column is copied first);
- the CSV chunk source fed the native point parser drives the range
  operator to the windows of the arrays it parsed.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from spatialflink_tpu import native as jnative
from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT
from spatialflink_tpu.operators.trajectory import (
    PointPointTJoinQuery as JTJoin,
)
from spatialflink_tpu.streams import panes as jpanes

from spatialflink_tpu_torch import native
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.operators import (
    PointPointTJoinQuery,
    QueryConfiguration,
)
from spatialflink_tpu_torch.streams import panes as tpanes

GRID = dict(num_partitions=16, min_x=0.0, max_x=10.0, min_y=0.0,
            max_y=10.0)


def test_library_builds_and_passes_the_abi_guard():
    assert native.available() and jnative.available()
    assert native._ABI_VERSION == jnative._ABI_VERSION == 4
    assert native._abi_of(native._lib) == 4
    assert native._LIB_PATH == jnative._LIB_PATH


# ---------------------------------------------------------------------------
# Parsers


def _gps_lines(n, rng):
    return [f"{i * 50},dev{int(rng.integers(0, 23))},z,4.{i % 10},"
            f"5.{i % 7},a,b,c,d,e,f,{rng.uniform(0, 120)!r},"
            f"{rng.uniform(50, 51)!r},{rng.uniform(4, 5)!r}"
            for i in range(n)]


def _same_arrays(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert a[k].shape == b[k].shape, k
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


@pytest.mark.parametrize("junk", [False, True])
def test_gps_parser_equals_jax(junk):
    rng = np.random.default_rng(31)
    lines = _gps_lines(3000, rng)
    if junk:
        lines[7] = "short,line"
        lines[100] = ""
        lines[200] = "xx,devA,z,bad,bad,a,b,c,d,e,f,bad,bad,bad"
    data = "\n".join(lines)
    p, jp = native.NativeGpsParser(), jnative.NativeGpsParser()
    for _ in range(2):  # the interners stay in step across calls
        got, want = p.parse(data), jp.parse(data.encode())
        _same_arrays(got, want)
    assert p.device_table() == jp.device_table()
    assert p.num_devices == jp.num_devices > 1


@pytest.mark.parametrize("schema,delim", [((0, 1, 2, 3), ","),
                                          ((1, 4, 5, 6), ","),
                                          ((3, 0, 1, 2), "\t")])
def test_point_parser_equals_jax(schema, delim):
    rng = np.random.default_rng(sum(schema))
    n = 4000
    cols = [[f"c{j}" for j in range(n)] for _ in range(7)]
    cols[schema[0]] = [f"veh{int(k)}" for k in rng.integers(0, 300, n)]
    cols[schema[1]] = [str(int(t)) for t in np.sort(rng.integers(0, 10**9,
                                                                 n))]
    cols[schema[2]] = [repr(v) for v in rng.uniform(115, 118, n).tolist()]
    cols[schema[3]] = [repr(v) for v in rng.uniform(39, 42, n).tolist()]
    width = max(schema) + 1
    data = "\n".join(delim.join(row[:width]) for row in zip(*cols)) + "\n"
    p = native.NativePointParser(schema=schema, delimiter=delim)
    jp = jnative.NativePointParser(schema=schema, delimiter=delim)
    got, want = p.parse(data.encode()), jp.parse(data.encode())
    _same_arrays(got, want)
    assert len(got["ts"]) == n
    assert [p.object_name(i) for i in range(p.num_objects)] == \
        [jp.object_name(i) for i in range(jp.num_objects)]
    # The parsed values are the text's, through the interner's names.
    names = [p.object_name(int(o)) for o in got["oid"]]
    assert names == cols[schema[0]]
    assert got["x"].tolist() == [float(v) for v in cols[schema[2]]]
    with pytest.raises(KeyError):
        p.object_name(p.num_objects + 5)


def _wkt_lines(rng):
    lines = []
    for i in range(60):
        cx, cy = rng.uniform(1, 9, 2).tolist()
        s = float(rng.uniform(0.05, 0.4))
        if i % 3 == 0:
            lines.append(f"l{i},{i * 100},LINESTRING ({cx!r} {cy!r}, "
                         f"{cx + s!r} {cy!r}, {cx!r} {cy + s!r})")
        elif i % 3 == 1:
            lines.append(f"p{i},{i * 100},POLYGON (({cx - s!r} {cy - s!r}, "
                         f"{cx + s!r} {cy - s!r}, {cx + s!r} {cy + s!r}, "
                         f"{cx - s!r} {cy - s!r}))")
        else:  # a hole (rings left open: the parser closes them)
            lines.append(f"h{i},{i * 100},POLYGON ((0 0, 5 0, 5 5, 0 5), "
                         f"(1 1, 2 1, 1 2))")
    lines.insert(5, "junk,1,POINT (1 2)")
    lines.insert(9, "not a line at all")
    return lines


def test_wkt_parser_equals_jax():
    lines = _wkt_lines(np.random.default_rng(33))
    p, jp = native.NativeWktParser(), jnative.NativeWktParser()
    got, want = p.parse("\n".join(lines)), jp.parse("\n".join(lines))
    _same_arrays(got, want)
    assert p.last_skipped == jp.last_skipped == 2
    assert len(got["ts"]) == 60
    assert [p.object_name(i) for i in range(p.num_objects)] == \
        [jp.object_name(i) for i in range(jp.num_objects)]


def test_parse_accepts_bytearray_and_str():
    data = "a,100,1.5,2.5\nb,200,3.5,4.5\n"
    p = native.NativePointParser()
    a = p.parse(data)
    b = p.parse(bytearray(data.encode()))
    _same_arrays(a, b)
    assert a["ts"].tolist() == [100, 200] and a["oid"].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# The tStats engine


def _stream(seed, n=30_000, t_max=12_000, n_obj=65, shuffle=False):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, t_max, n)).astype(np.int64)
    xy = rng.uniform(0, 10, (n, 2))
    oid = rng.integers(0, n_obj, n).astype(np.int64)
    if shuffle:
        perm = rng.permutation(n)
        ts, xy, oid = ts[perm], xy[perm], oid[perm]
    return ts, xy, oid


@pytest.mark.parametrize("size,slide", [(3_000, 10), (2_000, 1_000),
                                        (1_000, 1_000)])
def test_traj_stats_native_equals_jax_binding(size, slide):
    ts, xy, oid = _stream(size + slide)
    got = native.traj_stats_native(ts, xy[:, 0], xy[:, 1], oid, 128, size,
                                   slide)
    want = jnative.traj_stats_native(ts, xy[:, 0], xy[:, 1], oid, 128,
                                     size, slide)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("shuffle", [False, True])
def test_traj_stats_sliding_native_bit_equal_to_numpy_and_jax(shuffle):
    ts, xy, oid = _stream(41, shuffle=shuffle)
    args = (ts, xy, oid, 128, 3_000, 10)
    got = tpanes.traj_stats_sliding(*args, backend="native", device="cpu")
    auto = tpanes.traj_stats_sliding(*args, device="cpu")
    numpy_ = tpanes.traj_stats_sliding(*args, backend="numpy", device="cpu")
    jax_native = jpanes.traj_stats_sliding(*args, backend="native")
    for want in (auto, numpy_, jax_native):
        for a in ("starts", "spatial", "temporal", "count"):
            g, w = getattr(got, a), getattr(want, a)
            assert g.dtype == w.dtype and np.array_equal(g, w), a
    assert got.count.sum() > 0


def test_traj_stats_native_takes_tensors_and_views():
    """Inputs the port does not own (torch tensors, strided columns, other
    dtypes) are copied into owned buffers first; the results are the
    same."""
    ts, xy, oid = _stream(43, n=5_000)
    want = native.traj_stats_native(ts, np.ascontiguousarray(xy[:, 0]),
                                    np.ascontiguousarray(xy[:, 1]),
                                    oid.astype(np.int32), 128, 2_000, 100)
    got = native.traj_stats_native(torch.from_numpy(ts), xy[:, 0],
                                   torch.from_numpy(xy[:, 1].copy()),
                                   oid, 128, 2_000, 100)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert np.array_equal(a, b)
    t = torch.arange(4, dtype=torch.int64)
    assert native._owned(t, np.int64).flags.owndata
    view = np.arange(8, dtype=np.int64)[::2]
    owned = native._owned(view, np.int64)
    assert owned.flags.owndata and owned.flags.c_contiguous
    assert not np.shares_memory(owned, view)


def test_traj_stats_native_rejects_out_of_range_oid():
    with pytest.raises(ValueError, match="oid out of"):
        native.traj_stats_native(
            np.asarray([0, 10], np.int64), np.zeros(2), np.zeros(2),
            np.asarray([0, 99], np.int32), 8, 1_000, 100)
    empty = native.traj_stats_native(np.zeros(0, np.int64), np.zeros(0),
                                     np.zeros(0), np.zeros(0, np.int32), 8,
                                     1_000, 100)
    assert empty[0] == 0 and empty[1].shape == (0, 8)


# ---------------------------------------------------------------------------
# The pane-carry tJoin engine


def _chunks(rng, n, t_max, n_obj, shift=0.0, base=0):
    ts = base + np.sort(rng.integers(0, t_max, n)).astype(np.int64)
    return [{"ts": ts, "x": np.clip(rng.uniform(0, 10, n) + shift, 0, 9.99),
             "y": rng.uniform(0, 10, n),
             "oid": rng.integers(0, n_obj, n).astype(np.int32)}]


def _copies(chunks):
    return iter([dict(c) for c in chunks])


def _port(window, slide, device="cpu"):
    return PointPointTJoinQuery(
        QueryConfiguration(window_size=window, slide_step=slide),
        UniformGrid(**GRID), device=device)


TJOIN_CASES = {
    "sliding": (11, 1500, 4_000, 24, 1.0, 0.1, 0.4, 0),
    "extreme_overlap": (12, 800, 2_500, 16, 1.0, 0.01, 0.3, 0),
    "tumbling": (13, 600, 3_000, 8, 0.5, 0.5, 0.5, 0),
    "epoch_ms": (16, 400, 2_000, 8, 1.0, 0.25, 0.5, 1_753_900_000_000),
    "two_layers": (17, 500, 3_000, 12, 1.0, 0.5, 1.3, 0),
}


@pytest.mark.parametrize("case", sorted(TJOIN_CASES))
def test_tjoin_native_equals_jax_native(case):
    seed, n, t_max, n_obj, window, slide, radius, base = TJOIN_CASES[case]
    rng = np.random.default_rng(seed)
    left = _chunks(rng, n, t_max, n_obj, base=base)
    right = _chunks(rng, n, t_max, n_obj, shift=0.3, base=base)
    got = list(_port(window, slide).run_soa_panes(
        _copies(left), _copies(right), radius, n_obj, backend="native"))
    jop = JTJoin(JConf(JQT.WindowBased, window_size=window,
                       slide_step=slide), JGrid(**GRID))
    with jax.enable_x64(False):
        want = list(jop.run_soa_panes(
            _copies(left), _copies(right), radius, n_obj,
            dtype=np.float32, backend="native"))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert g[4].dtype == w[4].dtype == np.float64
        assert np.array_equal(g[4].view(np.int64), w[4].view(np.int64))
    assert sum(g[5] for g in got) > 0


@pytest.mark.parametrize("case", ["sliding", "extreme_overlap"])
def test_tjoin_native_against_the_device_engine(case):
    """The native engine computes in float64 from the float32 centred
    coordinates, the device engine in float32: the same pairs in the
    same order (no pair of these streams lies within
    ``F32_DISTANCE_RTOL`` of the radius), the minima within that
    relative bound (1.07–1.22 float32 spacings at most here)."""
    seed, n, t_max, n_obj, window, slide, radius, base = TJOIN_CASES[case]
    rng = np.random.default_rng(seed)
    left = _chunks(rng, n, t_max, n_obj, base=base)
    right = _chunks(rng, n, t_max, n_obj, shift=0.3, base=base)
    nat = list(_port(window, slide).run_soa_panes(
        _copies(left), _copies(right), radius, n_obj))  # "auto": native
    dev_op = _port(window, slide)
    dev = list(dev_op.run_soa_panes(
        _copies(left), _copies(right), radius, n_obj, backend="device"))
    assert dev_op.pane_scans
    assert len(nat) == len(dev) > 0
    for a, b in zip(nat, dev):
        assert a[:2] == b[:2] and a[5:] == b[5:]
        assert np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
        assert np.all(np.abs(a[4] - b[4]) <= F32_DISTANCE_RTOL * a[4])


#: The device engine's float32 distance from float32 coordinates carries
#: a relative error of at most 3u + O(u²), u = 2⁻²⁴ (two rounded
#: differences, two squares, a sum and a correctly rounded root), while
#: the native engine's float64 one is exact to ~2⁻⁵³: the two minima
#: agree within this relative bound, and a pair's in-radius decision can
#: differ only within it of the radius.
F32_DISTANCE_RTOL = 3 * 2.0 ** -24 * (1 + 2.0 ** -20)


# ---------------------------------------------------------------------------
# The ABI guard and the forced backend


def _stub_library(tmp_path, body):
    src = tmp_path / "stub.cpp"
    src.write_text(body)
    lib = tmp_path / "libstub.so"
    subprocess.run(["g++", "-shared", "-fPIC", "-o", str(lib), str(src)],
                   check=True, capture_output=True, timeout=120)
    return str(lib)


@pytest.mark.parametrize("body", [
    'extern "C" int sf_abi_version(void) { return 3; }\n',
    'extern "C" int sf_interner_new(void) { return 0; }\n',
], ids=["wrong_version", "no_version_symbol"])
def test_abi_guard_rejects_a_stub_library(tmp_path, monkeypatch, body):
    stub = _stub_library(tmp_path, body)
    monkeypatch.setattr(native, "_LIB_PATH", stub)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_abi_mismatch", False)
    makes = []
    monkeypatch.setattr(native, "_make",
                        lambda quiet: makes.append(1) or True)
    assert not native.available()
    assert native._abi_mismatch
    assert not native.available() and len(makes) == 1  # cached refusal
    assert native.traj_stats_native(np.zeros(1, np.int64), np.zeros(1),
                                    np.zeros(1), np.zeros(1, np.int32), 1,
                                    10, 10) is None
    with pytest.raises(RuntimeError):
        native.NativePointParser()


def _unavailable(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_abi_mismatch", True)
    assert not native.available()


def test_forced_native_raises_when_unavailable(monkeypatch):
    _unavailable(monkeypatch)
    ts, xy, oid = _stream(47, n=2_000)
    args = (ts, xy, oid, 128, 2_000, 100)
    with pytest.raises(RuntimeError, match="native"):
        tpanes.traj_stats_sliding(*args, backend="native", device="cpu")
    # "auto" on the CPU falls back to the numpy engine, bit for bit.
    auto = tpanes.traj_stats_sliding(*args, device="cpu")
    numpy_ = tpanes.traj_stats_sliding(*args, backend="numpy", device="cpu")
    assert np.array_equal(auto.spatial, numpy_.spatial)
    rng = np.random.default_rng(5)
    left = _chunks(rng, 200, 2_000, 6)
    right = _chunks(rng, 200, 2_000, 6, shift=0.2)
    with pytest.raises(RuntimeError, match="native"):
        list(_port(1.0, 0.5).run_soa_panes(_copies(left), _copies(right),
                                           0.5, 6, backend="native"))
    op = _port(1.0, 0.5)
    auto = list(op.run_soa_panes(_copies(left), _copies(right), 0.5, 6))
    assert op.pane_scans and auto  # the device engine scanned


def test_the_build_lock_serialises_processes():
    """``ensure_built`` runs make (a no-op when up to date) under an
    exclusive lock on the Makefile: while this process holds it, another
    cannot take it."""
    assert native.ensure_built()
    probe = ("import fcntl, os, sys; fd = os.open(sys.argv[1], os.O_RDONLY)\n"
             "try:\n    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
             "    print('taken')\nexcept BlockingIOError:\n"
             "    print('held')\n")
    makefile = os.path.join(native._NATIVE_DIR, "Makefile")
    with native._build_lock():
        out = subprocess.run([sys.executable, "-c", probe, makefile],
                             capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "held"
    out = subprocess.run([sys.executable, "-c", probe, makefile],
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "taken"


# ---------------------------------------------------------------------------
# The native CSV parser feeding an operator


def test_csv_chunk_source_through_the_native_parser(tmp_path):
    from spatialflink_tpu_torch.models.objects import Polygon
    from spatialflink_tpu_torch.operators import PointPolygonRangeQuery
    from spatialflink_tpu_torch.streams.soa import csv_chunk_source

    rng = np.random.default_rng(51)
    n = 6_000
    ts = np.sort(rng.integers(0, 3_000, n)).astype(np.int64)
    x, y = rng.uniform(0, 10, n), rng.uniform(0, 10, n)
    oid = np.arange(n) % 97
    path = tmp_path / "points.csv"
    path.write_text("".join(f"{o},{t},{a!r},{b!r}\n" for o, t, a, b in
                            zip(oid.tolist(), ts.tolist(), x.tolist(),
                                y.tolist())))
    parser = native.NativePointParser()
    chunks = list(csv_chunk_source(str(path), parser, chunk_bytes=50_000))
    assert len(chunks) > 2
    cat = {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
    assert np.array_equal(cat["ts"], ts)
    assert np.array_equal(cat["x"].view(np.uint64), x.view(np.uint64))
    assert [int(parser.object_name(int(o))) for o in cat["oid"]] == \
        oid.tolist()
    polys = [Polygon(obj_id=f"q{i}", timestamp=0, rings=[np.array(
        [[c, c], [c + 1.5, c], [c + 1.5, c + 1.5], [c, c]], float)])
        for i, c in enumerate((1.0, 4.0, 7.0))]
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    grid = UniformGrid(**GRID)

    def windows(stream):
        op = PointPolygonRangeQuery(conf, grid, device="cpu")
        return [(s, e, {k: np.asarray(v).tolist() for k, v in m.items()},
                 d.tolist()) for s, e, m, d in op.run_soa(stream, polys,
                                                           0.2)]

    direct = [{"ts": ts, "x": x, "y": y, "oid": oid.astype(np.int32)}]
    assert windows(iter(chunks)) == windows(iter(direct))
