"""ctypes bindings for the native ingest runtime (``native/sfnative.cpp``).

The port's own binding to the shared library the JAX package builds and
binds: ``native/libsfnative.so``, compiled on demand by ``make -C
native`` with the host's g++ (a plain C ABI, no pybind11). These engines
are host code by nature: CSV and WKT parsers with persistent id
interning, the single-pass sliding trajectory statistics
(``sf_traj_stats``) and the pane-carry tJoin (``sf_tjoin_panes``).

- **ABI guard.** ``_ABI_VERSION`` must equal ``sf_abi_version()``; a
  stale library with the right symbols but older signatures would
  corrupt memory through mismatched ``argtypes``. A mismatch is cached
  and makes :func:`available` False for the rest of the process.
- **Owned buffers.** Every array handed to C is a C-contiguous numpy
  array of the declared dtype that owns its memory (:func:`_owned`),
  never a view of a torch tensor's storage or of a caller's array.
- **Builds.** ``make`` is an incremental no-op when the library is up
  to date. The port's processes serialise their ``make`` and ``dlopen``
  under an advisory lock on ``native/Makefile``, so one never loads a
  library another is still writing.
- **No silent fallback.** :func:`available` says whether the engines
  can run; the callers that force ``backend="native"`` raise when they
  cannot.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libsfnative.so")

_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_abi_mismatch = False
_ABI_VERSION = 4  # must match sf_abi_version() in sfnative.cpp


@contextlib.contextmanager
def _build_lock():
    """An exclusive advisory lock on ``native/Makefile`` around ``make``
    and ``dlopen`` (no file is added to the source tree)."""
    try:
        fd = os.open(os.path.join(_NATIVE_DIR, "Makefile"), os.O_RDONLY)
    except OSError:
        yield
        return
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def _make(quiet: bool) -> bool:
    global _build_failed
    if _build_failed:
        return os.path.exists(_LIB_PATH)
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=quiet)
    except (subprocess.CalledProcessError, FileNotFoundError):
        _build_failed = True
    return os.path.exists(_LIB_PATH)


def ensure_built(quiet: bool = True) -> bool:
    """(Re)build the shared library. Returns availability.

    Always invokes make (an incremental no-op when up to date): merely
    checking for the .so would leave a stale prebuilt library fatal when
    a newly added symbol is looked up."""
    if _build_failed:
        return False
    with _build_lock():
        return _make(quiet)


def _declare(lib: ctypes.CDLL) -> None:
    """Every ``argtypes``/``restype`` of the ABI version 4 library."""
    lib.sf_interner_new.restype = ctypes.c_void_p
    lib.sf_interner_free.argtypes = [ctypes.c_void_p]
    lib.sf_interner_size.argtypes = [ctypes.c_void_p]
    lib.sf_interner_size.restype = ctypes.c_int32
    lib.sf_interner_get.argtypes = [
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.sf_interner_get.restype = ctypes.c_int64
    dbl_p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64_p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32_p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8_p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sf_parse_gps_csv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
        ctypes.c_int64, i64_p, dbl_p, dbl_p, dbl_p, dbl_p, dbl_p, i32_p,
    ]
    lib.sf_parse_gps_csv.restype = ctypes.c_int64
    lib.sf_parse_points_csv.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int64, i64_p, dbl_p, dbl_p, i32_p,
    ]
    lib.sf_parse_points_csv.restype = ctypes.c_int64
    lib.sf_parse_wkt_geoms.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_char,
        ctypes.c_int64, ctypes.c_int64, i64_p, i32_p, i64_p, u8_p, dbl_p,
        u8_p,
        np.ctypeslib.ndpointer(np.int64, shape=(1,), flags="C_CONTIGUOUS"),
    ]
    lib.sf_parse_wkt_geoms.restype = ctypes.c_int64
    lib.sf_traj_stats.argtypes = [
        i64_p, dbl_p, dbl_p, i32_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int64, ctypes.c_int64, dbl_p, i64_p, i64_p,
    ]
    lib.sf_traj_stats.restype = ctypes.c_int64
    lib.sf_tjoin_panes.argtypes = [
        i32_p, dbl_p, dbl_p, i32_p, i32_p, ctypes.c_int64,
        i32_p, dbl_p, dbl_p, i32_p, i32_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_double, dbl_p,
    ]
    lib.sf_tjoin_panes.restype = ctypes.c_int64


def _abi_of(lib: ctypes.CDLL) -> int:
    try:
        lib.sf_abi_version.restype = ctypes.c_int32
        return int(lib.sf_abi_version())
    except AttributeError:
        return -1


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _abi_mismatch
    if _lib is not None:
        return _lib
    if _abi_mismatch or _build_failed:
        return None
    with _build_lock():
        if not _make(quiet=True):
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
    if _abi_of(lib) != _ABI_VERSION:
        # A library rebuilt from this tree cannot fix itself mid-process:
        # cache the rejection so available() stops paying make + dlopen.
        _abi_mismatch = True
        return None
    _declare(lib)
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _owned(a, dtype) -> np.ndarray:
    """``a`` as a C-contiguous ``dtype`` numpy array that owns its memory:
    a torch tensor is copied to the host, and any array that is not
    already such an owner (a view, a strided column, another dtype) is
    copied, so C never reads memory the port does not own."""
    if hasattr(a, "detach"):  # a torch tensor
        a = a.detach().cpu().numpy()
    if (isinstance(a, np.ndarray) and a.dtype == dtype
            and a.flags.c_contiguous and a.flags.owndata):
        return a
    return np.array(a, dtype=dtype, order="C", copy=True)


def traj_stats_native(ts, x, y, oid, num_oids: int, size_ms: int,
                      slide_ms: int):
    """Single-pass pane-decomposed sliding trajectory stats
    (``sf_traj_stats``), the native engine behind
    ``streams/panes.py:traj_stats_sliding``. ``ts`` must be ascending.
    Returns (n_starts, spatial, temporal, count) as full (n_starts,
    num_oids) matrices, or None when the library is unavailable.
    Bit-identical to the numpy engine (the same float association
    order) and to the JAX package's binding of the same library."""
    lib = _load()
    if lib is None:
        return None
    ts = _owned(ts, np.int64)
    x = _owned(x, np.float64)
    y = _owned(y, np.float64)
    oid32 = _owned(oid, np.int32)
    n = len(ts)
    ppw = size_ms // slide_ms
    if n == 0:
        return 0, *(np.zeros((0, num_oids), d)
                    for d in (np.float64, np.int64, np.int64))
    p_lo = int(np.floor_divide(int(ts[0]), slide_ms))
    p_hi = int(np.floor_divide(int(ts[-1]), slide_ms))
    n_starts = (p_hi - p_lo + 1) + ppw - 1
    spatial = np.empty((n_starts, num_oids), np.float64)
    temporal = np.empty((n_starts, num_oids), np.int64)
    count = np.empty((n_starts, num_oids), np.int64)
    rc = lib.sf_traj_stats(
        ts, x, y, oid32, n, num_oids, size_ms, slide_ms,
        spatial.reshape(-1), temporal.reshape(-1), count.reshape(-1),
    )
    if rc < 0:
        raise ValueError(f"oid out of [0, {num_oids}) in traj_stats_native")
    assert rc == n_starts
    return n_starts, spatial, temporal, count


def tjoin_panes_native(l_pane, l_x, l_y, l_cell, l_oid,
                       r_pane, r_x, r_y, r_cell, r_oid,
                       n_slides: int, grid_n: int, layers: int, ppw: int,
                       num_ids: int, radius: float):
    """Pane-carry tJoin (``sf_tjoin_panes``), the native CPU engine behind
    ``TJoinQuery.run_soa_panes(backend="native")``. Events must be
    sorted by pane index (rebased to 0) and in-grid. Exact by
    construction (no capW/pair_sel budgets), computed in float64 from the
    given coordinates; returns the (n_slides, num_ids²) per-window
    trajectory-pair minimum-distance matrix (+inf = no pair), or None
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((n_slides, num_ids * num_ids), np.float64)
    rc = lib.sf_tjoin_panes(
        _owned(l_pane, np.int32), _owned(l_x, np.float64),
        _owned(l_y, np.float64), _owned(l_cell, np.int32),
        _owned(l_oid, np.int32), len(l_pane),
        _owned(r_pane, np.int32), _owned(r_x, np.float64),
        _owned(r_y, np.float64), _owned(r_cell, np.int32),
        _owned(r_oid, np.int32), len(r_pane),
        n_slides, grid_n, layers, ppw, num_ids, float(radius),
        out.reshape(-1),
    )
    if rc < 0:
        raise ValueError(
            "tjoin_panes_native: oid/cell/pane out of range or panes "
            "not sorted"
        )
    return out


class _NativeInternerParser:
    """Shared ctypes lifecycle for the native parsers: library handle,
    interner ownership, id→string lookups, delimiter encoding."""

    def __init__(self, delimiter: str = ","):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.sf_interner_new()
        self.delimiter = delimiter.encode()[:1]

    def __del__(self):
        if getattr(self, "_h", None) and self._lib is not None:
            self._lib.sf_interner_free(self._h)
            self._h = None

    @property
    def num_objects(self) -> int:
        return int(self._lib.sf_interner_size(self._h))

    def object_name(self, oid: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.sf_interner_get(self._h, oid, buf, 256)
        if n < 0:
            raise KeyError(oid)
        return buf.value.decode()


def _as_bytes(data) -> bytes:
    """The parse buffer as immutable bytes the port owns."""
    if isinstance(data, str):
        return data.encode()
    return bytes(data)


class NativeGpsParser(_NativeInternerParser):
    """Buffer-at-a-time 14-column GPS CSV parser with device interning.

    ``parse(data)`` → dict of SoA numpy arrays (ts, lon, lat, speed, fa,
    ff, dev). Device ids are dense int32, stable across calls; decode with
    ``device_name(id)`` / ``device_table()``.
    """

    def parse(self, data) -> Dict[str, np.ndarray]:
        data = _as_bytes(data)
        max_rows = data.count(b"\n") + 1
        ts = np.empty(max_rows, np.int64)
        lon = np.empty(max_rows, np.float64)
        lat = np.empty(max_rows, np.float64)
        speed = np.empty(max_rows, np.float64)
        fa = np.empty(max_rows, np.float64)
        ff = np.empty(max_rows, np.float64)
        dev = np.empty(max_rows, np.int32)
        n = self._lib.sf_parse_gps_csv(
            self._h, data, len(data), self.delimiter, max_rows,
            ts, lon, lat, speed, fa, ff, dev,
        )
        return {
            "ts": ts[:n], "lon": lon[:n], "lat": lat[:n], "speed": speed[:n],
            "fa": fa[:n], "ff": ff[:n], "dev": dev[:n],
        }

    @property
    def num_devices(self) -> int:
        return int(self._lib.sf_interner_size(self._h))

    def device_name(self, dev_id: int) -> str:
        buf = ctypes.create_string_buffer(256)
        n = self._lib.sf_interner_get(self._h, dev_id, buf, 256)
        if n < 0:
            raise KeyError(dev_id)
        return buf.value.decode()

    def device_table(self) -> List[str]:
        return [self.device_name(i) for i in range(self.num_devices)]


class NativePointParser(_NativeInternerParser):
    """Schema-positional point CSV parser (csvTsvSchemaAttr semantics):
    ``schema`` gives the columns of (oid, ts, x, y)."""

    def __init__(self, schema=(0, 1, 2, 3), delimiter: str = ","):
        super().__init__(delimiter)
        self.schema = tuple(int(i) for i in schema)

    def parse(self, data) -> Dict[str, np.ndarray]:
        data = _as_bytes(data)
        max_rows = data.count(b"\n") + 1
        ts = np.empty(max_rows, np.int64)
        x = np.empty(max_rows, np.float64)
        y = np.empty(max_rows, np.float64)
        oid = np.empty(max_rows, np.int32)
        i_oid, i_ts, i_x, i_y = self.schema
        n = self._lib.sf_parse_points_csv(
            self._h, data, len(data), self.delimiter,
            i_oid, i_ts, i_x, i_y, max_rows, ts, x, y, oid,
        )
        return {"ts": ts[:n], "x": x[:n], "y": y[:n], "oid": oid[:n]}


class NativeWktParser(_NativeInternerParser):
    """WKT geometry-line parser → ragged SoA chunks.

    Wire format: ``objID<delim>timestamp<delim>WKT`` (the reference's WKT
    trajectory lines). POLYGONs (any ring count, holes included) and
    LINESTRINGs parse natively into the chunk layout
    ``RaggedSoaWindowAssembler``/``GeometryBatch.from_ragged`` take
    (rings closed and seam edges invalidated through the flat
    ``edge_valid`` mask); other or malformed lines are skipped and
    counted (``last_skipped``) for the Python object path to handle.
    """

    def __init__(self, delimiter: str = ","):
        super().__init__(delimiter)
        self.last_skipped = 0

    def parse(self, data) -> Dict[str, np.ndarray]:
        data = _as_bytes(data)
        max_rows = data.count(b"\n") + 1
        # Vertex upper bound: every parsed vertex is followed by a ',' or
        # ')' and ring closing can add one vertex per ring (each ring ends
        # with its own ')'): counting both keeps the library's capacity
        # early-stop unreachable.
        max_verts = data.count(b",") + data.count(b")") + 2 * max_rows + 2
        ts = np.empty(max_rows, np.int64)
        oid = np.empty(max_rows, np.int32)
        lengths = np.empty(max_rows, np.int64)
        polygonal = np.empty(max_rows, np.uint8)
        verts = np.empty((max_verts, 2), np.float64)
        edges = np.empty(max_verts, np.uint8)
        skipped = np.zeros(1, np.int64)
        n = self._lib.sf_parse_wkt_geoms(
            self._h, data, len(data), self.delimiter,
            max_rows, max_verts, ts, oid, lengths, polygonal,
            verts.reshape(-1), edges, skipped,
        )
        self.last_skipped = int(skipped[0])
        total = int(lengths[:n].sum())
        return {
            "ts": ts[:n].copy(),
            "oid": oid[:n].copy(),
            "lengths": lengths[:n].copy(),
            "polygonal": polygonal[:n].copy(),
            "verts": verts[:total].copy(),
            "edge_valid": edges[:total - n].astype(bool) if n else
            np.zeros(0, bool),
        }
