"""qserve: multi-tenant standing-query serving.

GeoFlink runs one spatial query per Flink job (CIKM 2020 §IV). A serving
deployment is the opposite: thousands of standing range and kNN queries,
registered and unregistered by many tenants while the stream runs,
against one object stream. This module is that serving layer, with the
semantics of the JAX package's ``spatialflink_tpu/qserve.py``:

- **Standing-query registry** (:class:`QueryRegistry`): tenants register
  and unregister :class:`StandingQuery` s through :class:`QServeCommand` s
  riding the event stream. Commands apply at window fires, in event-time
  order, exactly once: the ``_applied`` uid set makes refires and
  crash/retry replays idempotent. Registration strings (qid, tenant)
  intern into the operator's objID table, the one intern home.
- **Bucketed evaluation**: live queries group by ``(kind, k-rung,
  radius-class)`` and each bucket pads onto a power-of-two capacity rung
  of the compaction ladder (``ops/compaction.py:pick_capacity``, floored
  by the overload ``clamp_compaction`` rung), then evaluates as one
  fixed-shape program a window (``ops/query_registry.py:
  registry_bucket_kernel``; the radius is a per-lane operand and padded
  lanes are masked). Churn therefore moves between at most ladder-many
  signatures per (rung, nseg) pair: the telemetry distinct-shape
  detector is the guard, and the rung picks land in
  ``snapshot()["compaction"]`` under ``qserve_bucket``.
- **Per-tenant QoS**: registration admission and per-window result
  budgets come from ``overload.OverloadPolicy.tenant_budgets``. A class
  over budget has its registrations rejected (``qserve_evicted``) or its
  result rows truncated, counted per class in
  ``snapshot()["overload"]["tenants"]`` and budgeted by
  ``slo.SloSpec.tenant_budgets``: one firehose tenant degrades itself,
  never the fleet.
- **Crash safety**: the registry state (queries, applied-command uids,
  counters) snapshots with the operator (``checkpoint.py``), so a kill
  mid-churn resumes to byte-identical per-tenant egress (the
  ``qserve.register`` fault point).

:func:`install` puts one registry in the module slot, and
``telemetry.snapshot()["qserve"]`` carries its counters. ``SFT_QSERVE``
(inline JSON or a path) supplies a serving config: ``{"queries": [...],
"tenant_budgets": {...}, "cap_max": N}``.

The operator runs on the card unless it is given ``device="cpu"``. Its
``dtype`` follows the JAX package's rule (``precision.effective_f64``):
with ``dtype`` float64 (the default) and the float64 mode on, the window
points and the query centres ship raw in float64 and the registry
program computes, compares the radius, takes its sentinel and returns
its distances in float64, as the JAX program does under x64; otherwise
it computes in float32 on the device, with coordinates centred in
float64 first (``operators/base.py:center_coords``), and the float64
radii make the radius test the JAX package's under x64. ``mesh=``: every
bucket runs through ``parallel/sharded.py:sharded_registry_bucket``, the
window's points sharded over the mesh's ``data`` axis, with the
unsharded results, in float64 as in float32.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import asdict, dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch import overload
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators.base import (
    SpatialOperator,
    center_coords,
    flags_for_queries,
    jitted,
    ship,
)
from spatialflink_tpu_torch.precision import effective_f64
from spatialflink_tpu_torch.telemetry import telemetry
from spatialflink_tpu_torch.utils.padding import next_bucket

QSERVE_VERSION = 1

#: Smallest bucket-capacity and result rung: the compaction ladder's
#: floor, so one bucket compiles at most len(capacity_ladder(cap_max, 8))
#: signatures per (rung, nseg) pair.
QUERY_RUNG_MIN = 8

#: Default bucket-capacity ceiling: a bucket never exceeds this many query
#: lanes; registrations beyond it are evicted, counted.
QUERY_CAP_MAX = 1024

#: Radius-class base (degrees, ~110 m): queries whose radii fall in the
#: same power-of-two band share a bucket. Grouping only, never a shape:
#: it keeps a bucket's pruning tables homogeneous, so one wide query
#: cannot dominate a bucket of tight ones.
RADIUS_CLASS_BASE = 0.001

_KINDS = ("range", "knn")

@dataclass(frozen=True)
class StandingQuery:
    """One registered continuous query.

    ``k``: for ``knn`` the neighbour count; for ``range`` the result
    capacity (the most matches returned a window; distinct in-radius
    objects beyond it count into the registry's
    ``range_result_overflow`` through the kernel's unclamped ``within``).
    """

    qid: str
    tenant: str
    kind: str
    x: float
    y: float
    radius: float
    k: int = 10
    tenant_class: str = "default"

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(
                f"unknown query kind {self.kind!r} (kinds: {_KINDS})")
        if not self.qid:
            raise ValueError("qid must be non-empty")
        if not (float(self.radius) > 0.0):
            raise ValueError(f"radius must be positive, got {self.radius!r}")
        if int(self.k) < 1:
            raise ValueError(f"k must be >= 1, got {self.k!r}")

    def to_dict(self) -> Dict[str, Any]:
        return asdict(self)


@dataclass(frozen=True)
class QServeCommand:
    """A registration command riding the event stream. ``uid`` is the
    exactly-once key: window refires and crash/retry replays re-apply
    commands through the registry's ``_applied`` set, so a duplicate uid
    is a no-op."""

    timestamp: int
    action: str  # "register" | "unregister"
    uid: str
    query: Optional[StandingQuery] = None  # register
    qid: Optional[str] = None  # unregister

    #: Overload admission measures control-plane items as zero load and
    #: never sheds them (``overload._measure_item``): a shed command would
    #: diverge the registry from the command stream.
    control_plane = True

    def __post_init__(self):
        if self.action not in ("register", "unregister"):
            raise ValueError(f"unknown qserve action {self.action!r}")
        if self.action == "register" and self.query is None:
            raise ValueError("register command needs a query")
        if self.action == "unregister" and not self.qid:
            raise ValueError("unregister command needs a qid")
        if not self.uid:
            raise ValueError("command uid must be non-empty")


def query_rung(q: StandingQuery) -> int:
    """Result-capacity rung: the smallest power of two >= k (floor 8),
    the one per-query value that becomes a static of the program."""
    return int(next_bucket(max(int(q.k), 1), minimum=QUERY_RUNG_MIN))


def radius_class(radius: float) -> int:
    """Power-of-two radius band above ``RADIUS_CLASS_BASE`` (a grouping
    key only)."""
    r = float(radius)
    if r <= RADIUS_CLASS_BASE:
        return 0
    return max(0, int(math.ceil(math.log2(r / RADIUS_CLASS_BASE))))


def bucket_key(q: StandingQuery) -> Tuple[str, int, int]:
    return (q.kind, query_rung(q), radius_class(q.radius))


def bucket_key_str(key: Tuple[str, int, int]) -> str:
    return f"{key[0]}_k{int(key[1])}_rc{int(key[2])}"


def _query_flags(grid, q: StandingQuery) -> np.ndarray:
    return flags_for_queries(grid, q.radius, [Point(x=q.x, y=q.y)])


class QueryRegistry:
    """The standing-query set and exactly-once command application.

    Confined to the driver thread, like operator state, so it takes no
    lock and the telemetry provider cannot deadlock. ``interner`` is the
    owning operator's objID interner: qid and tenant strings intern there
    on a successful registration."""

    def __init__(self, grid, interner, cap_max: int = QUERY_CAP_MAX):
        self.grid = grid
        self.interner = interner
        self.cap_max = int(cap_max)
        self._queries: Dict[str, StandingQuery] = {}
        self._flags: Dict[str, np.ndarray] = {}  # qid → neighbour table
        self._versions: Dict[Tuple[str, int, int], int] = {}
        self._bucket_live: Dict[Tuple[str, int, int], int] = {}
        #: command uid → command event time (the exactly-once set, pruned
        #: behind the watermark by ``prune_applied``)
        self._applied: Dict[str, int] = {}
        #: bumped on restore, so device caches keyed on (epoch, version)
        #: never serve a pre-restore array.
        self.epoch = 0
        self.registered_total = 0
        self.unregistered_total = 0
        self.evicted_total = 0
        self.range_result_overflow = 0
        # The last window charged to the overflow counter: a driver retry
        # re-runs the same window's process(), which must not add twice.
        self._overflow_window: Optional[int] = None
        self._overflow_last = 0

    def __len__(self) -> int:
        return len(self._queries)

    def query(self, qid: str) -> Optional[StandingQuery]:
        return self._queries.get(qid)

    def flags(self, qid: str) -> np.ndarray:
        return self._flags[qid]

    def version(self, key: Tuple[str, int, int]) -> int:
        return self._versions.get(key, 0)

    def _bump(self, key: Tuple[str, int, int]):
        self._versions[key] = self._versions.get(key, 0) + 1

    # -- command application (exactly once) -----------------------------------

    def apply(self, cmd: QServeCommand) -> bool:
        """Apply one command; True iff it changed the registry. Duplicate
        uids (window refires, crash/retry replays) are no-ops."""
        if faults.armed:  # fault injection point (faults.py)
            faults.hit("qserve.register")
        if cmd.uid in self._applied:
            return False
        self._applied[cmd.uid] = int(cmd.timestamp)
        if cmd.action == "register":
            return self._register(cmd.query)
        return self._unregister(cmd.qid)

    def prune_applied(self, watermark_ts: int, horizon_ms: int):
        """Drop applied uids whose command is older than ``watermark -
        horizon``: a command replays only through a refire or a resume,
        which reach back at most a window span behind the watermark, so
        older uids can never be seen again and would only grow every
        checkpoint."""
        cut = int(watermark_ts) - int(horizon_ms)
        stale = [uid for uid, ts in self._applied.items() if ts < cut]
        for uid in stale:
            del self._applied[uid]

    def record_range_overflow(self, window_start: int, count: int):
        """Charge one window's range-result truncation to the running
        counter, idempotently: charging the same window again (a driver
        retry re-running ``process``) replaces the previous charge."""
        if self._overflow_window == int(window_start):
            self.range_result_overflow -= self._overflow_last
        self._overflow_window = int(window_start)
        self._overflow_last = int(count)
        self.range_result_overflow += int(count)

    def _register(self, q: StandingQuery) -> bool:
        if q.qid in self._queries:
            return False  # idempotent re-register
        key = bucket_key(q)
        if self._bucket_live.get(key, 0) >= self.cap_max:
            # The ladder tops out at cap_max: the bucket cannot take
            # another lane. Deterministic eviction, counted.
            self.evicted_total += 1
            if telemetry.enabled:
                telemetry.emit_instant(
                    "qserve_evicted", qid=q.qid,
                    tenant_class=q.tenant_class, reason="bucket_full")
            return False
        if not overload.admit_tenant_query(q.tenant_class):
            # The class is over its standing-query budget
            # (overload tenant_budgets): rejected and counted.
            self.evicted_total += 1
            if telemetry.enabled:
                telemetry.emit_instant(
                    "qserve_evicted", qid=q.qid,
                    tenant_class=q.tenant_class, reason="tenant_budget")
            return False
        self.interner.intern(q.tenant)
        self.interner.intern(q.qid)
        self._queries[q.qid] = q
        self._flags[q.qid] = _query_flags(self.grid, q)
        self._bucket_live[key] = self._bucket_live.get(key, 0) + 1
        self.registered_total += 1
        self._bump(key)
        if telemetry.enabled:
            telemetry.emit_instant(
                "qserve_registered", qid=q.qid, tenant=q.tenant,
                tenant_class=q.tenant_class, kind=q.kind)
        return True

    def _unregister(self, qid: str) -> bool:
        q = self._queries.pop(qid, None)
        if q is None:
            return False  # idempotent re-unregister
        self._flags.pop(qid, None)
        key = bucket_key(q)
        self._bucket_live[key] = max(0, self._bucket_live.get(key, 1) - 1)
        overload.release_tenant_query(q.tenant_class)
        self.unregistered_total += 1
        self._bump(key)
        if telemetry.enabled:
            telemetry.emit_instant(
                "qserve_unregistered", qid=qid, tenant_class=q.tenant_class)
        return True

    # -- bucketing ------------------------------------------------------------

    def buckets(self) -> Dict[Tuple[str, int, int], List[StandingQuery]]:
        """Live queries grouped by (kind, k-rung, radius-class), qid-sorted
        within each bucket: the evaluation order byte-identical egress
        rests on."""
        out: Dict[Tuple[str, int, int], List[StandingQuery]] = {}
        for qid in sorted(self._queries):
            q = self._queries[qid]
            out.setdefault(bucket_key(q), []).append(q)
        return out

    # -- checkpoint state -----------------------------------------------------

    def state(self) -> Dict[str, Any]:
        return {
            "version": QSERVE_VERSION,
            "queries": [self._queries[qid].to_dict()
                        for qid in sorted(self._queries)],
            "applied": sorted([uid, int(ts)]
                              for uid, ts in self._applied.items()),
            "counters": {
                "registered_total": int(self.registered_total),
                "unregistered_total": int(self.unregistered_total),
                "evicted_total": int(self.evicted_total),
                "range_result_overflow": int(self.range_result_overflow),
                "overflow_window": self._overflow_window,
                "overflow_last": int(self._overflow_last),
            },
        }

    def restore(self, state: Dict[str, Any]):
        ver = state.get("version", QSERVE_VERSION)
        if ver != QSERVE_VERSION:
            raise ValueError(
                f"qserve state version {ver} != supported {QSERVE_VERSION}")
        self._queries = {}
        self._flags = {}
        for d in state["queries"]:
            q = StandingQuery(**d)
            self._queries[q.qid] = q
            # Flag tables are derived data, rebuilt from the grid.
            self._flags[q.qid] = _query_flags(self.grid, q)
        self._applied = {uid: int(ts) for uid, ts in state["applied"]}
        self._bucket_live = {}
        for q in self._queries.values():
            key = bucket_key(q)
            self._bucket_live[key] = self._bucket_live.get(key, 0) + 1
        c = state["counters"]
        self.registered_total = int(c["registered_total"])
        self.unregistered_total = int(c["unregistered_total"])
        self.evicted_total = int(c["evicted_total"])
        self.range_result_overflow = int(c["range_result_overflow"])
        ow = c.get("overflow_window")
        self._overflow_window = None if ow is None else int(ow)
        self._overflow_last = int(c.get("overflow_last", 0))
        self._versions = {}
        self.epoch += 1  # invalidate the operator's device caches

    # -- telemetry provider ---------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """The ``snapshot()["qserve"]`` block: the counters, each bucket's
        occupancy against its current rung, and the bucket program's
        distinct signatures."""
        from spatialflink_tpu_torch.ops.compaction import pick_capacity

        buckets = {
            bucket_key_str(key): {
                "live": len(qs),
                "capacity": int(pick_capacity(len(qs), self.cap_max,
                                              minimum=QUERY_RUNG_MIN)),
            }
            for key, qs in sorted(self.buckets().items())
        }
        return {
            "version": QSERVE_VERSION,
            "registered": len(self._queries),
            "registered_total": int(self.registered_total),
            "unregistered_total": int(self.unregistered_total),
            "evicted_total": int(self.evicted_total),
            "range_result_overflow": int(self.range_result_overflow),
            "buckets": buckets,
            "recompiles": telemetry.distinct_shapes("registry_bucket_kernel"),
        }


def bucket_host_arrays(grid, queries: List[StandingQuery], cap: int,
                       flags_of=None):
    """Padded host arrays for one bucket: (qxy (cap, 2) float64 uncentred,
    radius (cap,) float64, qvalid (cap,) bool, tables (cap, num_cells + 1)
    uint8). ``flags_of(q)`` overrides the per-query neighbour-table source
    (by default computed from the grid)."""
    if len(queries) > cap:
        raise ValueError(f"{len(queries)} queries exceed the {cap} rung")
    qxy = np.zeros((cap, 2), np.float64)
    radius = np.zeros(cap, np.float64)
    qvalid = np.zeros(cap, bool)
    tables = np.zeros((cap, grid.num_cells + 1), np.uint8)
    for i, q in enumerate(queries):
        qxy[i] = (q.x, q.y)
        radius[i] = float(q.radius)
        qvalid[i] = True
        tables[i] = (flags_of(q) if flags_of is not None
                     else _query_flags(grid, q))
    return qxy, radius, qvalid, tables


@dataclass
class QServeWindowResult:
    """One window's served results, routed per tenant.

    ``rows``: (tenant_class, tenant, qid, objID, dist) in bucket, qid and
    rank order, after the per-tenant-class result budgets truncated each
    class's rows (``overload.tenant_result_allowance``)."""

    start: int
    end: int
    rows: List[Tuple[str, str, str, Any, float]]
    window_count: int

    def lines(self) -> Iterator[str]:
        """The per-tenant egress line format."""
        for cls, tenant, qid, obj, dist in self.rows:
            yield (f"{tenant},{qid},{self.start},{self.end},"
                   f"{obj},{float(dist)!r}")

    def by_tenant(self) -> Dict[str, List[Tuple[str, Any, float]]]:
        out: Dict[str, List[Tuple[str, Any, float]]] = {}
        for _cls, tenant, qid, obj, dist in self.rows:
            out.setdefault(tenant, []).append((qid, obj, float(dist)))
        return out


class QServeOperator(SpatialOperator):
    """The serving operator: Point events and QServeCommands in,
    per-tenant standing-query results out, on the shared dataflow driver
    (checkpoint, retry and chaos semantics as the query operators')."""

    def __init__(self, conf, grid, mesh=None, cap_max: int = QUERY_CAP_MAX,
                 device="cuda"):
        super().__init__(conf, grid, device=device, mesh=mesh)
        self.qserve_registry = QueryRegistry(grid, self.interner,
                                             cap_max=cap_max)
        self._bucket_dev: Dict[Tuple[str, int, int], Dict[str, Any]] = {}
        self._last_rung: Dict[Tuple[str, int, int], int] = {}

    @property
    def registry(self) -> QueryRegistry:
        return self.qserve_registry

    def _eval_bucket(self, kernel, mesh, xy_d, valid_d, cell_d, oid_d,
                     arrays, key, rung, cap, nseg):
        """One bucket's program under its ``compute`` span: sharded over
        ``mesh`` when given (``sharded_registry_bucket``)."""
        with telemetry.span("compute", bucket=bucket_key_str(key)):
            if mesh is not None:
                from spatialflink_tpu_torch.parallel.sharded import (
                    sharded_registry_bucket,
                )

                return sharded_registry_bucket(
                    mesh, xy_d, valid_d, cell_d, arrays["tables"], oid_d,
                    arrays["qxy"], arrays["radius"], arrays["qvalid"],
                    k=rung, num_segments=nseg)
            return kernel(xy_d, valid_d, cell_d, arrays["tables"], oid_d,
                          arrays["qxy"], arrays["radius"], arrays["qvalid"],
                          k=rung, num_segments=nseg,
                          query_block=min(cap, 32))

    def _bucket_device_arrays(self, key, qs, cap, dtype):
        """The bucket's operands on the device, cached on (registry epoch,
        bucket version, rung, the lanes' dtype: float64 in the float64
        mode, else float32): a window with no churn ships
        nothing; a register or unregister in the bucket bumps its version
        and ships it once. The host arrays go through ``ship``, which
        copies them: the registry's flag tables are never handed over by
        reference."""
        reg = self.qserve_registry
        lanes = np.float64 if effective_f64(dtype) else np.float32
        ck = (reg.epoch, reg.version(key), int(cap), np.dtype(lanes).str)
        hit = self._bucket_dev.get(key)
        if hit is not None and hit["ck"] == ck:
            return hit
        qxy, radius, qvalid, tables = bucket_host_arrays(
            self.grid, qs, cap, flags_of=lambda q: reg.flags(q.qid))
        tables_d, radius_d, qvalid_d, qxy_d = ship(
            tables, radius, qvalid, center_coords(self.grid, qxy, dtype),
            device=self.device).arrive()
        dev = {"ck": ck, "qxy": qxy_d, "tables": tables_d,
               "radius": radius_d, "qvalid": qvalid_d}
        self._bucket_dev[key] = dev
        return dev

    def run(self, stream: Iterable, dtype=np.float64, mesh=None,
            driver=None) -> Iterator[QServeWindowResult]:
        """Serve the stream: commands apply at window fires (event-time
        order, exactly once), every bucket evaluates as one program, and
        results route per tenant under the per-class result budgets.
        ``driver=`` opts into checkpoints and retry as for the other
        operators; the registry state rides the operator checkpoint.
        ``dtype``: float64 lanes and distances in the float64 mode
        (``precision.py``), centred float32 lanes otherwise."""
        from spatialflink_tpu_torch.driver import strict_driver
        from spatialflink_tpu_torch.ops.query_registry import (
            registry_bucket_kernel,
        )

        mesh = self.run_mesh(mesh)
        if self.conf.allowed_lateness_ms > 0:
            # A late-event refire re-runs a window already charged to the
            # per-window QoS and overflow accumulators (whose retry
            # markers cover only consecutive re-charges), and the
            # applied-uid horizon assumes refires reach at most one
            # window span back.
            raise ValueError(
                "QServeOperator does not support allowed_lateness "
                "(late-window refires would double-charge the per-"
                "tenant shed and range-overflow accumulators)")
        drv = driver if driver is not None else strict_driver()
        drv.attach(self)
        reg = self.qserve_registry
        if registry() is not reg:
            # This run's registry becomes the provider (a previous run's
            # counters must not ride this run's checkpoints), and stays
            # installed for the seal; qserve.uninstall() clears it.
            install(reg)
        kernel = jitted(registry_bucket_kernel)

        def process(win) -> QServeWindowResult:
            return self.serve_window(win, kernel, dtype=dtype, mesh=mesh)

        drv.bind(self, process, fallback=None)
        yield from drv.run(stream)

    def serve_window(self, win, kernel, dtype=np.float64,
                     mesh=None) -> QServeWindowResult:
        """One window's serving pass: apply the window's commands exactly
        once, evaluate every bucket as one program, one fetch for all
        buckets, per-tenant-class result budgets. Retries go through the
        retry-idempotent accumulators (``record_range_overflow``,
        ``tenant_result_allowance``), so re-running a window is safe.
        ``dtype``: ``run``'s rule."""
        from spatialflink_tpu_torch.ops.compaction import pick_capacity

        self.check_mesh(mesh)
        reg = self.qserve_registry
        with telemetry.span("window.qserve", start=win.start,
                            events=len(win.events)):
            cmds = sorted((e for e in win.events
                           if isinstance(e, QServeCommand)),
                          key=lambda c: (c.timestamp, c.uid))
            for cmd in cmds:
                reg.apply(cmd)
            # The uid set need reach only as far back as a refire or a
            # resume can: one window span, the lateness and a slide.
            reg.prune_applied(
                win.start,
                self.conf.window_size_ms + self.conf.allowed_lateness_ms
                + self.conf.slide_step_ms)
            pts = [e for e in win.events if not isinstance(e, QServeCommand)]
            buckets = reg.buckets()
            # A bucket churn emptied must not pin its (cap, num_cells + 1)
            # tables on the device for the rest of the run.
            for key in [k for k in self._bucket_dev if k not in buckets]:
                del self._bucket_dev[key]
            rows: List[Tuple[str, str, str, Any, float]] = []
            win_overflow = 0
            if pts and buckets:
                with telemetry.span("assemble"):
                    batch = self.point_batch(pts)
                    nseg = next_bucket(max(self.interner.num_segments, 1),
                                       minimum=64)
                with telemetry.span("ship"):
                    xy_d, valid_d, cell_d, oid_d = ship(
                        center_coords(self.grid, batch.xy, dtype),
                        batch.valid, batch.cell, batch.oid,
                        device=self.device).arrive()
                pending = []
                # Bucket attribution only when standalone: inside a node
                # scope the window already carries its node.
                standalone = telemetry.current_node() is None
                for key in sorted(buckets):
                    qs = buckets[key]
                    bucket_node = (f"qserve:{bucket_key_str(key)}"
                                   if standalone else None)
                    with telemetry.scope(bucket_node):
                        cap = pick_capacity(len(qs), reg.cap_max,
                                            minimum=QUERY_RUNG_MIN)
                        telemetry.record_compaction("qserve_bucket", cap,
                                                    len(qs))
                        if self._last_rung.get(key) != cap:
                            # A rung move is one new program shape.
                            self._last_rung[key] = cap
                            telemetry.emit_instant(
                                f"qserve_rung:{bucket_key_str(key)}",
                                capacity=int(cap), live=len(qs))
                        arrays = self._bucket_device_arrays(key, qs, cap,
                                                            dtype)
                        res = self._eval_bucket(
                            kernel, mesh, xy_d, valid_d, cell_d, oid_d,
                            arrays, key, int(key[1]), cap, nseg)
                    pending.append((qs, res))
                # One device→host copy for all buckets: every bucket's
                # work is queued before the window's single wait.
                with telemetry.span("fetch"):
                    fetched = telemetry.fetch([
                        (r.num_valid, r.within, r.segment, r.dist)
                        for _qs, r in pending])
                for (qs, _r), (nvs, within, segs, dists) in zip(pending,
                                                               fetched):
                    for lane, q in enumerate(qs):
                        nv = int(nvs[lane])
                        if q.kind == "range":
                            # Truncation against the query's own cap
                            # (k <= rung), counted.
                            win_overflow += max(int(within[lane]) - int(q.k),
                                                0)
                        for r_ in range(min(nv, int(q.k))):
                            rows.append((
                                q.tenant_class, q.tenant, q.qid,
                                self.interner.lookup(int(segs[lane, r_])),
                                float(dists[lane, r_]),
                            ))
            reg.record_range_overflow(win.start, win_overflow)
            # Per-tenant-class result budgets: each class keeps its first
            # `allowance` rows; the excess counts against the class only.
            counts: Dict[str, int] = {}
            for row in rows:
                counts[row[0]] = counts.get(row[0], 0) + 1
            allow = {cls: overload.tenant_result_allowance(
                         cls, n, window_start=win.start)
                     for cls, n in sorted(counts.items())}
            kept: List[Tuple[str, str, str, Any, float]] = []
            used: Dict[str, int] = {}
            for row in rows:
                used[row[0]] = used.get(row[0], 0) + 1
                if used[row[0]] <= allow[row[0]]:
                    kept.append(row)
            return QServeWindowResult(win.start, win.end, kept,
                                      len(win.events))


# -- module-level wiring (the telemetry and overload singleton idiom) ---------

_registry: Optional[QueryRegistry] = None


def install(reg: QueryRegistry) -> QueryRegistry:
    """Make ``reg`` the process-global registry:
    ``telemetry.snapshot()["qserve"]`` carries its counters."""
    global _registry
    _registry = reg
    telemetry.qserve_provider = reg.snapshot
    return reg


def uninstall():
    global _registry
    if _registry is not None:
        telemetry.qserve_provider = None
    _registry = None


def registry() -> Optional[QueryRegistry]:
    return _registry


# -- SFT_QSERVE serving config ------------------------------------------------

_CONFIG_KEYS = ("queries", "tenant_budgets", "cap_max")


def config_from_env() -> Optional[Dict[str, Any]]:
    """``SFT_QSERVE``: inline JSON or a path to a JSON file. Strict: an
    unknown key is a typo, and a budget silently ignored is the worst way
    a QoS config can fail."""
    spec = os.environ.get("SFT_QSERVE")
    if not spec:
        return None
    text = spec.strip()
    if not text.startswith("{"):
        with open(text) as f:
            text = f.read()
    cfg = json.loads(text)
    if not isinstance(cfg, dict):
        raise ValueError(f"SFT_QSERVE must be a JSON object, got {cfg!r}")
    unknown = sorted(set(cfg) - set(_CONFIG_KEYS))
    if unknown:
        raise ValueError(
            f"unknown SFT_QSERVE keys: {unknown} (keys: {_CONFIG_KEYS})")
    return cfg


def queries_from_config(cfg: Dict[str, Any]) -> List[StandingQuery]:
    return [StandingQuery(**d) for d in cfg.get("queries", [])]


def boot_commands(queries: List[StandingQuery],
                  timestamp: int = 0) -> List[QServeCommand]:
    """Registration commands for a static start-up query set (the uids are
    deterministic, so a resume replays them as no-ops)."""
    return [QServeCommand(timestamp=int(timestamp), action="register",
                          uid=f"boot:{q.qid}", query=q)
            for q in queries]
