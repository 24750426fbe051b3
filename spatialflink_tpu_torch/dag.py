"""One resumable DAG: N operator nodes on ONE source, interner and
window clock, checkpointed as a unit.

The SNCB Q1–Q5 + StayTime/CheckIn suite the reference evaluates per
operator runs here as one multi-operator dataflow sharing one ingest
(the JAX package's ``spatialflink_tpu/dag.py``, name for name):

- **One shared source, interner and window clock**: a
  :class:`DataflowDAG` owns one :class:`WindowAssembler` and one
  ``Interner``; every node processes the same fired windows, so ingest,
  window assembly and string interning are paid once for N queries.
- **The atomic unit checkpoint**: source position, the shared assembler
  and interner, every node's backend, counters and substate (the qserve
  registry, CheckIn's occupancy) and every sink's committed marker
  publish as ONE framed-CRC checkpoint (``checkpoint.py``), with the
  staged egress of all sinks durably appended first through
  :class:`streams.sinks.MultiSink`. A kill anywhere, between one sink's
  commit and the next included (the ``dag.commit`` injection point),
  resumes with byte-identical egress on every sink.
- **Per-node self-healing stays independent**: each node carries its own
  retry ladder, device→numpy failover and, with an overload breaker
  policy armed, its own :class:`overload.CircuitBreaker`; one node
  failing over never degrades its siblings (the ``dag.node`` injection
  point fires on each node's device-path attempt). A stateful node
  (``idempotent = False``, CheckIn's occupancy walk) crashes for resume
  instead of re-running a half-applied window.
- **Overload runs once at the shared source**: the driver's admission
  and shedding see the one stream, and the controller's state rides the
  unit checkpoint, so a kill mid-shed resumes to the exact shed schedule.
- **Per-node freshness SLOs**: ``slo.SloSpec.node_budgets`` reads
  :func:`active` live; ``telemetry.snapshot()["dag"]`` carries the same
  per-node counters post hoc.

Device: the nodes that reach the card (Q1, Q2 and Q5's zone test,
StayTime's segment sums, qserve's registry bucket program) take
``device`` as a keyword after the JAX parameters, the card unless the
caller asks for ``"cpu"``; a missing card raises. Q3, Q4 and CheckIn walk
on the host. Each device node's numpy twin is its ``fallback_process``.

Execution rides :class:`WindowedDataflowDriver`: the DAG is the driver's
operator (assembler, interner, checkpoint protocol), its per-window
process walks the node list, and that walk is marked non-idempotent, so
the driver never re-runs a window whose earlier nodes already staged
egress (per-node retry happens inside the walk).

``python -m spatialflink_tpu_torch.dag --smoke`` is the per-commit proof:
the 7-node SNCB DAG under an armed overload policy, killed between two
sink commits by an ``abort`` fault, resumed, every sink byte-identical,
with the clean child's sealed ledger stream carrying all seven node
buckets and the killed child's truncated stream recovering them
(``tools/sfprof``), and a ``--mesh-child`` whose sharded kernels on an
8-shard mesh of its device must account collective bytes into its
sealed stream.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.checkpoint import CheckpointCorruptError
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.driver import (
    RetryPolicy,
    WindowedDataflowDriver,
    strict_driver,
)
from spatialflink_tpu_torch.faults import faults
from spatialflink_tpu_torch.mn.metrics import FixedBucketLatency, json_safe
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.streams.sinks import (
    MultiSink,
    TransactionalFileSink,
)
from spatialflink_tpu_torch.streams.windows import (
    SlidingEventTimeWindows,
    WindowAssembler,
    WindowBatch,
)
from spatialflink_tpu_torch.telemetry import telemetry
from spatialflink_tpu_torch.utils.interning import Interner

DAG_VERSION = 1


# ---------------------------------------------------------------------------
# Nodes


class DagNode:
    """One operator node. Subclasses implement :meth:`process` (the
    device path), optionally :attr:`fallback_process` (the numpy twin the
    per-node failover and breaker route to), and :meth:`render` (the
    node's deterministic egress line format). Node-local state beyond the
    runtime counters goes through :meth:`substate` /
    :meth:`restore_substate` and rides the unit checkpoint."""

    #: False = stateful process (a retry would double-apply): the
    #: per-node ladder crashes for resume instead of re-running.
    idempotent = True
    #: Numpy/host twin; ``None`` = no failover route for this node (an
    #: exhausted device path crashes the run for resume).
    fallback_process = None

    def __init__(self, name: str, upstream: Optional[str] = None):
        if not name:
            raise ValueError("node name must be non-empty")
        self.name = name
        #: Optional name of a node this one consumes (topological order;
        #: the upstream's window result arrives in ``results``).
        self.upstream = upstream
        self.dag: Optional["DataflowDAG"] = None

    def bind(self, dag: "DataflowDAG") -> None:
        """Attach to the DAG (shared grid, interner, conf); called once at
        construction, before any checkpoint restore."""
        self.dag = dag

    def process(self, win: WindowBatch, results: Dict[str, Any]):
        raise NotImplementedError

    def render(self, result, start: int, end: int) -> Iterator[str]:
        raise NotImplementedError

    def substate(self) -> Optional[Dict[str, Any]]:
        return None

    def restore_substate(self, state: Dict[str, Any]) -> None:
        pass


def _gps_events(win: WindowBatch) -> list:
    from spatialflink_tpu_torch.sncb.common import GpsEvent

    return [e for e in win.events if isinstance(e, GpsEvent)]


class Q1Node(DagNode):
    """High-risk-zone proximity (Q1_HighRisk): the zone test on
    ``device`` with the numpy twin."""

    def __init__(self, name: str, zones, radius_m: float = 20.0,
                 device="cuda"):
        super().__init__(name)
        from spatialflink_tpu_torch.sncb.queries import buffer_q1_zones

        self.zones = buffer_q1_zones(zones, radius_m)
        self.device = resolve_device(device)

    def process(self, win, results):
        from spatialflink_tpu_torch.sncb.queries import q1_window

        return q1_window(_gps_events(win), self.zones, device=self.device)

    def fallback_process(self, win, results):
        from spatialflink_tpu_torch.sncb.queries import q1_window

        return q1_window(_gps_events(win), self.zones, backend="numpy")

    def render(self, result, start, end):
        for ev in result:
            yield (f"{start},{end},{ev.raw.device_id},"
                   f"{float(ev.x_wgs84)!r},{float(ev.y_wgs84)!r}")


class Q2Node(DagNode):
    """Brake-pressure variation outside maintenance zones (Q2)."""

    def __init__(self, name: str, zones, var_fa_min: float = 0.6,
                 var_ff_max: float = 0.5, device="cuda"):
        super().__init__(name)
        self.zones = list(zones)
        self.var_fa_min = var_fa_min
        self.var_ff_max = var_ff_max
        self.device = resolve_device(device)

    def _run(self, win, backend):
        from spatialflink_tpu_torch.sncb.queries import q2_window

        return q2_window(_gps_events(win), self.zones, win.start, win.end,
                         self.var_fa_min, self.var_ff_max, backend=backend,
                         device=self.device)

    def process(self, win, results):
        return self._run(win, "device")

    def fallback_process(self, win, results):
        return self._run(win, "numpy")

    def render(self, result, start, end):
        for o in result:
            yield (f"{start},{end},{o.device_id},{float(o.var_fa)!r},"
                   f"{float(o.var_ff)!r},{o.count}")


class Q3Node(DagNode):
    """Per-device window trajectory WKT (Q3): a host walk."""

    def process(self, win, results):
        from spatialflink_tpu_torch.sncb.queries import q3_window

        return q3_window(_gps_events(win), win.start, win.end)

    def render(self, result, start, end):
        for o in result:
            yield f"{start},{end},{o.device_id},{o.wkt}"


class Q4Node(DagNode):
    """Q3 with bbox and time-range pushdown (Q4): a host walk."""

    def __init__(self, name: str, min_lon, max_lon, min_lat, max_lat,
                 t_min: int = 0, t_max: int = 2**62):
        super().__init__(name)
        self.bbox = (float(min_lon), float(max_lon),
                     float(min_lat), float(max_lat))
        self.t_range = (int(t_min), int(t_max))

    def process(self, win, results):
        from spatialflink_tpu_torch.sncb.queries import q4_window

        lo, hi, la, ha = self.bbox
        return q4_window(_gps_events(win), win.start, win.end,
                         lo, hi, la, ha, *self.t_range)

    def render(self, result, start, end):
        for o in result:
            yield f"{start},{end},{o.device_id},{o.wkt}"


class Q5Node(DagNode):
    """Geofenced trajectory + speed thresholds (Q5)."""

    def __init__(self, name: str, zones, avg_threshold: float = 50.0,
                 min_threshold: float = 20.0, device="cuda"):
        super().__init__(name)
        self.zones = list(zones)
        self.avg_threshold = avg_threshold
        self.min_threshold = min_threshold
        self.device = resolve_device(device)

    def _run(self, win, backend):
        from spatialflink_tpu_torch.sncb.queries import q5_window

        return q5_window(_gps_events(win), self.zones, win.start, win.end,
                         self.avg_threshold, self.min_threshold,
                         backend=backend, device=self.device)

    def process(self, win, results):
        return self._run(win, "device")

    def fallback_process(self, win, results):
        return self._run(win, "numpy")

    def render(self, result, start, end):
        for o in result:
            yield (f"{start},{end},{o.device_id},{float(o.avg_speed)!r},"
                   f"{float(o.min_speed)!r},{o.wkt}")


class StayTimeNode(DagNode):
    """Per-cell dwell-time heatmap (apps/StayTime): the segment-sum
    program on ``device`` with the host walk as the failover twin.
    Result: sorted (cellName, dwell_ms) rows."""

    def __init__(self, name: str, device="cuda"):
        super().__init__(name)
        self._kernel = None
        self.device = resolve_device(device)

    def process(self, win, results):
        from spatialflink_tpu_torch.apps.staytime import stay_time_window_soa
        from spatialflink_tpu_torch.operators.base import jitted
        from spatialflink_tpu_torch.ops.trajectory import (
            stay_time_cells_kernel,
        )

        if self._kernel is None:
            self._kernel = jitted(stay_time_cells_kernel)
        evs = _gps_events(win)
        if not evs:
            return []
        grid = self.dag.grid
        ts = np.array([e.ts for e in evs], np.int64)
        oid = np.asarray(
            self.dag.interner.intern_many(e.device_id for e in evs),
            np.int64,
        )
        xy = np.array([[e.lon, e.lat] for e in evs], np.float64)
        hit, dwell = stay_time_window_soa(ts, oid, xy, grid, self._kernel,
                                          device=self.device)
        return [
            (grid.cell_name(int(c)) if int(c) < grid.num_cells else "out",
             int(d))
            for c, d in zip(hit, dwell)
        ]

    def fallback_process(self, win, results):
        from spatialflink_tpu_torch.apps.staytime import stay_time_window

        evs = _gps_events(win)
        if not evs:
            return []
        pts = [Point(obj_id=e.device_id, timestamp=e.ts, x=e.lon, y=e.lat)
               for e in evs]
        per_cell = stay_time_window(pts, self.dag.grid)
        return sorted((name, int(ms)) for name, ms in per_cell.items())

    def render(self, result, start, end):
        for name, ms in sorted(result):
            yield f"{start},{end},{name},{int(ms)}"


class CheckInNode(DagNode):
    """Room-occupancy tracking (apps/CheckIn): STATEFUL. The per-user
    last-event dict and per-room occupancy carry across windows (and ride
    the unit checkpoint as substate), so ``idempotent = False``: a
    half-applied window crashes for resume, never re-runs. Under the
    shared sliding clock each event is processed once: only the window's
    new pane (``ts >= end - slide``) feeds the walk."""

    idempotent = False

    def __init__(self, name: str, room_capacities: Dict[str, int]):
        super().__init__(name)
        self.room_capacities = dict(room_capacities)
        self._occupancy: Dict[str, int] = {}
        self._last: Dict[str, Any] = {}

    def process(self, win, results):
        from spatialflink_tpu_torch.apps.checkin import (
            CheckInEvent,
            _insert_missing,
        )

        pane_start = win.end - self.dag.conf.slide_step_ms
        evs = sorted(
            (e for e in win.events
             if isinstance(e, CheckInEvent) and e.timestamp >= pane_start),
            key=lambda e: (e.timestamp, e.event_id),
        )
        out = []
        for ev in _insert_missing(evs, last=self._last):
            room = ev.room
            self._occupancy[room] = self._occupancy.get(room, 0) + (
                1 if ev.direction == "in" else -1
            )
            out.append((room, self.room_capacities.get(room),
                        self._occupancy[room]))
        return out

    def render(self, result, start, end):
        for room, cap, occ in result:
            yield f"{start},{end},{room},{cap},{occ}"

    def substate(self):
        from dataclasses import asdict

        return {
            "occupancy": dict(self._occupancy),
            "last": {u: asdict(e) for u, e in self._last.items()},
        }

    def restore_substate(self, state):
        from spatialflink_tpu_torch.apps.checkin import CheckInEvent

        self._occupancy = dict(state["occupancy"])
        self._last = {u: CheckInEvent(**d)
                      for u, d in state["last"].items()}


class QServeNode(DagNode):
    """Multi-tenant standing-query serving (``qserve.py``) on the shared
    stream: Point and GpsEvent items serve the registered queries,
    QServeCommands register and unregister exactly once. The registry
    interns into the DAG's table (one intern home) and its state rides
    the unit checkpoint as substate; retries are safe (the registry's
    retry-idempotent accumulators), so the node stays idempotent. The
    bucket program runs on ``device``; there is no numpy twin, as in the
    JAX package."""

    def __init__(self, name: str = "qserve", cap_max: Optional[int] = None,
                 dtype=np.float64, device="cuda"):
        super().__init__(name)
        self.cap_max = cap_max
        self.dtype = dtype
        self.device = resolve_device(device)
        self.op = None
        self._kernel = None

    def bind(self, dag):
        from spatialflink_tpu_torch import qserve as qserve_mod

        super().bind(dag)
        cap = self.cap_max if self.cap_max is not None \
            else qserve_mod.QUERY_CAP_MAX
        op = qserve_mod.QServeOperator(dag.conf, dag.grid, cap_max=cap,
                                       device=self.device)
        # One intern home: the node's operator and registry use the DAG's
        # shared table (dense ids stable across all nodes).
        op.interner = dag.interner
        op.qserve_registry.interner = dag.interner
        self.op = op

    @property
    def registry(self):
        return self.op.qserve_registry

    def process(self, win, results):
        from spatialflink_tpu_torch.operators.base import jitted
        from spatialflink_tpu_torch.ops.query_registry import (
            registry_bucket_kernel,
        )
        from spatialflink_tpu_torch.qserve import QServeCommand
        from spatialflink_tpu_torch.sncb.common import GpsEvent

        if self._kernel is None:
            self._kernel = jitted(registry_bucket_kernel)
        events = []
        for e in win.events:
            if isinstance(e, QServeCommand):
                events.append(e)
            elif isinstance(e, GpsEvent):
                events.append(Point(obj_id=e.device_id, timestamp=e.ts,
                                    x=e.lon, y=e.lat))
            elif isinstance(e, Point):
                events.append(e)
        return self.op.serve_window(
            WindowBatch(win.start, win.end, events), self._kernel,
            dtype=self.dtype,
        )

    def render(self, result, start, end):
        yield from result.lines()

    def substate(self):
        return self.registry.state()

    def restore_substate(self, state):
        self.registry.restore(state)


class FunctionNode(DagNode):
    """Adapter node for tests and ad-hoc pipelines: ``fn(win, results)``
    with an optional fallback twin and a line renderer."""

    def __init__(self, name: str, fn, fallback=None, render_fn=None,
                 upstream: Optional[str] = None, idempotent: bool = True):
        super().__init__(name, upstream=upstream)
        self._fn = fn
        self._fallback = fallback
        self._render = render_fn
        self.idempotent = bool(idempotent)
        if fallback is not None:
            self.fallback_process = (
                lambda win, results: fallback(win, results)
            )

    def process(self, win, results):
        return self._fn(win, results)

    def render(self, result, start, end):
        if self._render is not None:
            yield from self._render(result, start, end)
        elif isinstance(result, (list, tuple)):
            for r in result:
                yield f"{start},{end},{r}"
        elif result is not None:
            yield f"{start},{end},{result}"


# ---------------------------------------------------------------------------
# The DAG


@dataclass
class DagWindowResult:
    """One fired window across the whole DAG: per-node staged-line counts
    (egress itself goes through each node's transactional sink)."""

    start: int
    end: int
    counts: Dict[str, int]


class DataflowDAG:
    """N nodes, one source, interner and window clock, one unit
    checkpoint.

    Construction wires each node's sink (``out_dir/<name>.csv``
    transactional sinks, or an explicit ``sinks`` map) into ONE
    :class:`MultiSink`; :meth:`run` executes through a
    :class:`WindowedDataflowDriver` (pass a configured one for
    checkpoint, overload and retry; the default is the strict plain
    loop)."""

    #: Driver-level node-attribution label (driver.bind reads it): shared
    #: source, sink and checkpoint work outside the node walk tags "dag",
    #: the walk's inner scopes tag each node.
    telemetry_node = "dag"

    def __init__(self, conf, grid, nodes: Iterable[DagNode], *,
                 out_dir: Optional[str] = None,
                 sinks: Optional[Dict[str, TransactionalFileSink]] = None,
                 retry: Optional[RetryPolicy] = None,
                 interner: Optional[Interner] = None):
        import os

        self.conf = conf
        self.grid = grid
        self.interner = interner if interner is not None else Interner()
        nodes = list(nodes)
        names = [n.name for n in nodes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate node names: {sorted(names)}")
        self._nodes: Dict[str, DagNode] = {n.name: n for n in nodes}
        self._order = self._topo_sort(nodes)
        #: The checkpoint hook marker (checkpoint.operator_state) and the
        #: stable public node-name list, in topological order.
        self.dag_nodes: Tuple[str, ...] = tuple(
            n.name for n in self._order
        )
        self.retry = retry if retry is not None else RetryPolicy()
        if sinks is None:
            if out_dir is None:
                raise ValueError("pass out_dir= or sinks=")
            sinks = {
                n.name: TransactionalFileSink(
                    os.path.join(out_dir, f"{n.name}.csv")
                )
                for n in nodes
            }
        missing = sorted(set(names) - set(sinks))
        if missing:
            raise ValueError(f"nodes without a sink: {missing}")
        self.sink = MultiSink(sinks)
        self._nstate: Dict[str, Dict[str, Any]] = {
            n.name: {
                "backend": "device", "windows": 0, "results": 0,
                "retries": 0, "failovers": 0, "degraded_windows": 0,
                "breaker": None, "lag": FixedBucketLatency(),
            }
            for n in nodes
        }
        self._driver: Optional[WindowedDataflowDriver] = None
        for n in nodes:
            n.bind(self)

    @staticmethod
    def _topo_sort(nodes: List[DagNode]) -> List[DagNode]:
        by_name = {n.name: n for n in nodes}
        order: List[DagNode] = []
        state: Dict[str, int] = {}  # 1 = visiting, 2 = done

        def visit(n: DagNode, chain: Tuple[str, ...]):
            if state.get(n.name) == 2:
                return
            if state.get(n.name) == 1:
                raise ValueError(
                    f"dependency cycle: {' -> '.join(chain + (n.name,))}"
                )
            state[n.name] = 1
            if n.upstream is not None:
                up = by_name.get(n.upstream)
                if up is None:
                    raise ValueError(
                        f"node {n.name!r} names unknown upstream "
                        f"{n.upstream!r}"
                    )
                visit(up, chain + (n.name,))
            state[n.name] = 2
            order.append(n)

        for n in nodes:
            visit(n, ())
        return order

    def node(self, name: str) -> DagNode:
        return self._nodes[name]

    # -- operator protocol (the driver's op) -----------------------------------

    def _assembler(self) -> WindowAssembler:
        # max_out_of_orderness only, no allowed-lateness refires: a refire
        # would re-run windows already charged to the qserve node's
        # per-window accumulators (the QServeOperator.run rule, enforced
        # for the whole DAG).
        return WindowAssembler(
            SlidingEventTimeWindows(self.conf.window_size_ms,
                                    self.conf.slide_step_ms),
            timestamp_fn=lambda e: e.timestamp,
            max_out_of_orderness_ms=self.conf.allowed_lateness_ms,
        )

    def _adopt_assembler(self, asm) -> WindowAssembler:
        # The restore-and-expose protocol (operators/base.py is its home;
        # borrowed unbound so there is exactly one implementation).
        from spatialflink_tpu_torch.operators.base import SpatialOperator

        return SpatialOperator._adopt_assembler(self, asm)

    # -- checkpoint (the atomic unit's node half) ------------------------------

    def dag_state(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"version": DAG_VERSION, "nodes": {}}
        for name in self.dag_nodes:
            st = self._nstate[name]
            rec: Dict[str, Any] = {
                "backend": st["backend"],
                "windows": int(st["windows"]),
                "results": int(st["results"]),
                "retries": int(st["retries"]),
                "failovers": int(st["failovers"]),
                "degraded_windows": int(st["degraded_windows"]),
            }
            sub = self._nodes[name].substate()
            if sub is not None:
                rec["substate"] = sub
            out["nodes"][name] = rec
        return out

    def restore_dag(self, state: Dict[str, Any]) -> None:
        ver = state.get("version", DAG_VERSION)
        if ver != DAG_VERSION:
            raise ValueError(
                f"dag state version {ver} != supported {DAG_VERSION}"
            )
        unknown = sorted(set(state["nodes"]) - set(self.dag_nodes))
        if unknown:
            # A checkpoint naming nodes this DAG lacks would silently drop
            # their state (and their egress would gap): loud.
            raise ValueError(
                f"checkpoint carries state for unknown DAG node(s) "
                f"{unknown} — the resumed DAG must contain every "
                "checkpointed node"
            )
        for name, rec in state["nodes"].items():
            if rec["backend"] == "fallback" \
                    and self._nodes[name].fallback_process is None:
                # The driver.bind() rule, per node, enforced at restore
                # time: failing lazily at the first window would strand
                # earlier nodes' staged egress mid-walk.
                raise ValueError(
                    f"checkpoint was taken after node {name!r} failed "
                    "over to its fallback backend, but this DAG's node "
                    "has no fallback_process — restore with a fallback-"
                    "capable node, or delete the checkpoint to "
                    "recompute from the source"
                )
            st = self._nstate[name]
            st["backend"] = rec["backend"]
            for key in ("windows", "results", "retries", "failovers",
                        "degraded_windows"):
                st[key] = int(rec[key])
            if rec.get("substate") is not None:
                self._nodes[name].restore_substate(rec["substate"])

    # -- the run ---------------------------------------------------------------

    def run(self, source: Iterable, driver=None
            ) -> Iterator[DagWindowResult]:
        """Drive ``source`` through every node; yield one
        :class:`DagWindowResult` per fired window. Egress goes through the
        per-node transactional sinks and commits with the driver's unit
        checkpoint."""
        from spatialflink_tpu_torch import qserve as qserve_mod

        drv = driver if driver is not None else strict_driver()
        if drv.sink is None:
            drv.sink = self.sink
        elif drv.sink is not self.sink:
            raise ValueError(
                "the driver's sink must be this DAG's MultiSink — "
                "construct the driver with sink=None (the DAG wires it)"
            )
        self._driver = drv
        drv.attach(self)  # loads the unit checkpoint (nodes + sinks)
        self._build_breakers(drv)
        if active() is not self:
            install(self)  # snapshot()["dag"] rides stream checkpoints
        for name in self.dag_nodes:
            node = self._nodes[name]
            if isinstance(node, QServeNode) \
                    and qserve_mod.registry() is not node.registry:
                qserve_mod.install(node.registry)

        def process(win):
            return self._process_window(win)

        # Per-node retry and failover happen inside the walk; a
        # driver-level re-run would re-stage lines of completed nodes.
        process.idempotent = False
        drv.bind(self, process, fallback=None)
        yield from drv.run(source)

    def _build_breakers(self, drv) -> None:
        from spatialflink_tpu_torch.overload import CircuitBreaker

        ctrl = drv.overload
        if ctrl is None:
            return
        pol = ctrl.policy
        if pol.breaker_failures <= 0 and pol.breaker_link_ratio is None:
            return
        for name in self.dag_nodes:
            node = self._nodes[name]
            st = self._nstate[name]
            if node.fallback_process is not None and st["breaker"] is None:
                # Per-node circuits: one node's dead device path routes its
                # windows to its twin; siblings keep their circuit closed.
                # Not checkpointed (device health belongs to the process,
                # the CircuitBreaker contract).
                st["breaker"] = CircuitBreaker(pol)

    # -- per-window node walk --------------------------------------------------

    def _process_window(self, win: WindowBatch) -> DagWindowResult:
        asm = getattr(self, "checkpoint_assembler", None)
        wm = getattr(asm, "_max_ts", None)
        results: Dict[str, Any] = {}
        counts: Dict[str, int] = {}
        with telemetry.span("window.dag", start=win.start,
                            events=len(win.events)):
            for name in self.dag_nodes:
                node = self._nodes[name]
                # The scope tags every span, byte, compile and fault inside
                # the walk with this node, and the `node.<name>` container
                # span is what per-node attribution reads. The scope enters
                # first so the span's own exit is still inside it.
                with telemetry.scope(name), \
                        telemetry.span(f"node.{name}", start=win.start,
                                       events=len(win.events)):
                    res = self._run_node(node, win, results)
                    if telemetry.enabled:
                        # Per-node "compute" lineage: each node's own
                        # event-time staleness at result time (what
                        # SloSpec.node_budgets e2e ceilings read).
                        telemetry.record_e2e(win.end, "compute")
                    results[name] = res
                    st = self._nstate[name]
                    n = 0
                    sink = self.sink[name]
                    for line in node.render(res, win.start, win.end):
                        sink.stage(line)
                        n += 1
                    st["windows"] += 1
                    st["results"] += n
                    counts[name] = n
                    if wm is not None:
                        st["lag"].observe(
                            float(max(int(wm) - win.end, 0)))
        return DagWindowResult(win.start, win.end, counts)

    def _run_node(self, node: DagNode, win, results):
        """One node, one window: the per-node retry → failover → crash
        ladder (the driver's semantics scoped to the node, so siblings
        never pay for this node's device path)."""
        st = self._nstate[node.name]
        # Bind once: every `node.process` access creates a fresh bound
        # method, so identity routing compares a captured reference.
        device_proc = node.process
        fallback = node.fallback_process
        breaker = st["breaker"]
        use_breaker = (breaker is not None and st["backend"] == "device"
                       and fallback is not None)
        single_attempt = False
        if use_breaker:
            route = breaker.route()
            if route == "fallback":
                return self._degraded(st, fallback(win, results))
            single_attempt = route == "probe"
        policy = self.retry
        attempt = 0
        delay = policy.backoff_s
        on_device = st["backend"] == "device"
        proc = device_proc if on_device else fallback
        if proc is None:  # pragma: no cover - restore_dag guards this
            raise ValueError(
                f"node {node.name!r} restored on the fallback backend "
                "but has no fallback_process"
            )
        while True:
            try:
                if proc is device_proc and faults.armed:
                    faults.hit("dag.node")  # chaos injection point
                result = proc(win, results)
                if use_breaker and proc is device_proc:
                    breaker.record_success()
                if proc is not device_proc:
                    return self._degraded(st, result)
                return result
            except (KeyboardInterrupt, SystemExit):
                raise
            except CheckpointCorruptError:
                raise  # never retry integrity failures
            except Exception as e:
                if not node.idempotent:
                    # Stateful node: a half-applied window must not re-run;
                    # crash and resume from the unit checkpoint.
                    raise
                start = getattr(win, "start", 0)
                if not single_attempt and attempt < policy.max_retries:
                    attempt += 1
                    st["retries"] += 1
                    telemetry.record_driver_retry(
                        start, attempt, f"{node.name}: {e!r}"
                    )
                    policy.do_sleep(delay)
                    delay *= policy.multiplier
                    continue
                if use_breaker and proc is device_proc:
                    breaker.record_failure(start, repr(e))
                    return self._degraded(st, fallback(win, results))
                if st["backend"] == "device" and fallback is not None:
                    # Permanent per-node failover: this node runs its numpy
                    # twin for the rest of the run; every sibling keeps its
                    # device path.
                    st["backend"] = "fallback"
                    st["failovers"] += 1
                    telemetry.record_driver_failover(
                        start, f"{node.name}: {e!r}"
                    )
                    telemetry.emit_instant(
                        f"dag_node_failover:{node.name}",
                        window_start=int(start),
                    )
                    telemetry.maybe_flush_stream(force=True)
                    proc = fallback
                    attempt = 0
                    delay = policy.backoff_s
                    continue
                raise

    def _degraded(self, st, result):
        st["degraded_windows"] += 1
        drv = self._driver
        if drv is not None and drv.overload is not None:
            # A node-window answered off the device path is a degraded
            # window for the global budget too (per-node budgets read the
            # per-node counter).
            drv.overload.count_degraded_window()
        return result

    # -- telemetry / SLO surfaces ----------------------------------------------

    def node_stats(self, name: str) -> Optional[Dict[str, Any]]:
        """Per-node counters for the live SLO engine's ``node_budgets``
        checks (None for an unknown node: silence fails the check)."""
        st = self._nstate.get(name)
        if st is None:
            return None
        p99 = st["lag"].percentile(0.99) if st["lag"].count else 0.0
        if p99 != p99 or math.isinf(p99):
            p99 = 0.0
        # Per-node e2e staleness from the node's own "compute" stage; None
        # before the first stamped window (the SLO engine's silence-fails
        # rule turns that into a failed check).
        e2e_p50, e2e_p99 = telemetry.e2e_stage_percentiles(
            "compute", node=name)
        return {
            "watermark_lag_p99_ms": float(p99),
            "retries": int(st["retries"]),
            "failovers": int(st["failovers"]),
            "degraded_windows": int(st["degraded_windows"]),
            "e2e_p50_ms": e2e_p50,
            "e2e_p99_ms": e2e_p99,
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``snapshot()["dag"]`` block (``install`` sets it as
        telemetry's ``dag_provider``): per-node backend, counters and lag
        on every ledger-stream checkpoint."""
        nodes: Dict[str, Any] = {}
        for name in self.dag_nodes:
            st = self._nstate[name]
            stats = self.node_stats(name)
            rec = {
                "backend": st["backend"],
                "windows": int(st["windows"]),
                "results": int(st["results"]),
                "retries": int(st["retries"]),
                "failovers": int(st["failovers"]),
                "degraded_windows": int(st["degraded_windows"]),
                "watermark_lag_p99_ms": stats["watermark_lag_p99_ms"],
            }
            # Additive: the e2e fields appear once the node has stamped a
            # window.
            if stats.get("e2e_p99_ms") is not None:
                rec["e2e_p50_ms"] = stats["e2e_p50_ms"]
                rec["e2e_p99_ms"] = stats["e2e_p99_ms"]
            if st["breaker"] is not None:
                rec["breaker"] = st["breaker"].snapshot()
            nodes[name] = rec
        return json_safe({
            "version": DAG_VERSION,
            "nodes": nodes,
        })


# -- module-level wiring (the telemetry and overload singleton idiom) ---------

_active: Optional[DataflowDAG] = None


def install(dag: DataflowDAG) -> DataflowDAG:
    """Make ``dag`` the process-global DAG: the SLO engine's
    ``node_budgets`` checks read it and ``telemetry.snapshot()["dag"]``
    carries its per-node counters. Stays installed after the run (tests
    clean up through :func:`uninstall`)."""
    global _active
    _active = dag
    telemetry.dag_provider = dag.snapshot
    return dag


def uninstall():
    global _active
    if _active is not None:
        telemetry.dag_provider = None
    _active = None


def active() -> Optional[DataflowDAG]:
    return _active


# ---------------------------------------------------------------------------
# The canonical 7-node SNCB DAG


#: Brussels-area bbox the SNCB synthetic sources use
#: (sncb/runners.py:BRUSSELS_BBOX).
SNCB_BBOX = (4.25, 4.50, 50.75, 50.95)


def build_sncb_dag(out_dir: str, *,
                   window_s: float = 10.0, slide_s: float = 5.0,
                   lateness_s: float = 5.0,
                   grid=None, zones=None,
                   qserve_queries=None, cap_max: Optional[int] = None,
                   include_checkin: bool = False,
                   room_capacities: Optional[Dict[str, int]] = None,
                   retry: Optional[RetryPolicy] = None,
                   device="cuda") -> DataflowDAG:
    """The canonical composed SNCB pipeline, SEVEN nodes on one source,
    interner and clock: q1–q5, staytime, qserve (plus an optional checkin
    node when the stream carries door events). ``zones`` is a
    ``(high_risk, maintenance, fence)`` triple; by default the bundled
    reference resources. Sinks land at ``out_dir/<node>.csv``. The zone
    test, StayTime and qserve run on ``device``."""
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.query_config import (
        QueryConfiguration,
        QueryType,
    )
    from spatialflink_tpu_torch.sncb.common import PolygonLoader

    device = resolve_device(device)
    if zones is None:
        zones = (
            PolygonLoader.load_geojson_buffered(
                "high_risk_zones.geojson", 20.0),
            PolygonLoader.load_geojson_buffered(
                "maintenance_areas.geojson", 0.0),
            PolygonLoader.load_wkt_buffered("q5_fence.wkt", 20.0),
        )
    risk, maint, fence = zones
    if grid is None:
        min_x, max_x, min_y, max_y = SNCB_BBOX
        grid = UniformGrid(32, min_x, max_x, min_y, max_y)
    else:
        min_x, max_x = grid.min_x, grid.max_x
        min_y, max_y = grid.min_y, grid.max_y
    conf = QueryConfiguration(
        QueryType.WindowBased, window_size=window_s, slide_step=slide_s,
        allowed_lateness=lateness_s,
    )
    # Q4's pushdown bbox: the middle half of the grid bbox (a real
    # restriction of q3, not an alias).
    qx = (max_x - min_x) / 4.0
    qy = (max_y - min_y) / 4.0
    nodes: List[DagNode] = [
        Q1Node("q1", risk, device=device),
        Q2Node("q2", maint, device=device),
        Q3Node("q3"),
        Q4Node("q4", min_x + qx, max_x - qx, min_y + qy, max_y - qy),
        Q5Node("q5", fence, device=device),
        StayTimeNode("staytime", device=device),
        QServeNode("qserve", cap_max=cap_max, device=device),
    ]
    if include_checkin:
        nodes.append(CheckInNode("checkin", room_capacities or {}))
    dag = DataflowDAG(conf, grid, nodes, out_dir=out_dir, retry=retry)
    if qserve_queries:
        from spatialflink_tpu_torch import qserve as qserve_mod

        # Boot registrations apply only through commands on the stream:
        # callers chain dag.qserve_boot ahead of the source (deterministic
        # uids, so resumes replay them exactly).
        dag.qserve_boot = qserve_mod.boot_commands(qserve_queries)
    else:
        dag.qserve_boot = []
    return dag


def default_sncb_queries():
    """A small deterministic standing-query set over the Brussels bbox
    (two tenants, range + knn): the smoke and chaos default."""
    from spatialflink_tpu_torch.qserve import StandingQuery

    min_x, max_x, min_y, max_y = SNCB_BBOX
    cx, cy = (min_x + max_x) / 2.0, (min_y + max_y) / 2.0
    return [
        StandingQuery(qid="r0", tenant="ta", kind="range",
                      x=cx, y=cy, radius=0.05, k=16),
        StandingQuery(qid="r1", tenant="tb", kind="range",
                      x=min_x + 0.06, y=cy, radius=0.04, k=8,
                      tenant_class="bulk"),
        StandingQuery(qid="k0", tenant="ta", kind="knn",
                      x=cx, y=min_y + 0.05, radius=0.08, k=5),
        StandingQuery(qid="k1", tenant="tb", kind="knn",
                      x=max_x - 0.06, y=max_y - 0.05, radius=0.08, k=3,
                      tenant_class="bulk"),
    ]


# ---------------------------------------------------------------------------
# Chaos smoke: the kill-anywhere/resume round trip.


def _toy_sncb_stream(n_events: int = 360):
    """Deterministic Brussels GPS stream + qserve churn commands (the JAX
    package's, event for event): FA spread > 0.6 and FF <= 0.5 variation
    (q2 fires), speeds averaging over 50 (q5 fires where fenced), an
    event-time jump so an armed lag-shed policy really sheds, and
    mid-stream register/unregister commands so ``qserve.register`` has
    mid-churn hits."""
    from spatialflink_tpu_torch.qserve import QServeCommand, StandingQuery
    from spatialflink_tpu_torch.sncb.common import GpsEvent

    min_x, max_x, min_y, max_y = SNCB_BBOX
    rng = np.random.default_rng(23)
    xs = rng.uniform(min_x, max_x, n_events)
    ys = rng.uniform(min_y, max_y, n_events)
    # The bundled zones are city-block sized inside a ~25 km bbox: uniform
    # points essentially never land in them. Pull every 3rd event near
    # the high-risk zone / Q5 fence centroids so q1 and q5 egress is
    # non-vacuous.
    xs[::3] = 4.354 + rng.normal(0.0, 0.004, len(xs[::3]))
    ys[::3] = 50.854 + rng.normal(0.0, 0.004, len(ys[::3]))
    xs[1::3] = 4.404 + rng.normal(0.0, 0.004, len(xs[1::3]))
    ys[1::3] = 50.854 + rng.normal(0.0, 0.004, len(ys[1::3]))
    fas = rng.uniform(0.0, 1.0, n_events)
    ffs = rng.uniform(0.0, 0.4, n_events)
    sp = rng.uniform(20.0, 110.0, n_events)
    cx, cy = (min_x + max_x) / 2.0, (min_y + max_y) / 2.0
    churn = [
        QServeCommand(timestamp=12_005, action="register", uid="mid0",
                      query=StandingQuery(
                          qid="mid0", tenant="tb", kind="range",
                          x=cx, y=cy, radius=0.06, k=8)),
        QServeCommand(timestamp=14_005, action="unregister", uid="mid1",
                      qid="r1"),
        QServeCommand(timestamp=16_005, action="register", uid="mid2",
                      query=StandingQuery(
                          qid="mid2", tenant="ta", kind="knn",
                          x=cx + 0.03, y=cy, radius=0.07, k=4)),
    ]

    def source():
        pending = sorted(churn, key=lambda c: (c.timestamp, c.uid))
        for q in default_sncb_queries():
            yield QServeCommand(timestamp=0, action="register",
                                uid=f"boot:{q.qid}", query=q)
        jump_at = (2 * n_events) // 3
        for i in range(n_events):
            # Smooth 100 ms cadence with one 30 s event-time jump at the
            # 2/3 mark: the backlog fires with huge lag, and the armed
            # lag-shed policy enters shed mode deterministically.
            ts = i * 100 if i < jump_at else 30_000 + i * 100
            if i > jump_at and i % 5 == 0:
                # In-bound stragglers right after the jump: events a
                # policy-less run includes but shed mode drops, so the
                # armed runs' egress depends on the (event-time
                # deterministic, checkpointed) shed schedule.
                ts -= 3_000
            while pending and pending[0].timestamp <= ts:
                yield pending.pop(0)
            yield GpsEvent(
                device_id=f"dev{i % 7}", lon=float(xs[i]),
                lat=float(ys[i]), ts=int(ts),
                gps_speed=float(sp[i]), fa=float(fas[i]),
                ff=float(ffs[i]),
            )
        yield from pending

    return source


#: The overload policy the smoke arms: a tiny admission budget and a lag
#: ceiling the stream's event-time jump is guaranteed to cross.
SMOKE_OVERLOAD_POLICY = {
    "max_buffered_events": 16,
    "lag_shed_ceiling_ms": 8_000,
    "lag_recover_ms": 1_000,
}


def run_chaos_child(workdir: str, device="cuda") -> int:
    """One (possibly fault-armed) 7-node SNCB DAG run on ``device``:
    per-node exactly-once CSV egress and the atomic unit checkpoint under
    ``workdir``, resumed automatically when the checkpoint exists.
    ``SFT_OVERLOAD_POLICY``, ``SFT_PIPELINE`` and ``SFT_FAULT_PLAN`` arm
    through the environment (faults at import; the policy is installed on
    the driver here with ``source_pausable=False`` so its shed path
    really sheds).

    ``SFT_LEDGER_STREAM`` / ``SFT_LEDGER_PATH`` arm telemetry: per-node
    attribution from the DAG's node scopes rides the stream's
    checkpoints, so a kill mid-run leaves a recoverable capture with node
    blocks. Each child needs its own stream path (``enable`` truncates)."""
    import os

    from spatialflink_tpu_torch import overload as overload_mod

    stream_path = os.environ.get("SFT_LEDGER_STREAM")
    ledger_path = os.environ.get("SFT_LEDGER_PATH")
    if stream_path or ledger_path:
        telemetry.enable(stream_path=stream_path)
    ctrl = None
    spec = os.environ.get("SFT_OVERLOAD_POLICY")
    if spec:
        ctrl = overload_mod.OverloadController(
            overload_mod.OverloadPolicy.from_env(spec)
        )
    dag = build_sncb_dag(
        os.path.join(workdir, "egress"),
        retry=RetryPolicy(max_retries=1, backoff_s=0.0),
        device=device,
    )
    driver = WindowedDataflowDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=2, sink=None,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0),
        failover=False,  # chaos wants crash-and-resume at the driver
        overload=ctrl, source_pausable=False,
    )
    source = _toy_sncb_stream()
    n = 0
    for res in dag.run(source(), driver=driver):
        n += sum(res.counts.values())
    if ledger_path:
        telemetry.write_ledger(ledger_path)  # seals "complete"
    elif stream_path:
        telemetry.seal_stream("complete")
    return n


def run_mesh_child(device="cuda") -> int:
    """The dag-smoke mesh leg: two collective-bearing sharded kernels on
    an 8-shard data mesh of ``device`` (listed eight times) under
    telemetry, proving the host-side collective accounting
    (``parallel/sharded.py`` → ``telemetry.account_collective``) lands
    in the sealed stream the parent gates on. Exit 0 iff the accounted
    collective bytes are above 0."""
    import os

    from spatialflink_tpu_torch.parallel.mesh import data_mesh
    from spatialflink_tpu_torch.parallel.sharded import (
        sharded_range_query,
        sharded_traj_stats,
    )

    dev = resolve_device(device)
    telemetry.enable(stream_path=os.environ.get("SFT_LEDGER_STREAM"))
    mesh = data_mesh(8, devices=[dev] * 8)
    n = 64
    rng = np.random.default_rng(7)
    xy = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    flags = torch.ones(n, dtype=torch.uint8, device=dev)
    q = torch.from_numpy(rng.random((4, 2)).astype(np.float32)).to(dev)
    # (oid, ts)-sorted trajectory slab: 8 oids × 8 points each.
    oid = torch.from_numpy(np.repeat(np.arange(8), 8).astype(np.int32)).to(
        dev)
    ts = torch.from_numpy(np.tile(np.arange(8), 8).astype(np.int32)).to(dev)
    with telemetry.scope("meshleg"), telemetry.span("node.meshleg",
                                                    events=n):
        keep, _ = sharded_range_query(mesh, xy, valid, flags, q, 0.25)
        spatial, temporal, count, speed = sharded_traj_stats(
            mesh, xy, ts, oid, valid, num_segments=8)
        # One wait: the programs really ran.
        telemetry.fetch((keep, count))
    gauges = telemetry.collective_gauges()
    nbytes = int(gauges["bytes"]) if gauges else 0
    telemetry.seal_stream("complete")
    print(f"dag-mesh-child: collective bytes {nbytes} "
          f"across {int(gauges['calls']) if gauges else 0} call(s) on "
          f"an 8-shard mesh of {dev}")
    return 0 if nbytes > 0 else 1


def chaos_smoke(device="cuda") -> int:
    """Clean run vs (killed between sink commits → resumed) run under an
    armed overload policy, each child on ``device``: every node's egress
    must be byte-identical. The abort fault fires on the unit commit's
    SECOND sub-append (``dag.commit`` ``at: 2``), after one sink's bytes
    are durable and before the next sink's. Exit 0 on equality.

    Every child streams its ledger (``SFT_LEDGER_STREAM``): the clean
    child's sealed stream must carry all seven node buckets in its final
    checkpoint snapshot, and the killed child's truncated stream must
    recover with its node blocks (``tools/sfprof``), and the
    ``--mesh-child`` leg (an 8-shard mesh of ``device``) must account
    nonzero collective bytes into its sealed stream."""
    import json
    import os
    import subprocess
    import sys
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)  # tools/sfprof reads the streams
    from tools.sfprof import stream as stream_mod

    env_base = dict(os.environ)
    env_base.pop("SFT_FAULT_PLAN", None)
    env_base.pop("SFT_PIPELINE", None)
    env_base.pop("SFT_LEDGER_PATH", None)
    env_base["SFT_OVERLOAD_POLICY"] = json.dumps(SMOKE_OVERLOAD_POLICY)
    # Flush the ledger stream at every window boundary so the killed
    # child's truncated stream deterministically carries node blocks.
    env_base["SFT_LEDGER_STREAM_INTERVAL_S"] = "0"

    def child(workdir, plan=None, stream=None):
        env = dict(env_base)
        if plan is not None:
            env["SFT_FAULT_PLAN"] = json.dumps(plan)
        if stream is not None:
            env["SFT_LEDGER_STREAM"] = stream
        else:
            env.pop("SFT_LEDGER_STREAM", None)
        return subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.dag",
             "--chaos-child", workdir, "--device", str(device)],
            env=env, capture_output=True, text=True, timeout=600,
            cwd=root,
        )

    def last_checkpoint_snapshot(stream):
        records, _tail = stream_mod.read_records(stream)
        snaps = [r for r in records if r.get("t") == "checkpoint"]
        return (snaps[-1].get("snapshot") or {}) if snaps else {}

    node_names = ("q1", "q2", "q3", "q4", "q5", "staytime", "qserve")
    with tempfile.TemporaryDirectory(prefix="sft_dag_") as tmp:
        # The mesh leg shares nothing with the kill/resume children: it
        # runs beside them and is read at the end.
        mesh_stream = os.path.join(tmp, "mesh.jsonl")
        mesh_child = subprocess.Popen(
            [sys.executable, "-m", "spatialflink_tpu_torch.dag",
             "--mesh-child", "--device", str(device)],
            env=dict(env_base, SFT_LEDGER_STREAM=mesh_stream),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=root)
        try:
            rc = _smoke_children(child, last_checkpoint_snapshot,
                                 stream_mod, node_names, tmp)
        except BaseException:
            mesh_child.kill()
            mesh_child.communicate()
            raise
        if rc:
            mesh_child.kill()
            mesh_child.communicate()
            return rc
        mesh_out, mesh_err = mesh_child.communicate(timeout=600)
        # Mesh leg: collective accounting must land nonzero bytes in a
        # sealed stream on an 8-shard mesh of the children's device.
        if mesh_child.returncode != 0:
            print("dag-smoke: mesh leg failed\n"
                  + mesh_out[-500:] + mesh_err[-2000:])
            return 1
        print(mesh_out.strip())
        coll = last_checkpoint_snapshot(mesh_stream).get(
            "collectives") or {}
        if int(coll.get("bytes") or 0) <= 0:
            print("dag-smoke: mesh leg's sealed stream carries no "
                  f"collective bytes (got {coll!r})")
            return 1
    print("dag-smoke: kill-between-sink-commits/resume egress "
          f"byte-identical on all {len(node_names)} sinks on {device}; "
          "per-node attribution sealed + recovered; mesh collectives "
          f"accounted ({int(coll['bytes'])} bytes) — OK")
    return 0


def _smoke_children(child, last_checkpoint_snapshot, stream_mod,
                    node_names, tmp) -> int:
    """The smoke's clean, killed and resumed children and their gates;
    0 when every gate holds."""
    import os

    clean_dir = os.path.join(tmp, "clean")
    chaos_dir = os.path.join(tmp, "chaos")
    os.makedirs(clean_dir)
    os.makedirs(chaos_dir)
    clean_stream = os.path.join(tmp, "clean.jsonl")
    p = child(clean_dir, stream=clean_stream)
    if p.returncode != 0:
        print("dag-smoke: clean run failed\n" + p.stderr[-2000:])
        return 1
    # Attribution gate: the sealed clean stream's final checkpoint
    # must carry every DAG node's telemetry bucket.
    snap_nodes = last_checkpoint_snapshot(clean_stream).get(
        "nodes") or {}
    missing = sorted(set(node_names) - set(snap_nodes))
    if missing:
        print(f"dag-smoke: sealed stream is missing per-node "
              f"attribution for {missing} (has "
              f"{sorted(snap_nodes)})")
        return 1
    # The between-sink-commits cut: sub-commit #2 of a unit commit.
    chaos_stream = os.path.join(tmp, "chaos_killed.jsonl")
    p = child(chaos_dir,
              plan=[{"point": "dag.commit", "kind": "abort", "at": 2}],
              stream=chaos_stream)
    if p.returncode != 137:
        print(f"dag-smoke: expected the armed child to die with exit "
              f"137, got {p.returncode}\n" + p.stderr[-2000:])
        return 1
    # The killed child's truncated stream must recover with node
    # blocks intact (a fresh path for the resume: enable truncates).
    _doc, info = stream_mod.recover(chaos_stream)
    if not info.get("nodes_recovered"):
        print("dag-smoke: killed child's stream recovered with no "
              "per-node attribution")
        return 1
    p = child(chaos_dir,
              stream=os.path.join(tmp, "chaos_resume.jsonl"))
    if p.returncode != 0:
        print("dag-smoke: resume run failed\n" + p.stderr[-2000:])
        return 1
    total = 0
    for name in node_names:
        with open(os.path.join(
                clean_dir, "egress", f"{name}.csv"), "rb") as f:
            want = f.read()
        with open(os.path.join(
                chaos_dir, "egress", f"{name}.csv"), "rb") as f:
            got = f.read()
        if want != got:
            print(f"dag-smoke: egress mismatch on sink {name!r} "
                  f"after kill/resume (clean {len(want)} B, "
                  f"recovered {len(got)} B)")
            return 1
        total += len(want)
    if total == 0:
        print("dag-smoke: every sink is empty (vacuous pass)")
        return 1
    return 0


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m spatialflink_tpu_torch.dag",
        description="composed-dataflow kill-anywhere/resume self-test",
    )
    ap.add_argument("--smoke", action="store_true",
                    help="run the 7-node SNCB DAG kill/resume smoke")
    ap.add_argument("--chaos-child", metavar="DIR", default=None,
                    help="internal: one SNCB DAG run rooted at DIR")
    ap.add_argument("--mesh-child", action="store_true",
                    help="internal: the smoke's sharded collective-"
                         "accounting leg, on an 8-shard mesh of --device")
    ap.add_argument("--device", default="cuda",
                    help="where the DAG's device nodes run: cuda (the "
                         "default) or cpu")
    args = ap.parse_args(argv)
    if args.chaos_child:
        n = run_chaos_child(args.chaos_child, device=args.device)
        print(f"dag-child: {n} records staged")
        return 0
    if args.mesh_child:
        return run_mesh_child(device=args.device)
    if args.smoke:
        return chaos_smoke(device=args.device)
    ap.error("pass --smoke (or internal --chaos-child / --mesh-child)")
    return 2


if __name__ == "__main__":
    import sys

    # ``python -m spatialflink_tpu_torch.dag`` executes this file as
    # __main__ while the SLO and telemetry hooks import the canonical
    # spatialflink_tpu_torch.dag: two module instances, two `_active`
    # slots. Delegate to the canonical one.
    from spatialflink_tpu_torch.dag import main as _canonical_main

    sys.exit(_canonical_main())
