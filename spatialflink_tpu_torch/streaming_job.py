"""StreamingJob: the yml-config-driven entry point
(``GeoFlink/StreamingJob.java:68-280``).

``python -m spatialflink_tpu_torch.streaming_job --config conf.yml
[--source ...] [--output ...]`` loads the reference-schema config, builds
the grid and query objects, wires a source (file, socket, synthetic or a
Kafka topic through the built-in wire client) and dispatches on
``query.option``, as the JAX package's ``streaming_job`` does:

  1 = Range query, window-based, Point stream × Point query set
      (StreamingJob.java:254-263)
  2 = Range query, real-time, Point stream × Point query set (:265-275)
  (extensions) 3 = window kNN, 4 = realtime kNN, 5 = window join,
  6 = tStats, 7 = tAggregate, 8 = multi-query window kNN (one program
  answers the whole queryPoints set per window), 9 = qserve, the
  multi-tenant standing-query serving layer (``qserve.py``; the query set
  comes from ``SFT_QSERVE`` or one range + one kNN standing query per yml
  queryPoint), and 10 = the composed SNCB DAG (``dag.py``): Q1–Q5 +
  StayTime + qserve on one source, interner and window clock, one
  transactional sink per node under the ``--output`` directory and, with
  ``--checkpoint``, the atomic unit checkpoint.

Device: the yml's ``backend`` (``cuda``, the default, or ``cpu``) is the
device every operator runs on; a missing card raises. ``deviceMesh`` with
a product above 1 shards the windowed operators over a mesh of the
backend's devices (``parallel/``): the CPU once per shard, or the visible
cards, raising when it names more than there are; a product of 1 runs
unsharded.
"""

from __future__ import annotations

import argparse
import sys
from typing import Iterable, Iterator

from spatialflink_tpu_torch.config import Params
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    PointPointKNNQuery,
    PointPointRangeQuery,
    QueryConfiguration,
    QueryType,
    TAggregateQuery,
    TStatsQuery,
)
from spatialflink_tpu_torch.streams.serde import (
    parse_csv_point,
    parse_geojson,
)
from spatialflink_tpu_torch.streams.sinks import CsvFileSink, PrintSink
from spatialflink_tpu_torch.streams.sources import (
    SyntheticGpsSource,
    csv_source,
    socket_source,
)


def build_source(params: Params, source_arg: str) -> Iterator[Point]:
    """``--source`` forms: ``csv:<path>``, ``geojson:<path>``,
    ``socket:<host>:<port>``, ``synthetic[:eps[:seconds]]``, or
    ``kafka[:<topic>[@<bootstrap>]]``, the reference's default transport
    (StreamingJob.java:188-191), consumed through the built-in wire
    client (``streams/kafka_wire.py``); topic and bootstrap default to the
    yml's ``inputStream1.topicName`` / ``kafkaBootStrapServers``, the
    record format to ``inputStream1.format``."""
    sc = params.input_stream1
    kind, _, rest = source_arg.partition(":")
    if kind == "kafka":
        from spatialflink_tpu_torch.streams.kafka import kafka_source

        topic, _, bootstrap = rest.partition("@")
        topic = topic or sc.topic_name
        bootstrap = bootstrap or params.kafka_bootstrap_servers
        if not topic or not bootstrap:
            raise ValueError(
                "kafka source needs a topic and bootstrap servers (CLI "
                "kafka:<topic>@<bootstrap> or yml inputStream1.topicName "
                "+ kafkaBootStrapServers)"
            )
        if sc.format == "GeoJSON":
            def parse(line):
                return parse_geojson(
                    line,
                    timestamp_property=sc.geojson_schema_attr[1],
                    objid_property=sc.geojson_schema_attr[0],
                    date_format=sc.date_format,
                )
        elif sc.format in ("CSV", "TSV"):
            def parse(line):
                return parse_csv_point(
                    line, schema=sc.csv_tsv_schema_attr,
                    delimiter=sc.delimiter, date_format=sc.date_format,
                )
        else:
            # Fail up front: kafka_source skips unparseable records, so a
            # wrong parser would run forever with no output.
            raise ValueError(
                f"kafka source supports GeoJSON/CSV/TSV records for point "
                f"streams, not inputStream1.format={sc.format!r}"
            )
        return kafka_source(topic, bootstrap, parse)
    if kind == "csv":
        return csv_source(
            rest,
            lambda ln: parse_csv_point(
                ln, schema=sc.csv_tsv_schema_attr, delimiter=sc.delimiter,
                date_format=sc.date_format,
            ),
        )
    if kind == "geojson":
        def gen():
            with open(rest) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        try:
                            yield parse_geojson(
                                line,
                                timestamp_property=sc.geojson_schema_attr[1],
                                objid_property=sc.geojson_schema_attr[0],
                                date_format=sc.date_format,
                            )
                        except (ValueError, KeyError):
                            continue
        return gen()
    if kind == "socket":
        host, _, port = rest.partition(":")
        return socket_source(
            host, int(port),
            lambda ln: parse_csv_point(
                ln, schema=sc.csv_tsv_schema_attr, delimiter=sc.delimiter
            ),
        )
    if kind == "synthetic":
        parts = [p for p in rest.split(":") if p]
        eps = int(parts[0]) if parts else 20_000
        secs = float(parts[1]) if len(parts) > 1 else 10.0
        min_x, min_y, max_x, max_y = sc.grid_bbox
        return iter(
            SyntheticGpsSource(
                min_x, max_x, min_y, max_y, target_eps=eps,
                duration_ms=int(secs * 1000),
            )
        )
    raise ValueError(f"unknown source spec {source_arg!r}")


def _mesh_from_config(device_mesh, device):
    """The yml's ``deviceMesh`` (the parallelism analog,
    conf/geoflink-conf.yml:55) on the backend's devices
    (``parallel/sharded.py:mesh_from_config``): a product of 1 runs
    unsharded (``None``); ``backend: cpu`` shards over the CPU listed
    once per shard, ``backend: cuda`` over the visible cards, raising
    "need N devices, have M" above their count."""
    from spatialflink_tpu_torch.parallel.sharded import mesh_from_config

    return mesh_from_config(device_mesh or [1], device=device)


def _run_sncb_dag(params: Params, source, output_dir, driver) -> int:
    """Query option 10: the composed SNCB DAG (``dag.py``): Q1–Q5 +
    StayTime + qserve on one source, interner and window clock, one
    transactional sink per node under ``output_dir``, the device nodes on
    ``params.backend``. Point events from the generic sources adapt to
    GpsEvents (obj_id → deviceId, x/y → lon/lat); qserve's standing-query
    set comes from ``SFT_QSERVE`` or the built-in Brussels default,
    registered through deterministic boot commands on the stream (so a
    ``--checkpoint`` resume replays them exactly)."""
    import itertools

    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch import qserve as qserve_mod
    from spatialflink_tpu_torch.sncb.common import GpsEvent

    if not output_dir:
        raise SystemExit(
            "query option 10 (the SNCB DAG) needs --output <directory> "
            "— one transactional sink per node lands there"
        )
    cfg = qserve_mod.config_from_env()
    if cfg and cfg.get("queries"):
        queries = qserve_mod.queries_from_config(cfg)
    else:
        queries = dag_mod.default_sncb_queries()
    w = params.window
    dag = dag_mod.build_sncb_dag(
        output_dir,
        window_s=float(w.interval), slide_s=float(w.step),
        grid=params.input_stream1.make_grid(),
        qserve_queries=queries,
        cap_max=(cfg or {}).get("cap_max"),
        device=params.backend,
    )

    def gps(src):
        for p in src:
            if isinstance(p, GpsEvent):
                yield p
            else:
                yield GpsEvent(
                    device_id=p.obj_id, lon=float(p.x), lat=float(p.y),
                    ts=int(p.timestamp),
                    gps_speed=getattr(p, "speed", None),
                )

    stream = itertools.chain(dag.qserve_boot, gps(source))
    n = 0
    for res in dag.run(stream, driver=driver):
        n += sum(res.counts.values())
    return n


def run_job(params: Params, source: Iterable[Point], sink,
            driver=None, output_dir=None) -> int:
    """Dispatch on ``query.option``, every operator on
    ``params.backend``'s device. ``driver=`` (a configured
    ``driver.WindowedDataflowDriver``) routes the windowed query options
    through the self-healing dataflow driver: auto-checkpoint,
    exactly-once egress, retry and failover; supported for the
    driver-wired operators (options 1, 3, 5, 6, 9 and 10).
    ``output_dir`` is option 10's egress directory (the composed DAG owns
    one transactional sink per node; ``sink`` is ignored there)."""
    device = params.backend
    grid = params.input_stream1.make_grid()
    q = params.query
    window_conf = QueryConfiguration(
        QueryType.WindowBased,
        window_size=params.window.interval,
        slide_step=params.window.step,
        approximate_query=q.approximate,
    )
    realtime_conf = QueryConfiguration(
        QueryType.RealTime, approximate_query=q.approximate
    )
    q_points = [Point(x=p[0], y=p[1]) for p in q.query_points]
    n = 0
    option = q.option
    # The yml's deviceMesh (parallelism analog, conf/geoflink-conf.yml:55):
    # a product > 1 runs every windowed kernel sharded over the mesh's
    # data axis, with results identical to the unsharded run.
    mesh = _mesh_from_config(params.device_mesh, device)

    # query.incremental (extension): pane/ListState-carry execution (range
    # rides query_incremental, kNN and join the pane carries). Sliding
    # windows only; configurations the carries cannot serve (size not a
    # slide multiple) fall back to full recomputation. The carry
    # contracts: in-order streams, and for the join exactness only at
    # overflow == 0.
    incremental = (
        bool(getattr(q, "incremental", False))
        and mesh is None
        and window_conf.window_size_ms
        % max(window_conf.slide_step_ms, 1) == 0
    )

    if driver is not None and option not in (1, 3, 5, 6, 9, 10):
        raise SystemExit(
            f"--checkpoint (the dataflow driver) supports query options "
            f"1, 3, 5, 6, 9 and 10, not {option} — the remaining "
            "operators keep their own loops until they are driver-wired"
        )

    if option == 10:
        return _run_sncb_dag(params, source, output_dir, driver)

    if option in (1, 2):
        conf = window_conf if option == 1 else realtime_conf
        op = PointPointRangeQuery(conf, grid, device=device, mesh=mesh)
        if option == 1 and incremental and len(q_points) == 1:
            if driver is not None:
                raise SystemExit(
                    "--checkpoint is incompatible with query.incremental "
                    "(the carry protocol is not driver-wired)"
                )
            # The carry protocol is single-query (like the reference's one
            # incremental variant); query sets take the full path.
            results = op.query_incremental(source, q_points[0], q.radius)
        else:
            results = op.run(source, q_points, q.radius, driver=driver)
        # One home for the option-1 line format (the renderer the chaos
        # smoke byte-compares).
        from spatialflink_tpu_torch.driver import render_range_result

        for res in results:
            for line in render_range_result(res):
                sink(line)
                n += 1
    elif option in (3, 4):
        conf = window_conf if option == 3 else realtime_conf
        op = PointPointKNNQuery(conf, grid, device=device, mesh=mesh)
        if option == 3 and incremental:
            if driver is not None:
                raise SystemExit(
                    "--checkpoint is incompatible with query.incremental "
                    "(the pane-carry protocol is not driver-wired)"
                )
            results = op.query_panes(source, q_points[0], q.radius, q.k)
        else:
            results = op.run(source, q_points[0], q.radius, q.k,
                             driver=driver)
        for res in results:
            for oid, d, p in res.neighbors:
                sink(f"{res.start},{res.end},{oid},{float(d)!r}")
                n += 1
    elif option == 5:
        op = PointPointJoinQuery(window_conf, grid, device=device, mesh=mesh)
        # Both halves re-materialise deterministically from the replayed
        # source, so the merged two-stream sequence is itself replayable:
        # what the driver's resume-skip needs.
        events = list(source)
        half = len(events) // 2
        left, right = iter(events[:half]), iter(events[half:])
        if incremental:
            if driver is not None:
                raise SystemExit(
                    "--checkpoint is incompatible with query.incremental "
                    "(the pane-carry protocol is not driver-wired)"
                )
            results = op.query_panes(left, right, q.radius)
        else:
            results = op.run(left, right, q.radius, driver=driver)
        for res in results:
            for a, b, d in res.pairs:
                sink(f"{res.start},{res.end},{a.obj_id},{b.obj_id},"
                     f"{float(d)!r}")
                n += 1
    elif option == 8:
        op = PointPointKNNQuery(window_conf, grid, device=device, mesh=mesh)
        for res in op.run_multi(source, q_points, q.radius, q.k):
            for qi, r_ in enumerate(res.results):
                for oid, d, p in r_.neighbors:
                    sink(f"{res.start},{res.end},{qi},{oid},{float(d)!r}")
                    n += 1
    elif option == 6:
        op = TStatsQuery(window_conf, grid, device=device, mesh=mesh)
        for res in op.run(source, driver=driver):
            for oid, (sp, tp, ratio) in sorted(res.stats.items()):
                sink(f"{res.start},{res.end},{oid},{float(sp)!r},{tp},"
                     f"{float(ratio)!r}")
                n += 1
    elif option == 9:
        import itertools

        from spatialflink_tpu_torch import overload as overload_mod
        from spatialflink_tpu_torch import qserve as qserve_mod

        cfg = qserve_mod.config_from_env()
        if cfg and cfg.get("queries"):
            queries = qserve_mod.queries_from_config(cfg)
        else:
            # No SFT_QSERVE query set: one range + one kNN standing query
            # per yml queryPoint, all under the default tenant.
            queries = []
            for i, p in enumerate(q_points):
                queries.append(qserve_mod.StandingQuery(
                    qid=f"range{i}", tenant="default", kind="range",
                    x=p.x, y=p.y, radius=q.radius, k=64,
                ))
                queries.append(qserve_mod.StandingQuery(
                    qid=f"knn{i}", tenant="default", kind="knn",
                    x=p.x, y=p.y, radius=q.radius, k=q.k,
                ))
        budgets = (cfg or {}).get("tenant_budgets")
        prev_ctrl = overload_mod.controller()
        installed = False
        if budgets:
            ctrl = overload_mod.OverloadController(
                overload_mod.OverloadPolicy(tenant_budgets=budgets)
            )
            if driver is not None:
                driver.overload = ctrl
            else:
                overload_mod.install(ctrl)
                installed = True
        op = qserve_mod.QServeOperator(
            window_conf, grid, mesh=mesh,
            cap_max=int((cfg or {}).get("cap_max",
                                        qserve_mod.QUERY_CAP_MAX)),
            device=device,
        )
        try:
            # Registration commands ride the same stream (deterministic
            # uids), so a --checkpoint resume replays them exactly; the
            # registry's applied-uid set keeps the replay idempotent.
            stream = itertools.chain(qserve_mod.boot_commands(queries),
                                     source)
            for res in op.run(stream, driver=driver):
                for line in res.lines():
                    sink(line)
                    n += 1
        finally:
            # The non-driver install must not outlive the run: restore
            # whatever controller was global before (the driver path does
            # this itself).
            if installed:
                if prev_ctrl is not None:
                    overload_mod.install(prev_ctrl)
                else:
                    overload_mod.uninstall()
    elif option == 7:
        op = TAggregateQuery(
            window_conf, grid, aggregate=q.aggregate_function,
            inactive_threshold_ms=q.traj_deletion_threshold * 1000,
            device=device,
        )
        for res in op.run(source):
            for cell, (cnt, lens) in sorted(res.cells.items()):
                sink(f"{res.start},{res.end},{cell},{cnt},{lens}")
                n += 1
    else:
        raise SystemExit(f"Unrecognized query option {option}. Use 1-10.")
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", required=True, help="geoflink-conf.yml path")
    ap.add_argument(
        "--source", default="synthetic",
        help="csv:<path> | geojson:<path> | socket:<host>:<port> | "
             "synthetic[:eps[:secs]] | kafka[:<topic>[@<bootstrap>]]",
    )
    ap.add_argument(
        "--output", default=None,
        help="output CSV path, or kafka[:<topic>[@<bootstrap>]] (the "
             "reference's producer side, StreamingJob.java:255; defaults "
             "from the yml's outputStream); default stdout",
    )
    ap.add_argument(
        "--max-records", type=int, default=None,
        help="stop after N input records (unbounded sources like kafka/"
             "socket run forever otherwise)",
    )
    ap.add_argument(
        "--checkpoint", default=None, metavar="PATH",
        help="pipeline checkpoint file: runs through the self-healing "
             "dataflow driver with exactly-once checkpointed egress "
             "(requires a file --output and a REPLAYABLE --source — "
             "csv/geojson; a run killed at any instant resumes from "
             "PATH with byte-identical concatenated output)",
    )
    ap.add_argument(
        "--checkpoint-every", type=int, default=8, metavar="N",
        help="auto-checkpoint cadence in fired windows (default 8)",
    )
    args = ap.parse_args(argv)

    params = Params.load(args.config)
    source = build_source(params, args.source)
    if args.max_records is not None:
        import itertools

        source = itertools.islice(source, args.max_records)
    if args.checkpoint:
        # Exactly-once pipeline: records stage in the transactional sink
        # and publish atomically with each driver checkpoint; on restart
        # the driver restores operator and assembler state, truncates any
        # uncommitted egress tail, and skips the already-consumed prefix
        # of the (replayed) source.
        if not args.output or args.output == "kafka" \
                or args.output.startswith("kafka:"):
            raise SystemExit(
                "--checkpoint requires a file --output (the exactly-once "
                "egress protocol is file-based; option 10 takes a "
                "directory — one sink per DAG node)"
            )
        if args.source.partition(":")[0] not in ("csv", "geojson"):
            raise SystemExit(
                "--checkpoint requires a replayable --source "
                "(csv:<path> or geojson:<path>) — resume replays the "
                "consumed prefix"
            )
        from spatialflink_tpu_torch.driver import WindowedDataflowDriver
        from spatialflink_tpu_torch.streams.sinks import (
            TransactionalFileSink,
        )

        if params.query.option == 10:
            # The composed DAG wires its own MultiSink (one transactional
            # sink per node under the --output dir) into the driver; the
            # unit checkpoint covers them all.
            driver = WindowedDataflowDriver(
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                sink=None,
            )
            n = run_job(params, source, None, driver=driver,
                        output_dir=args.output)
        else:
            sink = TransactionalFileSink(args.output)
            driver = WindowedDataflowDriver(
                checkpoint_path=args.checkpoint,
                checkpoint_every=args.checkpoint_every,
                sink=sink,
            )
            n = run_job(params, source, sink, driver=driver)
        print(f"StreamingJob done: {n} result records", file=sys.stderr)
        return 0
    if params.query.option == 10:
        n = run_job(params, source, None, output_dir=args.output)
        print(f"StreamingJob done: {n} result records", file=sys.stderr)
        return 0
    if args.output and (args.output == "kafka"
                        or args.output.startswith("kafka:")):
        from spatialflink_tpu_torch.streams.kafka import KafkaSink

        rest = args.output.partition(":")[2]
        topic, _, bootstrap = rest.partition("@")
        topic = topic or params.output_topic
        bootstrap = bootstrap or params.kafka_bootstrap_servers
        if not topic or not bootstrap:
            raise ValueError(
                "kafka output needs a topic and bootstrap servers (CLI "
                "kafka:<topic>@<bootstrap> or yml outputStream.topicName "
                "+ kafkaBootStrapServers)"
            )
        sink = KafkaSink(topic, bootstrap)
        try:
            n = run_job(params, source, sink)
        finally:
            sink.close()
    elif args.output:
        with CsvFileSink(args.output) as sink:
            n = run_job(params, source, sink)
    else:
        n = run_job(params, source, PrintSink())
    print(f"StreamingJob done: {n} result records", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
