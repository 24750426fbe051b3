#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spatialflink_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, full sizes
    python3 chip_smoke.py --quick    # phases 1-4, 7 and 11: build and check
    python3 chip_smoke.py --trajectory-only   # phases 1-2 and 23-26
    python3 chip_smoke.py --ingest-only       # phases 1-2 and 27-28
    python3 chip_smoke.py --domain-only       # phases 1-2 and 29-30
    python3 chip_smoke.py --runtime-only      # phases 1-2 and 31
    python3 chip_smoke.py --driver-only       # phases 1-2 and 32
    python3 chip_smoke.py --overload-only     # phases 1-2 and 33
    python3 chip_smoke.py --qserve-only       # phases 1-2 and 34
    python3 chip_smoke.py --jobsurface-only   # phases 1-2 and 35
    python3 chip_smoke.py --dag-only          # phases 1-2 and 36
    python3 chip_smoke.py --mesh-only         # phases 1-2 and 37
    python3 chip_smoke.py --partition-only    # phases 1-2 and 38
    python3 chip_smoke.py --multihost-only    # phases 1-2 and 39
    python3 chip_smoke.py --x64-only          # phases 1-2 and 40

Phases, each of which raises (and so exits non-zero) on failure:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand kernels from ``spatialflink_tpu_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print ptxas's report;
3. hold the wire-digest kernel (B1) bit-exact against its plain PyTorch
   version at the headline shape: a random pane, points exactly on the
   radius, many objects at equal distance, ``n_valid`` below the
   bucket, zero hits, and more than 16,384 hits; then the cases the
   one-launch design could get wrong: five calls in a row with the
   radius 0.5 → 0.05 → 0.5 → 0.05 → 0.5 and a zero-hit call after them,
   ``num_segments`` alternating 16,384 and 512, ``n_pad`` not a multiple
   of 8 and a view 2 bytes past a 16-byte boundary;
4. hold the codec-decode kernel (B2) bit-exact against its plain version
   at every bit width 0..16 (word-straddling fields included), on
   payloads of 1 and 7 words (shorter than their streams), at
   ``n_valid`` 0, at ``n % 8 != 0``, with ``num_segments`` alternating,
   on a delta-coded headline pane and on a pane after it in which half
   of the oids are absent (their predictors must stay);
5. run ``PointPointKNNQuery.run_wire_panes`` at the headline width (1M
   window, 500k slide, 16,384 objects, k=50, r=0.05, Beijing extent, 21
   panes from numpy seed 42) three ways: synchronous, pipelined raw, and
   pipelined with the delta codec. Every window must equal the same
   operator run on the CPU through the plain versions (starts, ends,
   ``nv`` and ids exact, distances bit-equal) and fill its top-50, and
   both kernels' launch counts must have moved;
6. time B1 and B2 (CUDA events, median of 30 launches at the headline
   shape) beside their bounds and plain versions, with their launches
   per call read from a profiler trace (one kernel and no memset each),
   and the timing method's floor: one near-empty kernel timed the same
   way;
7. hold the join-extraction kernel (B3) bit-exact against its plain
   version at the join's full shape (the JAX package's suite config 4:
   Beijing grid n=100, two 131,072-point sides from seeds 1 and 2,
   r=0.002, cap 48, 262,144 pairs): the headline, points exactly on the
   radius, over budget, a clustered side that overflows ``cap``, two
   candidate layers (r=0.03), an empty side, and out-of-grid points;
   then the cases the one-pass design could get wrong: planes with holes
   (live slots not a prefix), a saturated cell (48 × 432 pairs at
   r = +inf), budgets that cut inside a cell, exactly at a cell's end
   and at zero, a 101 × 101 grid, and five calls in a row array-equal;
8. run ``PointPointJoinQuery.run_soa`` at full width (two streams of
   16 × 131,072 points, one-second tumbling windows) through B3; every
   window must equal the same operator run on the CPU (starts, ends,
   ``count``, ``overflow``, index arrays in order, distance bits), and
   B3's launch count must rise by at least 16;
9. run ``PointPointJoinQuery.run`` on ``Point`` objects (2 windows ×
   20,000 points a side), WindowBased and RealTimeNaive, each equal to
   its CPU run as multisets of (left id, left ts, right id, right ts)
   with distances bit-equal;
10. time B3 beside its bound and plain version, with its launches per
   call read from a profiler trace (at most two kernels), the
   ``run_soa`` rate, and a profiler pass over one ``run_soa`` run;
11. hold the point→polyline min-distance kernel (B4) bit-exact against
   its plain version: the JAX package's suite config 3 (1,000 query
   polygons, a 262,144-point window), dense and gathered through the
   pruned path's real candidates; points on edges and at d² = r² on the
   2⁻²³ lattice; zero-length edges; multi-ring seams; boundaries of
   4,096 vertices (shared-memory tiles, and a set too large to stage);
   an all-invalid boundary (FLT_MAX); N not a multiple of the block;
   dense at G = 33, gathered at C = 3, and invalid edges between valid
   ones, dense and gathered;
12. run ``PointPolygonRangeQuery.run_soa`` at full width (config 3: 10 ×
   262,144 points, 1,000 polygons, the bbox-pruned path) through B4, the
   first 3 windows equal to the same operator run on the CPU (a cut of
   10), and B4's launch count up by at least 10; then, at 2–3 windows
   each and against the
   CPU: the dense path (32 polygons), the compact path (64), linestrings
   (32), approximate mode, ``PointPointRangeQuery.run_soa`` at suite
   config 1's width, and ``run`` on ``Point`` objects;
13. time B4 (gathered at config 3, dense at 32 polygons) beside its bound
   and plain version, with its launches per call, the range window's
   parts, the full-width
   ``run_soa`` rate, and a profiler pass over it;
14. run ``PolygonPolygonRangeQuery.run_soa`` at full width (4 one-second
   windows of 131,072 polygon objects, the JAX suite's window width of
   config 4: closed rings of 4-11 distinct vertices about uniform centres
   over the Beijing extent at radii up to 0.01 deg, seed 11, oids over
   16,384 objects; the first 32 polygons of config 3's set; r = 0.002),
   the first 2 windows equal to the same operator run on the CPU (starts,
   ends, kept indices and oids, distance bits; a cut of 4), every
   window's distances within the radius, and B4's launch count up by at
   least 2 a window (one launch a direction); then, at 2 windows of 8,192
   objects each and against the CPU, the other five geometry-stream
   classes (linestrings are the same rings opened), approximate mode, a
   multi-ring stream with edge-mask seams, and ``run`` on ``Polygon``
   objects;
15. run the point-stream kNN ``run`` on ``Point`` objects at full width
   (3 one-second windows of 200,000 points, config 2's event rate; 16,384
   objIDs, k = 50, r = 0.05) for a polygon query (polygon 0 of config 3's
   set), its outline opened as a linestring query, and ``QUERY`` as a
   point query, each window equal to the CPU run (objIDs in order,
   distance bits, representative events), the polygon and linestring
   runs filling their top-50 through B4; then, at 20,000 points,
   approximate mode, CountBased windows, and k = 100 over 32 objIDs
   raising ``ValueError`` on the card as on the CPU;
16. time the parts of one full-width geometry window (both B4
   directions, both containments, the reductions), B4 at this slice's
   three shapes (a->b at N·V x Q, b->a at Q·Vq x N, the kNN query at
   G = 1) beside its bound and plain version, the e2e rates of phases 14
   and 15, and a profiler pass over phase 14's run;
17. run ``PolygonPolygonKNNQuery.run_soa`` at full width on phase 14's
   stream (4 windows of 131,072 polygons; polygon 0 of config 3's set as
   the query, r = 0.05 deg, k = 50, 16,384 segments), each window equal to
   the same operator run on the CPU (starts, ends, ``nv``, oids in order,
   distance bits) and filling its top-50 through B4, whose launch count
   must rise by at least 2 a window; then, at 2 windows of 8,192 objects
   each and against the CPU, the other five classes (Point, Polygon and
   LineString queries), approximate mode, the multi-ring stream, ``run``
   on ``Polygon`` objects, and k = 100 over 32 objIDs raising
   ``ValueError`` on the card as on the CPU;
18. run ``PointPointKNNQuery.run_soa_panes`` and ``run_soa`` at the JAX
   suite's config 2 (25 one-second panes of 200,000 points from seed 42,
   5 s windows sliding by 1 s, 16,384 objIDs, k = 50, r = 0.05), every
   window equal between the two and to the CPU ``run_soa``; then, at a
   cut depth (3 panes of 40,000 ``Point`` objects, 2 s windows by 1 s),
   ``query_panes`` for a point, a polygon (exact and approximate) and a
   linestring query, each equal to its CPU run and to ``run``; and
   ``run_multi`` at the suite's multi-query config (64 queries from seed
   23, k = 10, r = 0.05, 2 windows of 262,144 ``Point`` objects from seed
   29) equal to its CPU run and, for the first and last query, to ``run``
   with that query alone, then at 2 windows of 16,384 points with every
   query equal to ``run`` alone;
19. time the parts of one full-width geometry kNN window (B4 both ways,
   both containments, the top-k), B4 at this slice's shapes beside its
   bound and plain version, the pane digest and merge per pane and per
   window, the e2e rates of phases 17 and 18, and a profiler pass over
   phase 17's run;
20. run ``PointPolygonJoinQuery.run_soa`` at the JAX suite's
   join_point_1000polygons, uncut (8 one-second windows of 131,072 points
   from seed 19 ⋈ the 1,000 zone polygons of seed 13, sent as a ragged
   stream each window; r = 0.002, Beijing grid n = 100), each window
   equal to the same operator run on the CPU (starts, ends, point and
   polygon indices in order, distance bits, counts), the pair total
   printed beside the suite's recorded 156,132, and B4's launch count up
   by at least 1 a window; then, at 2 windows of 8,192 points and against
   the CPU: ``PointLineStringJoinQuery`` (the outlines opened), both
   approximate modes (emit-all and ``PolygonPointJoinQuery``'s bbox
   distance), ``LineStringPointJoinQuery`` and ``run`` on ``Point`` and
   ``Polygon`` objects;
21. run ``PolygonPolygonJoinQuery.run_soa`` on the first 2 windows of
   phase 14's stream (2 × 131,072 polygons) ⋈ config 3's 1,000 polygons
   at r = 0.002, the first window equal to the CPU run (a cut of 2) and
   B4 up by at least 2 a window; then, at
   2 × 8,192, the other three geometry classes, approximate mode, the
   multi-ring stream and ``run`` on objects; then
   ``PointPointJoinQuery.query_panes`` on 3 panes of 20,000 ``Point``
   objects a side (2 s windows by 1 s, r = 0.002), each window equal to
   its CPU run in order and to ``run`` as a multiset, B3 launched once for
   each new block of two non-empty panes;
22. time the parts of one phase-20 window (the bbox prune and
   first-``cand``, B4 gathered, containment, ``_compact_pairs``) and of
   one phase-21 window (B4 both ways gathered, both containments, the
   compaction), B4 at these gathered shapes beside its bound and plain
   version, the e2e rates of phases 20 and 21, and a profiler pass over
   phase 20's run;
23. run ``PointPointTJoinQuery.run_soa`` at the JAX suite's
   tjoin_10s_1s_sliding (two streams of 30 one-second slides of 20,480
   points from seeds 31 and 32, 10 s windows by 1 s, 512 trajectory ids,
   r = 0.001, cap 64, grid n = 100) through B3: 39 windows, overflow 0
   in each, B3 launched at least once a window, and the first, a middle
   and the last full window equal to the CPU run (ids in key order,
   distance bits); then ``run`` and ``run_single`` on 2 windows of
   20,000 ``Point``s a side against the CPU; B3 and the trajectory-pair
   dedup timed at one full window (B3 beside its bound and plain
   version), the host steps, and a profiler pass over the run;
24. run ``traj_stats_sliding``'s device engine at bench_tstats_pane's
   shape (1,000,000 points, 500 ids in a 512 bucket, 10 s windows by
   10 ms, seed 17) against its CPU run and the numpy engine: starts,
   counts and temporal sums exact, spatial sums within
   ``pane_spatial_bound``; time its parts and profile it; then
   ``PointTStatsQuery.run_soa`` on the same stream at 10 s / 1 s and
   ``run`` (WindowBased, RealTime, CountBased) on 2 x 20,000 ``Point``s
   against the CPU, spatial sums within ``spatial_sum_bound``;
25. run ``PointPolygonTRangeQuery.run_soa`` on config 3's stream (10 x
   262,144 points, 16,384 ids) against phase 14's 32 polygons, and
   ``PointPointTKNNQuery``, ``PointTAggregateQuery`` (SUM) and
   ``PointTFilterQuery`` (64 ids) ``run_soa`` on phase 18's config-2
   stream; then the ALL, AVG, MIN and MAX aggregates, the inactive
   threshold, and ``run`` on ``Point``s of tRange, tKnn, tAggregate and
   tFilter at 2 x 20,000; each equal to its CPU run; and a profiler pass
   over the tRange run;
26. run ``PointPointTJoinQuery.run_soa_panes`` (the pane-carry engine,
   plain PyTorch) at the JAX suite's tjoin_panes_10s_10ms, its depth
   cut from 2,000 to 1,100 panes (10 s windows by 10 ms, ppw 1,000;
   panes of 1,024 points a side from seed 23; 64 ids, cap_w 256,
   pair_sel 16, r = 0.001, grid n = 100): 2,099 windows, one scan with
   every overflow counter 0, the capacity plan printed beside the
   measured occupancy, after the segmented pipelined scan (depth 4:
   eight segments of 150 slides) of the stream's first 200 panes a
   side, whose first 200 windows it must equal; time the host steps,
   the engine's steady state alone (a warm scan of 1,000 slides, then
   100 timed) and its parts a slide, with its launches a slide; a
   profiler trace of the operator run over the stream's first 200
   panes a side (1,199 slides, a cut of depth: the device's idle
   share), whose windows must equal all 1,199 of the segmented
   pipelined scan's, and of 20 steady slides (the kernel rows); then
   hold the card's windows equal (ids in order, distance bits) to the
   engine's CPU run of the stream cut to its first 1,024 panes over
   every window ending before pane 1,024, and to ``run_soa`` through B3
   at the windows starting 0 and 10,000 ms (10 s tumbling);
27. read the range suite's config 3 back from files through the port's
   ingest: its 1,000 polygons written as GeoJSON lines, WKT lines and a
   shapefile and read back (``polygon_stream``, ``read_shapefile``; the
   GeoJSON rings bit-equal to the generated ones, the shapefile's
   bit-equal reversed, as it stores exteriors clockwise), its 10 x
   262,144 points written as ``oid,ts,x,y`` CSV in ``to_csv_point``'s
   format and fed through ``csv_chunk_source`` and the native point
   parser (``native.py:NativePointParser``; a numpy parser of the same
   file as its cross-check: ts, x and y bit-equal, oids equal through the
   interner's names) into ``PointPolygonRangeQuery.run_soa`` on the card
   against the
   GeoJSON-read polygons (B4): every window bit-equal to the run fed the
   arrays directly, the first 2 to the CPU run; the rate from file to
   fetched results, the seconds inside the parser, and the device's idle
   share, all of one traced run; the GeoJSON-read polygons as a stream
   through ``PolygonPolygonRangeQuery.run`` against 32 shapefile-read
   ones, equal to the CPU run; then ``csv_source`` with
   ``parse_csv_point`` (2 x 20,000 ``Point``s, bad lines skipped) into
   ``run`` against the WKT-read polygons, and
   ``SyntheticGpsSource`` at its default rate, cut to 12 s (240,000
   events), into ``run``
   against 32 polygons, each equal to its CPU run; ``utm_forward``,
   ``utm_inverse`` and ``haversine_distance`` on 1,048,576 float64 points
   on the card within rtol 1e-12 of the host runs and a round trip within
   1e-11 deg;
28. run ``check_in_query_soa`` on the card (1,048,576 events, 10,000
   users, 256 rooms, missed doors of both directions) equal to the host
   walk ``check_in_query``; ``cell_stay_time_soa`` on the synthetic
   stream (10 s by 5 s, config 3's grid) equal to its CPU run (int64);
   ``sliding_aggregate`` (10 s by 10 ms, host numpy) against a
   brute-force loop over its first 50 windows;
29. run the SNCB layer on the benchmark runner's stream
   (``SyntheticGpsSource`` over the Brussels bbox, 20,000 events/s for
   30 s, 10 devices, seed 42: 600,000 events) and a copy of it with FA ~
   U(0, 1) and FF ~ U(0, 0.4) from seed 29: ``contains_any_zone`` on the
   card (float64) over all 600,000 points for Q1's zones (20 + 20 m), the
   maintenance areas (0 m), the Q5 fence (20 m) and MN_Q5's degree-space
   fence (0.001), each mask equal to the numpy twin and the CPU run, with
   its device time on resident inputs (CUDA events) and the whole call's
   wall; ``benchmark_runner`` q1 and
   q5 at 600,000 events, record for record equal to their CPU runs, the
   card runs traced for the device's idle share;
   ``q2_brake_monitor_batch`` (10 s by 10 ms) over the FA/FF copy equal
   to its CPU run and, over its first 50 windows, to a ``q2_window``
   loop; ``benchmark_runner`` q2 and q3 at 25,000 events and
   ``local_test_runner`` (cuts);
30. run ``mobility_runner`` q1-q5 and ``instrumented_mn_q1``-``q5`` over
   20,000 14-column CSV lines of the FA/FF stream (a cut), q5's rows and
   result file on the card equal to the CPU's, and print each
   instrumented query's host-pipeline latency percentiles (ingest stamp
   to sink, NES buckets); then the op counters: ``enable()``,
   ``PointPolygonRangeQuery.run_soa`` over config 3's first 2 windows
   through B4 on the card and on the CPU, the two snapshots equal (the
   throughput left out), and a disabled run recording 0.
31. the runtime layer (``telemetry.py``, ``faults.py``, ``ablation.py``)
   on the card: the headline ``run_wire_panes`` synchronous (B1) and
   pipelined with the delta codec (B1, B2; its first 8 of 21 panes),
   ``PointPointKNNQuery.run_soa`` at suite config 2 (its first 10 of 25
   panes), ``PointPolygonRangeQuery.run_soa`` at config 3 (B4; its first 4
   of 10 windows) and ``PointPointJoinQuery.run_soa`` at config 4 (B3),
   each run warm,
   then with telemetry disabled and enabled (a trace and a ledger stream
   written): every window bit-equal, the same count of synchronising
   calls (CUDA's sync debug mode), fetches equal to the operator's own,
   the headline's h2d bytes (6 B a point at the pane bucket; the codec's
   words) and wire raw and coded bytes equal to the counts computed here,
   the trace's spans nested, the ledger and the recovered stream valid
   (``tools/sfprof``); window latency p50/p95/p99 of ``window.knn_soa``
   (the NES histogram and the exact span percentiles), the dispatch
   table of the paths without a window span, and each path's rate with
   telemetry off and on (medians of 3-7 alternating pairs outside the
   debug mode); then ``device.dispatch`` (at B1's third call),
   ``device.ship``, ``device.fetch``, ``pipeline.ship`` and
   ``pipeline.fetch`` each raising ``InjectedFault`` on the card, recorded
   in the events and the snapshot, a ``hang`` rule sleeping then raising,
   and a disarmed rerun bit-equal; B1 ablated on the synchronous run and
   B2 on the delta run (windows zeroed after the learning pane, the
   snapshot tainted, the TAINTED rates, timed with telemetry off, beside
   the baseline, a disarmed rerun bit-equal); ``LinkProbe`` latency and
   round-trip rate.
32. the dataflow driver (``driver.py``), checkpoints and exactly-once
   egress on the card: (a) ``PointPolygonRangeQuery.run(driver=)`` at
   config 3's width (262,144 points a window with the suite stream's
   16,384 objIDs, 1,000 polygons, r = 0.002; 2 of its 10 windows, a cut
   of depth) through B4 into a ``TransactionalFileSink``, checkpointed
   every window: clean with telemetry on (each commit's ms and
   checkpoint bytes, the e2e stage percentiles), a child process killed
   by a ``sink.write`` abort at commit 2 and a second child that resumes
   (its ms to the first result), and the same run on the CPU, the three
   egress files byte-identical; (b) ``PointPointJoinQuery.run(driver=)``
   WindowBased through B3 at phase 9's 2 x 20,000 Points a side with
   ``driver.window`` failing twice under a retry budget of 2 (windows
   equal the unarmed run, 2 retries), then three times with failover on
   (it raises: the grid join has no twin); (c)
   ``PointPointKNNQuery.run(driver=)`` with a point query at phase 15's
   stream cut to 2 x 200,000 Points, ``device.dispatch`` dead from window
   2: backend
   ``fallback``, one failover in the stats and the trace, the windows'
   ordered winners equal to the clean card run and distances within rtol
   3e-7; (d) the headline ``run_wire_panes`` through B1 stopped after
   pane 10, checkpointed (bytes and ms), restored into a card operator
   and a CPU operator, each continuation bit-equal to the uninterrupted
   synchronous windows; (e) ``python -m spatialflink_tpu_torch.driver
   --chaos-smoke`` on the card, exit 0.
33. overload control and the SLO engine (``overload.py``, ``slo.py``) on
   the card: (a) the headline ``run_wire_panes`` (phase 5's 21 panes)
   under a ``batch_slides`` rung of width 4, stepped down by one violating
   SLO evaluation, through B1: windows bit-equal to the unbatched card run
   and to the CPU run, ``telemetry.fetch`` calls and synchronising calls a
   window unbatched and batched (2 → 1/4 fetches), a checkpoint taken
   with a batch open restored into a fresh card operator with no window
   lost, and 4 alternating timed pairs of the two with one traced run
   each (device idle share); (b) ``PointPolygonRangeQuery.run`` at config
   3's width (2 × 262,144 ``Point``s, 1,000 polygons, phase 32a's stream)
   through B4 under a non-pausable admission budget of half a window's
   events: the shed counts, the overload block and the egress equal to
   the CPU run's; stopped by ``driver.window`` right after window 1's
   commit and resumed by a fresh driver, byte-identical with the same
   sheds; ``overload.admit`` armed at hit 1,000 raising on that item
   before its decision; (c) the circuit breaker (2 failures open it, a
   probe every 3rd fallback window) on ``PointPointRangeQuery.run`` (8 ×
   20,000 ``Point``s), synchronous and pipelined: windows 3-4 on the
   numpy twin, the probe closing it, ``breaker_collapsed()`` true at the
   open windows' yields, the pipeline collapsed and resumed, windows equal
   the clean run; the naive join's 20 micro-batches the same; and with a
   breaker configured but no twin (the reference routes nothing then),
   ``PointPolygonRangeQuery.run`` and the bucketed join's 8 windows one
   B4 / B3 launch a window, equal to the runs without a controller; (d)
   the ``pane_backend`` rung routing ``traj_stats_sliding(backend=
   "auto")`` at 1,000,000 points to the host engines, the native one
   first (within
   ``pane_spatial_bound`` of the device engine) and ``clamp_compaction``
   pinning the pane-carry tJoin's capacity rung (phase 26's shape, 24
   panes a side), windows equal; (e) an ``SloSpec`` of the shed,
   degraded-window, retry and failover budgets and the lag and e2e
   ceilings over 33c's synchronous breaker run and 33b's clean run, its
   verdict sealed in the ledger stream, every check as on the CPU; and
   ``python -m spatialflink_tpu_torch.overload --smoke`` on the card in
   the background, exit 0.
34. standing-query serving (``qserve.py``, ``ops/query_registry.py``; the
   registry program is plain PyTorch, as the JAX program is plain
   ``jnp``) on the card: (a) ``registry_bucket_kernel`` at the JAX
   suite's qserve_1024q_mixed (1,024 standing queries from seed 37, half
   range and half kNN, k (32, 5, 10, 30), r (0.002, 0.02, 0.05) deg, in 12
   buckets; 8 windows of 131,072 points of the suite's stream from seed 41
   with 16,384 objIDs; 16 queries swapped in each bucket every window at
   the same occupancy), every live lane of every window equal to that
   query run alone through ``knn_points_fused`` on the card (segment,
   index, ``num_valid`` exact, distance bits), padded lanes empty, windows
   0 and 7 bit-equal to the CPU run (a cut), the program's signatures
   within the ladder's rungs x the k-rungs; the rate, the device's busy
   ms a window and idle share (a traced run), its kernel launches a
   window and the host ms of each window's churn restaging; (b)
   ``QServeOperator.run(driver=)`` over the 1,024 boot registrations, 2
   one-second windows of 131,072 ``Point``s at 34a's positions (a cut of
   8 windows: the feed is per-event Python) and 32 churn commands a
   window, under tenant budgets (a "firehose" class over its standing-
   query budget, a "bulk" class over its result budget) and an
   ``SloSpec.tenant_budgets`` verdict, checkpointed every window: the
   egress of the clean card run, the CPU run and a run stopped after
   window 1 and resumed in a fresh operator byte-identical, the registry
   counters, the truncations and the SLO tenant rows equal.
35. the job surface's leaf modules (``envvars``, ``config``, ``native``,
   ``streams/kafka``, ``streams/kafka_wire``): (a) the native engines
   (``native/libsfnative.so``, built by ``make``, its ABI checked; the
   phase fails if either fails) beside the card's: ``traj_stats_sliding``
   at bench_tstats_pane (1,000,000 points), native bit-identical to
   numpy, against the device engine on the card (counts and temporal
   sums exact, spatial within ``pane_spatial_bound``), and under an armed
   ``pane_backend`` native rung ``"auto"`` running the native engine (its
   calls counted); ``run_soa_panes(backend="native")`` against the device
   engine on phase 26's stream cut to 100 panes a side (pair sets equal
   outside the radius band of 3 float32 roundings, the band's pairs
   counted, common minima within that bound); each engine's seconds; (b)
   Kafka into the headline program through B1: an in-process broker
   (``MiniBroker``: Metadata, Produce, Fetch and ListOffsets over TCP),
   ``ts,x,y,oid`` records produced by ``KafkaSink`` (4 panes of 65,536 of
   the headline's points, coordinates from the wire), a job read by
   ``config.Params`` from the reference's YAML schema with ``backend:
   cuda``, ``WireKafkaSource`` → ``WirePaneAssembler`` →
   ``run_wire_panes`` on the card; a checkpoint (the source's offsets,
   the assembler, the operator) after window 1, ``kafka.fetch`` raising
   at a later fetch, a resume in fresh objects: the committed and
   resumed windows equal the uninterrupted card run, every window the
   CPU run through B1's plain version; produce and consume records/s,
   the host seconds in parse and feed, B1's launches, the device idle
   share, the checkpoint's bytes and commit ms, the resume's ms to its
   first window.
36. the composed SNCB dataflow and the StreamingJob entry point
   (``dag.py``, ``streaming_job.py``): (a) the seven-node DAG
   (``build_sncb_dag``: q1-q5, staytime, qserve with the default standing
   queries booted on the stream) over phase 29's FA/FF stream cut to
   2,000 events/s for 30 s, checkpointed every 2 windows with telemetry
   on: every sink byte-identical to the same run on the CPU, no node
   retried, failed over or degraded on the card, ``snapshot()["dag"]``
   carrying all seven nodes, an ``SloSpec`` with ``node_budgets`` on
   every node passing; per-node seconds (the ``node.<name>`` spans),
   events/s, the device idle share, each commit's ms and bytes, the zone
   test's and the registry program's launches; (b) a child process
   running (a)'s DAG on the card killed by an ``abort`` at the third unit
   commit's second sub-append (``dag.commit`` ``at: 16``), a second child
   resuming from the unit checkpoint: every sink byte-identical to (a)'s
   card run; the resume's ms to its first window and the checkpoint's
   bytes; and ``python -m spatialflink_tpu_torch.dag --smoke`` on the
   card, exit 0; (c) ``streaming_job.main`` from a YAML in the reference
   schema with ``backend: cuda`` against the same YAML with ``backend:
   cpu``: options 1, 3, 6 and 8 over a CSV of phase 9's 2 x 20,000
   ``Point``s (its first second, the sides merged in event time), option
   5 over the same records side after side with ``query.incremental:
   true`` (its halves the two streams, through B3, whose launches must
   rise), option 9 with the default standing set, each output
   byte-identical between the card and the CPU; option 3 to ``--output
   kafka:`` through ``MiniBroker``, the records read back equal to the
   CSV output; option 10 with ``--checkpoint`` over a CSV of (a)'s
   stream, in a child killed by an ``abort`` fault and a child resuming,
   each node file byte-identical to an uninterrupted run.
37. the mesh layer (``parallel/``): every leg runs one operator twice on
   the card, unsharded and with ``mesh=`` four shards of ``cuda:0``
   (``make_mesh((4,), ("data",), devices=["cuda:0"] * 4)``), the mesh
   run equal to the unsharded run of the same windows: (a) the point
   range ``run`` on a window of 65,536 ``Point``s against config 3's
   1,000 polygons (r = 0.002), keep sets and distance bits equal, B4 four
   launches a window; (b) ``PointPointKNNQuery.run`` (k = 50) on the
   same stream and ``run_multi`` with 64 queries on the (2, 2) data x
   query mesh, winners and distance bits equal; (c) the point join
   ``run`` over phase 9's first second (2 x 20,000 ``Point``s) through
   B3 a shard, a window run again with a budget below its pairs (the
   budget retry), and point ⋈ polygon ``run`` at 2 x 8,192, pair sets
   with distance bits equal; (d) qserve_1024q_mixed's first window
   (``QServeOperator.run`` through ``sharded_registry_bucket``), egress
   lines equal; (e) ``traj_stats_sliding(mesh=)`` on bench_tstats_pane
   cut to 262,144 points (counts and temporal sums exact, spatial sums
   within ``pane_spatial_bound``) and ``run_soa_panes(mesh=)`` at 100
   panes a side, windows equal; (f) ``streaming_job.main`` with
   ``deviceMesh: [4]`` on ``backend: cuda`` raising "need 4 devices,
   have 1" on the one card, and the DAG smoke's mesh child on the card
   (36b's; a child of its own under ``--mesh-only``) accounting
   collective bytes above 0. Each leg prints its mesh and
   unsharded ms a window (four shards on one card: the split and
   collective overhead, not a scaling figure), the collective gauges and
   the B3 and B4 launches it adds.
38. the grid-partitioned halo layer and multi-process runs
   (``parallel/partition.py``, ``ops/halo.py``, ``parallel/halo.py``,
   ``parallel/multihost.py``), on an eight-shard mesh of ``cuda:0``:
   (a) ``sharded_range_halo`` at the JAX suite's range_8shard_halo
   (Beijing grid n = 1,024, r = 0.002, 4 windows of 16,384 float64
   points and 4,096 queries from seed 47), keep and distance bits equal
   to the single-device ``range_partitioned_kernel`` on the card, keep
   sets equal to the replicated ``sharded_range_query``, every window
   equal to its CPU run, the halo's ppermute and halo-state bytes beside
   the replicated broadcast's; (b) ``python -m
   spatialflink_tpu_torch.driver --chaos-sharded-child`` on the card
   clean, killed by an ``abort`` at the fifth ``shard.exchange`` (exit
   137) and resumed, and on the CPU, the resumed egress byte-identical
   to both; (c) ``sharded_tjoin_panes_halo`` at tjoin_8shard_halo (grid
   n = 256, r = 0.005, ppw 4, 8 slides of 2,048 points a side), every
   slide's pairs, count and distance bits equal to the single-device
   ``join_partitioned_kernel``, and one slide at a budget below its
   pairs (overflow above 0, the count whole) equal to its CPU run; (d)
   ``sharded_registry_bucket_halo`` on qserve_1024q_mixed's first window
   (131,072 points, its 1,024 queries, k = 32, the plan for r = 0.05)
   bit-equal to the single-device kernel on the card and to its CPU run;
   (e) ``run_dryrun(2, 2, device="cuda")``: two gloo ranks of two shards
   each, both printing the OK line, beside the card's compute mode. The
   children of (b) and (e) start before phase 36 in the full run (at the
   phase's start under ``--partition-only``). Each leg prints its ms on
   the card.
39. the four programs that gather over a mesh spanning processes
   (``parallel/mesh.py:gather_parts``, ``parallel/multihost.py:
   global_mesh``): two gloo ranks of ``cuda:0``, two shards each,
   started once after phase 38's children have ended; each leg runs its
   program on the spanning mesh and, in the same rank, on a mesh of four
   ``cuda:0`` shards in one process, bit for bit: (a)
   ``sharded_range_query_2d`` on a (2, 2) mesh, 262,144 points of config
   3's stream (seed 7) against 1,024 query points from seed 8, r =
   0.002; (b) ``sharded_knn_multi`` on a (2, 2) mesh at
   knn_multi_64queries_k10's first window (262,144 points, 64 queries,
   k = 10); (c) ``sharded_registry_bucket`` on a 1-D mesh of 4 at 38d's
   window and queries; (d) ``sharded_tjoin_pane_scan`` on a 1-D mesh of
   4 at 37e's cut of tjoin_panes_10s_10ms, every slide's window minima
   and the whole carry. Rank 0 also holds (a) and (b) bit-equal to a
   one-process CPU mesh. Both ranks' digests of every output must agree;
   a rank that fails, or runs past 600 s and is killed, fails the phase.
   Each leg prints both ranks' spanning and one-process ms, its gloo
   collectives and the bytes they delivered;
40. the float64 mode (``precision.x64(True)``, the entry points' default
   dtype): (a) B3's float64 instantiation bit-exact against its plain
   version at the join's full shape (two 131,072-point sides, r = 0.002,
   cap 48, 262,144 pairs), with 20,000 points exactly on the radius, a
   budget cut and two layers (r = 0.03, over budget and at its need);
   (b) B4's float64 instantiation bit-exact at config 3's gathered shape,
   dense at 65,536 points and 33 boundaries, three slots, and boundaries
   with no valid edge at DBL_MAX, dense and gathered; (c) thirteen legs
   in float64 on the card, each at full width in a depth cut: the
   point-stream range (config 3's polygons, 32 linestrings, config 1's
   point query), kNN (config 2, two windows) and join (config 4); the
   geometry range (phase 14's 131,072 rings against 32 polygons) and kNN
   (phase 17's, k = 50); the point ⋈ polygon (join_point_1000polygons)
   and polygon ⋈ polygon (phase 21's, pruned) joins, one window each;
   ``run_soa_panes`` (config 2's first five panes), ``query_panes`` with
   a polygon query (3 panes of 40,000), ``run_multi`` (64 queries over
   262,144 points) and ``PointPointJoinQuery.query_panes`` (3 panes of
   20,000 a side). Each equals the same run on the CPU through the plain
   versions, window for window, float64 distances bit for bit; B3's
   float64 launches and B4's, dense, at G = 1 and gathered, must move,
   and on the card the plain versions raise if a leg reaches them; (d)
   both float64 kernels' times, plain times and bounds (FP64 at 34
   TFLOP/s), B4 also at the dense, G = 1 and join-tile shapes, and B3 at
   tJoin's (tjoin_10s_1s_sliding's window at 0: 204,800 points a side,
   cap 64, r = 0.001; bit-exact against its plain version first), added
   to the JSON record as ``join_extract_f64`` (its ``launches_tjoin`` and
   ``shapes``) and ``polyline_min_dist_f64`` (its ``shapes`` and
   ``launches_by_mode``); (e) the trajectory and serving slice in float64
   on the card, one window a leg at full width: tJoin ``run_soa`` through
   B3 at cap 64 (tjoin_10s_1s_sliding's window at 0), ``run`` and
   ``run_single`` (phase 23's ``Point``s, their first window),
   ``run_soa_panes`` on the device engine (tjoin_panes_10s_10ms cut to
   100 panes a side), the tStats device pane engine (bench_tstats_pane's
   1,000,000 points, uncut) and ``run_soa`` (its window at 0), tRange,
   tKnn and tAggregate (SUM) ``run_soa`` (phase 25's streams, one window
   each) and ``QServeOperator.run`` (qserve_1024q_mixed's first window),
   each equal to its CPU run through the plain versions (float64
   distances bit for bit, tStats sums within their float64 bounds); the
   tJoin legs' float64 B3 launches must move, and no leg reaches a plain
   version on the card.

In the full run the heaviest CPU twins (phases 8, 12, 14, 20-23, 25, 26,
38 and 40) run in two spawned worker processes of one torch thread each, at
the lowest scheduling priority, started before phase 2; the main
process gives their threads cores of its own. Each returns a
digest of the inputs it built, which must equal the digest of the card
run's inputs. Their comparisons with the card's windows run after phase
36 (the "exact ..." lines there); the line "CPU twins in background
processes" prints each twin's seconds and how long the run waited for
it.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Every number printed was measured in
this run on the card named beside it.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings

import numpy as np

# The headline configuration (the JAX package's bench.py:44-51).
WINDOW = 1_000_000
SLIDE = WINDOW // 2
N_WINDOWS = 20
K = 50
NUM_SEGMENTS = 16_384
RADIUS = 0.05
# The reference's default Beijing grid and the central query point.
BEIJING = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
               max_y=41.1)
QUERY = (116.40, 40.19)

# The join's full shape: the JAX package's suite config 4
# (bench_suite.py:423-492).
JOIN_WIN = 131_072
JOIN_WINDOWS = 16
JOIN_R = 0.002
JOIN_CAP = 48
JOIN_MAX_PAIRS = 262_144
JOIN_OBJ_POINTS = 20_000  # per side per window on the object path
JOIN_OBJ_WINDOWS = 2

# The range family's full width: the JAX package's suite config 3
# (bench_suite.py:357-420) and, for point queries, config 1
# (bench_suite.py:182-232).
RANGE_WIN = 262_144
RANGE_WINDOWS = 10
RANGE_R = 0.002
RANGE_POLYS = 1000
RANGE_CUT_WINDOWS = 3
RANGE_CPU_WINDOWS = 3    # phase 12's windows held against the CPU (a cut of 10)
PP_WIN = 500_000
PP_R = 0.005
RANGE_OBJ_POINTS = 20_000
RANGE_OBJ_WINDOWS = 2

# The geometry-stream range path at the JAX suite's window width of
# config 4 (bench_suite.py:423-492; the suite has no geometry-stream
# configuration of its own), and the point-stream kNN run at its config 2
# event rate of 200,000 points a second (bench_suite.py:235-354).
GEOM_WIN = 131_072
GEOM_WINDOWS = 4
GEOM_OBJECTS = 16_384
GEOM_QUERIES = 32
GEOM_R = 0.002
GEOM_CUT_WIN = 8_192
GEOM_CUT_WINDOWS = 2
GEOM_CPU_WINDOWS = 2     # phase 14's windows held against the CPU (a cut of 4)
KNN_RUN_WIN = 200_000
KNN_RUN_WINDOWS = 3
KNN_RUN_IDS = 16_384
KNN_RUN_K = 50
KNN_RUN_R = 0.05
KNN_RUN_CUT = 20_000
# Phases 17-19: geometry-stream kNN on phase 14's stream (polygon 0 of
# config 3's set as the query); the pane-carry and SoA kNN paths at the
# JAX suite's config 2 (bench_suite.py:235-260: 5 s windows sliding by
# 1 s, 200,000 points a pane, 25 panes, 16,384 objIDs) and its
# multi-query config (bench_suite.py:495-527: 64 query points from seed
# 23, 262,144-point windows from seed 29).
KNN_GEOM_R = 0.05
KNN_GEOM_K = 50
PANE_PTS = 200_000
PANES = 25
PANE_WINDOW_S = 5.0
PANE_K = 50
PANE_R = 0.05
QP_PANE_PTS = 40_000
QP_PANES = 3
MULTI_Q = 64
MULTI_K = 10
MULTI_R = 0.05
MULTI_WIN = 262_144
MULTI_WINDOWS = 2
MULTI_CUT = 16_384

# Phases 20-22: the rest of the join. Phase 20 is the JAX suite's
# join_point_1000polygons (bench_suite.py:792-934: 8 windows of 131,072
# points from seed 19 ⋈ 1,000 zone polygons from seed 13, r = 0.002,
# Beijing grid n = 100), uncut; phase 21 joins phase 14's polygon stream
# with config 3's 1,000 polygons; the other classes run at 2 windows of
# 8,192, and query_panes at 3 panes of 20,000 Points a side.
PG_WIN = 131_072
PG_WINDOWS = 8
PG_POLYS = 1000
PG_R = 0.002
SUITE_PG_PAIRS = 156_132  # BENCH_SUITE.json, join_point_1000polygons
JOIN_CUT_WIN = 8_192
GG_WINDOWS = 2  # phase 21's polygon ⋈ polygon run_soa: a depth cut of 4
GG_CPU_WINDOWS = 1  # of them held against the CPU (a cut of 2)
JOIN_CUT_WINDOWS = 2
QPJ_PANE_PTS = 20_000
QPJ_PANES = 3

# Phases 23-25: the trajectory layer. Phase 23 is the JAX suite's
# tjoin_10s_1s_sliding (bench_suite.py:936-1068: two streams of 30
# one-second slides of 20,480 points, positions uniform on the Beijing
# extent from seeds 31 and 32, 512 trajectory ids, 10 s windows by 1 s,
# r = 0.001, cap 64, grid n = 100), its positions unquantized; phase 24
# is bench_tstats_pane's stream (bench_suite.py:1244-1262: 1,000,000
# points, ts sorted uniform in [0, 30,000) ms, 500 trajectories in a 512
# bucket, 10 s windows by 10 ms, seed 17); phase 25 runs tRange on config
# 3's stream and tKnn, tAggregate and tFilter on config 2's. The object
# paths and the other modes run at 2 windows of 20,000 points.
TJ_SLIDE_PTS = 20_480
TJ_SLIDES = 30
TJ_WINDOW_S = 10
TJ_IDS = 512
TJ_R = 0.001
TJ_CAP = 64
TJ_MAX_PAIRS = 262_144
# The CPU twin of phase 23 runs 10 s tumbling windows on the same stream:
# the windows starting at 0, 10 and 20 s, the first, a middle and the
# last full window of the sliding run. The host's plain join tests 10,000
# cells x 64 x 576 slot pairs a window whatever the points, so all 39
# windows took 83-102 s on the chip machine's CPU.
TJ_CPU_STARTS = (0, 10_000, 20_000)
TS_POINTS = 1_000_000
TS_SPAN_MS = 30_000
TS_IDS = 500
TS_BUCKET = 512
TS_WINDOW_MS = 10_000
TS_SLIDE_MS = 10
T_CUT = 20_000  # points a window of the cut-depth runs, 2 windows
TR_IDS = 16_384
TR_QUERIES = 32
TF_IDS = 64
# Phase 26: the pane-carry tJoin at the JAX suite's tjoin_panes_10s_10ms
# (bench_suite.py:1071-1241): 10 s windows by 10 ms (ppw 1,000), 1,024
# points a side a pane over 1,100 panes (ppw to fill the window, then
# 100 steady: a depth cut of the suite's 2,000), positions uniform on
# the Beijing extent and ids uniform over 64 from seed 23, cap_w 256,
# pair_sel 16, r = 0.001, grid n = 100 (one candidate layer: 9 cells
# probed a point). The CPU twin
# runs the engine on the first TP_CPU_PANES panes: the windows ending
# before that pane, 25 of them full (the CPU takes ~25-40 ms a slide at
# this width, so the whole stream's 2,499 would take minutes).
TP_PPW = 1000
TP_SLIDE_MS = 10
TP_PANE_PTS = 1024
TP_STEADY = 100
TP_PANES = TP_PPW + TP_STEADY
TP_IDS = 64
TP_CAP_W = 256
TP_PAIR_SEL = 16
TP_R = 0.001
TP_CPU_PANES = TP_PPW + 24
TP_PROFILE_SLIDES = 20
TP_TRACE_PANES = 200  # panes a side of the traced operator run (a cut)
# The segmented pipelined scan runs on that cut at depth 4: eight
# segments of 150 slides, the new panes in the first two, the expiring
# ones in the last two.
TP_SEG_DEPTH = 4
TP_REPS = 3
# Phases 27-28: ingest and the apps. Phase 27 reads config 3 back from
# files (phase 12's 1,000 polygons as GeoJSON lines, WKT lines and a
# shapefile; its 10 x 262,144 points as oid,ts,x,y CSV, oids over
# TR_IDS); the CPU twin of the CSV run_soa compares its first
# INGEST_CPU_WINDOWS windows (a cut: ~5 s a window on the host). The
# synthetic GPS source runs at its default rate (20,000 events/s, 10
# devices, seed 42) for SYN_DURATION_MS of its default 30 s (a depth
# cut) over the Beijing extent into
# PointPolygonRangeQuery.run against config 3's first SYN_QUERIES
# polygons, and feeds phase 28's stay time (10 s windows by 5 s, config
# 3's grid) and pane aggregates (10 s by 10 ms, brute force on the first
# AGG_BRUTE_WINDOWS windows). CRS: CRS_POINTS float64 lon/lat points over
# Belgium from seed 43. Check-in: CHECKIN_EVENTS events from seed 44,
# each with probability CHECKIN_REPEAT its user's previous door again (a
# missed event of either direction).
INGEST_CPU_WINDOWS = 2
SYN_QUERIES = 32
SYN_DURATION_MS = 12_000  # the synthetic source's run: 12 of its 30 s
CRS_POINTS = 1 << 20
BELGIUM = (2.5, 6.4, 49.5, 51.5)
CHECKIN_EVENTS = 1 << 20
CHECKIN_USERS = 10_000
CHECKIN_ROOMS = 256
CHECKIN_REPEAT = 0.2
STAY_WINDOW_S, STAY_SLIDE_S = 10, 5
AGG_SIZE_MS, AGG_SLIDE_MS = 10_000, 10
AGG_BRUTE_WINDOWS = 50

# Phases 29-30: the SNCB and MobilityNebula domain layers. The stream is
# BenchmarkRunner.java:22-105's (the JAX runners.py:100-106 defaults):
# SyntheticGpsSource over the Brussels bbox at 20,000 events/s for 30 s,
# 10 devices, seed 42, FA = FF = 5.0; a second copy carries FA ~ U(0, 1)
# and FF ~ U(0, 0.4) from seed 29 (bench_suite.py:732-733) so that Q2
# alerts. Cuts, to keep phases 29-30 under 90 s and the whole script near
# 1,000 s on a slow host: benchmark_runner q2 and q3 at
# SNCB_HOST_DURATION_MS (25,000 events; 4.0 and 5.3 s at 100,000 on an
# H100 machine's host CPU); Q2's batch replay checked by brute force on its first
# Q2_BRUTE_WINDOWS windows; the MobilityRunner and instrumented queries
# over MN_LINES CSV lines (43.6 s at 100,000, MN_Q2's 10 s by 200 ms
# global windows 23.4 s of it); the counters over config 3's first
# COUNTER_WINDOWS windows.
SNCB_EPS = 20_000
SNCB_DURATION_MS = 30_000
SNCB_DEVICES = 10
SNCB_T0 = 1_700_000_000_000
SNCB_HOST_DURATION_MS = 1_250
Q2_BRUTE_WINDOWS = 50
MN_LINES = 20_000
COUNTER_WINDOWS = 2

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the
# tensor cores (used for the kernels' 32-bit scalar operations).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
REPEATS = 30
LAUNCH_CALLS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    """Bit-equality of two tensors on one device (float distances
    compared as bits)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    elif a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Max |a - b| on the tensors' device; float entries at their dtype's
    max in both (no valid edge, no candidate) are left out."""
    import torch

    if a.dtype in (torch.float32, torch.float64):
        big = torch.finfo(a.dtype).max
        live = (a < big) | (b < big)
        a, b = a[live].double(), b[live].double()
    else:
        a, b = a.double(), b.double()
    return float((a - b).abs().max()) if a.numel() else 0.0


def headline_panes(wf):
    """The headline stream, made as bench.py makes it (seed 42)."""
    rng = np.random.default_rng(42)
    total = SLIDE * (N_WINDOWS - 1) + WINDOW
    xyq = wf.quantize(np.stack(
        [rng.uniform(115.5, 117.6, total), rng.uniform(39.6, 41.1, total)],
        axis=1,
    ))
    oid16 = rng.integers(0, NUM_SEGMENTS, total).astype(np.int16)
    wire = np.concatenate([xyq, oid16.view(np.uint16)[:, None]], axis=1)
    return [np.ascontiguousarray(wire[i * SLIDE:(i + 1) * SLIDE].T)
            for i in range(total // SLIDE)]


def time_ms(fn, repeats=REPEATS):
    """(device ms, call ms): medians over ``repeats`` calls of ``fn``
    after two warm-up calls.

    Device ms: the calls are queued behind a ~25 ms sleep kernel, so the
    host runs ahead and each call's event pair spans only its device
    work (a call that waits on the device inside, as a plain version
    with ``nonzero`` does, still shows its host gaps). Call ms: one call
    at a time, each waited for, so it includes the host's launch cost."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(repeats)]
    torch.cuda._sleep(50_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    device = statistics.median(s.elapsed_time(e) for s, e in pairs)
    calls = []
    for start, end in pairs:
        start.record()
        fn()
        end.record()
        end.synchronize()
        calls.append(start.elapsed_time(end))
    return device, statistics.median(calls)


def launches_per_call(fn):
    """(kernel launches, memsets) that one call of ``fn`` puts on the card:
    the device activities of ``LAUNCH_CALLS`` calls in a profiler trace
    (torch.profiler, CUDA activity), per call; the most of three traces,
    since a trace can lose activities but never adds any."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(LAUNCH_CALLS):
                fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        memsets = sum(n.startswith("Memset") for n in names)
        copies = sum(n.startswith("Memcpy") for n in names)
        counts.append((len(names) - memsets - copies, memsets))
    kern, mems = max(counts)
    return kern / LAUNCH_CALLS, mems / LAUNCH_CALLS


def profile_run(run, card, label="sync run"):
    """Device busy share and device time by kernel over one ``run()``
    (torch.profiler, CUDA activity). Busy time is the union of the
    device-side intervals (kernels, copies, memsets): summing every
    profiler row would count each kernel twice, once under the operator
    that launched it. Returns (wall ms, busy ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for lo, hi in spans:
        if hi > end:
            busy_us += hi - max(lo, end)
            end = hi
    rows = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  key=dev_us, reverse=True)
    print(f"profile {label}: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%) [{card}]")
    for e in rows[:8]:
        print(f"  {dev_us(e) / 1e3:.3f} ms device, {e.count} calls: "
              f"{e.key[:90]}")
    host = sorted((e for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU),
                  key=lambda e: e.self_cpu_time_total, reverse=True)
    for e in host[:6]:
        print(f"  {e.self_cpu_time_total / 1e3:.3f} ms host (self), "
              f"{e.count} calls: {e.key[:90]}")
    return wall_us / 1e3, busy_us / 1e3


def trace_busy(run, by_name=None):
    """(wall s, device busy s, kernels) of one ``run()`` under a
    torch.profiler trace of CUDA activity. Busy time is the union of the
    device-side intervals, read from the raw trace events: for a trace
    of the whole pane-carry tJoin (~670,000 kernels) that is far cheaper
    than building the profiler's event objects. ``by_name``: a dict that
    gathers device ns by activity name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, kernels = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            lo = e.start_ns()
            spans.append((lo, lo + e.duration_ns()))
            kernels += not e.name().startswith(("Memset", "Memcpy"))
            if by_name is not None:
                by_name[e.name()] = by_name.get(e.name(), 0) + \
                    e.duration_ns()
    spans.sort()
    busy_ns, end = 0, -1
    for lo, hi in spans:
        if hi > end:
            busy_ns += hi - max(lo, end)
            end = hi
    return wall, busy_ns / 1e9, kernels


def bound_ms(nbytes: float, nops: float, ops_per_s: float = SCALAR_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# CPU twins in background processes.
#
# In the full run the heaviest CPU twins (the operator under test run on
# the CPU through the plain versions) run in a pool of spawned worker
# processes at the lowest scheduling priority, started before phase 2,
# on host cores of their own: this process gives up one torch thread for
# each worker thread, since torch's threads stall when they share cores.
# A phase hands its comparison with such a twin to ``later``, and the
# comparisons run after phase 36. A twin builds its inputs from the seeds
# the card run uses and returns their digest beside its result; ``twin``
# holds that digest against the card run's own inputs before the windows
# are compared. Without the pool (``--quick``, an ``--*-only`` run, a CPU
# rehearsal) a twin runs in this process and ``later`` runs at once.

TWIN_WORKERS = 2
TWIN_THREADS = 1  # torch's intra-op threads a worker
_twin_pool = None
_twin_futures = {}
_main_threads = None  # this process's torch threads before the pool
_deferred = []
twin_log = {}  # name -> (seconds of its CPU run, seconds waited for it)


_SCALARS = (str, int, float, bool, type(None))


def digest(*objs) -> str:
    """A hash of nested inputs: arrays by dtype, shape and bytes; dicts,
    lists and tuples item by item; dataclasses by their fields."""
    import dataclasses
    import hashlib

    h = hashlib.blake2b(digest_size=16)

    def feed(o):
        if isinstance(o, np.ndarray):
            h.update(f"{o.dtype}{o.shape}".encode())
            h.update(np.ascontiguousarray(o).tobytes())
        elif isinstance(o, dict):
            h.update(b"{")
            for k in sorted(o):
                feed(k)
                feed(o[k])
            h.update(b"}")
        elif isinstance(o, (list, tuple)) and o \
                and dataclasses.is_dataclass(o[0]) \
                and all(type(x) is type(o[0]) for x in o) \
                and all(type(v) in _SCALARS for v in vars(o[0]).values()):
            # A stream of objects of scalars (Points): one repr of their
            # fields, hundreds of thousands of them.
            rows = [tuple(vars(x).values()) for x in o]
            if not all(type(v) in _SCALARS for r in rows for v in r):
                raise TypeError("digest: a field that is not a scalar")
            h.update(type(o[0]).__name__.encode())
            h.update(repr(rows).encode())
        elif isinstance(o, (list, tuple)):
            h.update(b"[")
            for x in o:
                feed(x)
            h.update(b"]")
        elif dataclasses.is_dataclass(o):
            h.update(type(o).__name__.encode())
            feed({f.name: getattr(o, f.name)
                  for f in dataclasses.fields(o)})
        else:
            h.update(repr(o).encode())

    for o in objs:
        feed(o)
    return h.hexdigest()


#: The plain versions' CPU blocks (lanes a block of points: B4's and the
#: containment's) in the twin workers: on one thread a smaller block
#: keeps the temporaries in cache (the polygon ⋈ polygon twin in float64
#: ~1.8× faster than at the default 2^19, and no slower on the other
#: twins), which also spares the main process's memory bandwidth; the
#: result does not depend on the block.
TWIN_PLAIN_LANES = 1 << 17


def _twin_worker_init():
    import torch

    from spatialflink_tpu_torch.ops import polygon, polyline_kernel

    os.nice(19)
    torch.set_num_threads(TWIN_THREADS)
    polyline_kernel.PLAIN_BLOCK_LANES_CPU = TWIN_PLAIN_LANES
    polygon.BLOCK_LANES_CPU = TWIN_PLAIN_LANES


def _twin_job(name):
    return TWINS[name]()


def start_twins():
    """Start the pool, queue every twin in the order the phases ask for
    them, and leave the pool's threads their cores. Returns this
    process's torch threads."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    global _twin_pool, _main_threads
    _twin_pool = ProcessPoolExecutor(
        max_workers=TWIN_WORKERS,
        mp_context=multiprocessing.get_context("spawn"),
        initializer=_twin_worker_init)
    for name in TWINS:
        _twin_futures[name] = _twin_pool.submit(_twin_job, name)
    _main_threads = torch.get_num_threads()
    torch.set_num_threads(max(1, min(
        _main_threads, (os.cpu_count() or 1) - TWIN_WORKERS * TWIN_THREADS)))
    return torch.get_num_threads()


def settle_twins():
    """Give this process its torch threads back once every twin is
    done (called between phases)."""
    import torch

    global _main_threads
    if _main_threads is not None and all(
            f.done() for f in _twin_futures.values()):
        torch.set_num_threads(_main_threads)
        _main_threads = None


def stop_twins():
    """Shut the pool down; workers still busy (a phase failed before it
    asked for their twin) are terminated."""
    import multiprocessing

    global _twin_pool
    if _twin_pool is None:
        return
    busy = [f for f in _twin_futures.values() if not f.done()]
    if busy:
        for p in multiprocessing.active_children():
            p.terminate()
            p.join(10)
    _twin_pool.shutdown(wait=not busy, cancel_futures=True)
    _twin_pool = None
    _twin_futures.clear()


def later(check):
    """Run ``check``, a phase's comparison with its CPU twin: at once
    without the pool, else after phase 36 (``run_later``)."""
    if _twin_pool is None:
        check()
    else:
        _deferred.append(check)


def run_later():
    """The comparisons handed to ``later``, in the order the phases
    handed them."""
    while _deferred:
        _deferred.pop(0)()


def twin(name, *inputs):
    """The CPU twin ``name``'s result on ``inputs``, a tuple with its CPU
    run's seconds second: from the pool, or run here; either way the
    digest of the inputs it built must equal theirs."""
    fut = _twin_futures.pop(name, None)
    t0 = time.perf_counter()
    got_digest, out = TWINS[name]() if fut is None else fut.result()
    waited = time.perf_counter() - t0 if fut is not None else 0.0
    if got_digest != digest(*inputs):
        raise AssertionError(f"CPU twin {name}: its inputs differ from the "
                             f"card run's")
    twin_log[name] = (out[1], waited)
    return out


def check_digest(dev, wf, panes, card):
    """Phase 3: B1 against its plain version, bit-exact."""
    import torch

    from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket
    from spatialflink_tpu_torch.ops.wire_digest_kernel import (
        wire_digest_cuda,
        wire_digest_plain,
        wire_plane_coords,
    )

    nb = wire_pane_bucket(SLIDE)
    q = np.float32(QUERY)
    base = np.concatenate(
        [panes[0], np.zeros((3, nb - SLIDE), np.uint16)], axis=1)
    wire = torch.from_numpy(base).to(dev)
    full = torch.from_numpy(np.concatenate(
        [panes[0], panes[1][:, :nb - SLIDE]], axis=1)).to(dev)
    xf, yf, _ = wire_plane_coords(wire, wf.scale, wf.origin)
    dx, dy = xf - float(q[0]), yf - float(q[1])
    dist = torch.sqrt(dx * dx + dy * dy)[:SLIDE]
    on_radius = np.float32(torch.sort(dist).values[1000].item())
    # 16 lattice points within the radius, each shared by every object.
    spots = wf.quantize([[QUERY[0] + 0.002 * i, QUERY[1]] for i in range(16)])
    ties = np.ascontiguousarray(np.stack([
        np.repeat(spots[:, 0], nb // 16), np.repeat(spots[:, 1], nb // 16),
        (np.arange(nb) % NUM_SEGMENTS).astype(np.uint16)]))
    cases = {
        "headline": (wire, SLIDE, q, RADIUS),
        "on_radius": (wire, SLIDE, q, on_radius),
        "equal_distance": (torch.from_numpy(ties).to(dev), nb, q, RADIUS),
        "n_valid_lt_bucket": (full, SLIDE * 4 // 5, q, RADIUS),
        "zero_hits": (wire, SLIDE, np.float32([100.0, 20.0]), RADIUS),
        "over_16384_hits": (wire, SLIDE, q, 0.5),
    }
    err = 0.0
    for name, (w, n_valid, qq, r) in cases.items():
        (d_k, c_k) = wire_digest_cuda(w, n_valid, qq, wf.scale, wf.origin,
                                      r, NUM_SEGMENTS)
        (d_p, c_p) = wire_digest_plain(w, n_valid, qq, wf.scale, wf.origin,
                                       r, NUM_SEGMENTS)
        torch.cuda.synchronize()
        ok = (same_bits(d_k.seg_min, d_p.seg_min)
              and same_bits(d_k.rep, d_p.rep) and same_bits(c_k, c_p))
        err = max(err, max_abs_err(d_k.seg_min, d_p.seg_min))
        live = int((d_k.seg_min < torch.finfo(torch.float32).max).sum())
        print(f"B1 wire_digest {name}: hits={int(c_k)} live_objects={live} "
              f"bit_exact={ok} [{card}]")
        if not ok:
            raise AssertionError(f"B1 {name}: kernel != plain version")
        if name == "zero_hits" and int(c_k) != 0:
            raise AssertionError("B1 zero_hits case has hits")
        if name == "over_16384_hits" and int(c_k) <= 16_384:
            raise AssertionError("B1 over_16384_hits case has too few hits")
        if name == "on_radius" and int(c_k) < 1001:
            raise AssertionError("B1 on_radius lost the points on the radius")

    # What the one-launch design could get wrong, all calls queued before
    # any is checked: keys or a count left by the call before (the radius
    # up and down, then no hit), the scratch cache (num_segments
    # alternating), and the 2-byte path (n_pad % 8 != 0; a view 2 bytes
    # past a 16-byte boundary).
    odd = full[:, :nb - 3].contiguous()
    flat = torch.empty(3 * nb + 1, dtype=torch.uint16, device=dev)
    shifted = flat[1:].view(3, nb)
    shifted.copy_(wire)
    far = np.float32([100.0, 20.0])
    seq = [(f"repeat r={r}", wire, SLIDE, q, r, NUM_SEGMENTS)
           for r in (0.5, 0.05, 0.5, 0.05, 0.5)]
    seq.append(("repeat zero_hits", wire, SLIDE, far, 0.5, NUM_SEGMENTS))
    seq += [(f"num_segments={s}", wire, SLIDE, q, 0.5, s)
            for s in (NUM_SEGMENTS, 512, NUM_SEGMENTS, 512)]
    seq += [("n_pad%8=5", odd, SLIDE, q, 0.5, NUM_SEGMENTS),
            ("n_pad%8=5 all valid", odd, nb - 3, q, RADIUS, NUM_SEGMENTS),
            ("offset 2 bytes", shifted, SLIDE, q, 0.5, NUM_SEGMENTS)]
    got = [wire_digest_cuda(w, n_valid, qq, wf.scale, wf.origin, r, s)
           for _, w, n_valid, qq, r, s in seq]
    for (name, w, n_valid, qq, r, s), (d_k, c_k) in zip(seq, got):
        d_p, c_p = wire_digest_plain(w, n_valid, qq, wf.scale, wf.origin, r,
                                     s)
        ok = (same_bits(d_k.seg_min, d_p.seg_min)
              and same_bits(d_k.rep, d_p.rep) and same_bits(c_k, c_p))
        err = max(err, max_abs_err(d_k.seg_min, d_p.seg_min))
        print(f"B1 wire_digest {name}: hits={int(c_k)} bit_exact={ok} "
              f"[{card}]")
        if not ok:
            raise AssertionError(f"B1 {name}: kernel != plain version")
        if "zero_hits" in name and int(c_k) != 0:
            raise AssertionError("B1 repeat zero_hits case has hits")
    return err


def check_codec(dev, panes, card):
    """Phase 4: B2 against its plain version, bit-exact."""
    import torch

    from spatialflink_tpu_torch.ops import wire_codec as wc
    from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket

    nb = wire_pane_bucket(SLIDE)
    rng = np.random.default_rng(7)
    words = torch.from_numpy(
        rng.integers(0, 1 << 32, 3 * nb // 2, dtype=np.uint64)
        .astype(np.uint32).view(np.int32)).to(dev)
    px = torch.from_numpy(
        rng.integers(0, 65536, NUM_SEGMENTS).astype(np.uint16)).to(dev)
    py = torch.from_numpy(
        rng.integers(0, 65536, NUM_SEGMENTS).astype(np.uint16)).to(dev)
    err = 0.0

    def one(args, label, n=nb, segments=NUM_SEGMENTS):
        nonlocal err
        got = wc.decode_wire_pane_cuda(*args, n=n, num_segments=segments)
        want = wc.decode_wire_pane_plain(*args, n=n, num_segments=segments)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, max_abs_err(g.to(torch.int32),
                                       w.to(torch.int32)))
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"B2 {label}: kernel != plain version")
        return got

    for b in range(17):
        one((words, SLIDE, b, b, b, px, py), f"width {b}")
        one((words, SLIDE - 1, b, (b + 5) % 17, 14, px, py),
            f"widths {b}/{(b + 5) % 17}/14")
    # What the one-launch design could get wrong: a payload shorter than
    # its streams (every word index clamps to the last word), no valid
    # lane, the 2-byte path (n % 8 != 0), the scratch cache (num_segments
    # alternating).
    for n_words in (1, 7):
        for widths in ((16, 16, 14), (5, 9, 3)):
            one((words[:n_words], SLIDE, *widths, px, py),
                f"{n_words} words, widths {widths}")
    one((words, 0, 7, 9, 14, px, py), "n_valid 0")
    one((words, SLIDE - 1, 7, 9, 14, px, py), "n % 8 == 5", n=nb - 3)
    for segments in (NUM_SEGMENTS, 512, NUM_SEGMENTS, 512):
        one((words, SLIDE, 7, 9, 9, px[:segments], py[:segments]),
            f"num_segments {segments}", segments=segments)
    print(f"B2 wire_codec_decode: payloads of 1 and 7 words, n_valid 0, "
          f"n % 8 != 0, num_segments 16,384/512 alternating bit_exact=True "
          f"[{card}]")
    enc = wc.WirePaneEncoder(NUM_SEGMENTS)
    enc.encode(panes[0])
    tables = [torch.from_numpy(t.copy()).to(dev)
              for t in (enc.pred_x, enc.pred_y)]
    e = enc.encode(panes[1])
    wb = wc.wire_word_bucket(len(e.words), nb)
    coded = torch.from_numpy(
        wc.pad_words(e.words, wb).view(np.int32).copy()).to(dev)
    args = (coded, e.n, e.bx, e.by, e.bo, *tables)
    pane, px2, py2 = one(args, "headline pane")
    if not np.array_equal(pane[:, :SLIDE].cpu().numpy(), panes[1]):
        raise AssertionError("B2 headline pane does not decode to the raw pane")
    # The next pane holds only the lower half of the oids: the upper
    # half's predictors must stay as they were.
    half = NUM_SEGMENTS // 2
    sub = np.ascontiguousarray(panes[2][:, panes[2][2] < half])
    e3 = enc.encode(sub)
    nb3 = wire_pane_bucket(e3.n)
    coded3 = torch.from_numpy(wc.pad_words(
        e3.words, wc.wire_word_bucket(len(e3.words), nb3))
        .view(np.int32).copy()).to(dev)
    pane3, px3, py3 = one((coded3, e3.n, e3.bx, e3.by, e3.bo, px2, py2),
                          "pane with absent oids", n=nb3)
    if not (np.array_equal(pane3[:, :e3.n].cpu().numpy(), sub)
            and torch.equal(px3[half:], px2[half:])
            and torch.equal(py3[half:], py2[half:])
            and np.array_equal(px3.cpu().numpy(), enc.pred_x)
            and np.array_equal(py3.cpu().numpy(), enc.pred_y)):
        raise AssertionError("B2 pane with absent oids: tables differ from "
                             "the encoder's")
    print(f"B2 wire_codec_decode: widths 0..16, a headline pane "
          f"(bx={e.bx} by={e.by} bo={e.bo}, {len(e.words)} words) and a "
          f"pane of {e3.n} points over half the oids bit_exact=True [{card}]")
    return err, args


def run_path(device, mode, panes, wf):
    """One run of the main path; returns (windows, seconds)."""
    import torch

    from spatialflink_tpu_torch import pipeline
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )

    pipeline.uninstall()
    if mode == "pipelined":
        pipeline.install(pipeline.PipelinePolicy(depth=2, fetch_lag=2))
    elif mode == "pipelined_delta":
        pipeline.install(pipeline.PipelinePolicy(depth=2, fetch_lag=2,
                                                 codec="delta"))
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    op = PointPointKNNQuery(conf, UniformGrid(**BEIJING), device=device)
    try:
        t0 = time.perf_counter()
        out = list(op.run_wire_panes(
            panes, Point(x=QUERY[0], y=QUERY[1]), RADIUS, K, NUM_SEGMENTS,
            wf))
        if op.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        pipeline.uninstall()
    kinds = (op.last_wire_digest_kind, op.last_wire_codec_kind)
    return out, secs, kinds


def check_windows(got, want, mode):
    if len(got) != len(want) or not got:
        raise AssertionError(f"{mode}: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if g[0] != w[0] or g[1] != w[1] or g[4] != w[4]:
            raise AssertionError(f"{mode}: window {g[:2]} differs")
        if not np.array_equal(g[2], w[2]):
            raise AssertionError(f"{mode}: ids differ in window {g[:2]}")
        if not np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32)):
            raise AssertionError(f"{mode}: distances differ in {g[:2]}")
        if g[4] != K or not np.all(np.isfinite(g[3])) \
                or not np.all(np.diff(g[3]) >= 0) \
                or not np.all(g[3] <= np.float32(RADIUS)):
            raise AssertionError(f"{mode}: window {g[:2]} malformed")


def join_stream(n, seed):
    """Positions of bench_suite.py:47-54's stream (float32, as there)."""
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)], axis=1
    ).astype(np.float32)


def expected_pairs(n, radius):
    """Pairs two uniform n-point sides of the join extent hold within
    ``radius`` (edge effects aside): n² · πr² / area."""
    return n * n * np.pi * radius ** 2 / ((117.6 - 115.5) * (41.1 - 39.6))


def join_side(grid, xy, valid=None, centered=False):
    """Host lanes (centred float32 xy, valid, cell) of one join side.
    ``centered``: ``xy`` is already the centred float32 input (cells
    come from it plus the grid centre, in float64)."""
    from spatialflink_tpu_torch.operators.base import center_coords

    center = np.array([(grid.min_x + grid.max_x) / 2.0,
                       (grid.min_y + grid.max_y) / 2.0])
    if centered:
        xy_c = np.asarray(xy, np.float32)
        xy64 = xy_c.astype(np.float64) + center
    else:
        xy64 = np.asarray(xy, np.float64)
        xy_c = center_coords(grid, xy64)
    n = len(xy64)
    return (xy_c, np.ones(n, bool) if valid is None else valid,
            grid.assign_cells_np(xy64))


def b3_compare(planes, grid_n, layers, radius, max_pairs, card, label,
               over=0):
    """B3 against its plain version on given planes, bit for bit.
    Returns (kernel result, max_abs_err)."""
    import torch

    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
    )

    got = join_extract_cuda(*planes, grid_n, layers, radius, max_pairs)
    want = join_extract_plain(*planes, grid_n, layers, radius, max_pairs)
    torch.cuda.synchronize()
    ok = all(same_bits(g, w) for g, w in zip(got, want))
    print(f"B3 join_extract {label}: layers={layers} count={int(got[3])} "
          f"budget={len(got[0])} overflow={int(over)} bit_exact={ok} "
          f"[{card}]")
    if not ok:
        raise AssertionError(f"B3 {label}: kernel != plain version")
    return got, max_abs_err(got[2], want[2])


def join_case(dev, grid, left, right, radius, max_pairs, card, label,
              cap=JOIN_CAP, layers=None):
    """B3 against its plain version on one pair of sides: planes built on
    the card once, both extractions on them, compared bit for bit.
    Returns (kernel result, planes, overflow, max_abs_err)."""
    import torch

    from spatialflink_tpu_torch.ops.join_kernel import join_planes

    if layers is None:
        layers = grid.candidate_layers(radius)
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for a in (*left, *right)]
    planes, over = join_planes(*lanes, grid_n=grid.n, layers=layers,
                               cap_left=cap, cap_right=cap)
    got, err = b3_compare(planes, grid.n, layers, radius, max_pairs, card,
                          label, int(over))
    return got, planes, int(over), err


def holed_planes(planes, seed):
    """The planes with each side's bucket slots permuted (one permutation
    a side) and a quarter of the slots emptied at random, so that live
    slots no longer form a prefix of their bucket."""
    import torch

    rng = np.random.default_rng(seed)
    out = []
    for side in (planes[:3], planes[3:]):
        cap = side[0].shape[-1]
        perm = torch.from_numpy(rng.permutation(cap)).to(side[0].device)
        x, y, idx = (t[..., perm].contiguous() for t in side)
        holes = torch.from_numpy(rng.random(tuple(idx.shape)) < 0.25)
        idx[holes.to(idx.device)] = -1
        out += [x, y, idx]
    return tuple(out)


def cluster_at(grid, cell_ij, n, rng):
    """``n`` points spread over the middle of grid cell (i, j)."""
    c = np.array([grid.min_x, grid.min_y]) + \
        (np.asarray(cell_ij, np.float64) + 0.5) * grid.cell_length
    return (c + rng.uniform(-0.3, 0.3, (n, 2)) * grid.cell_length).astype(
        np.float32)


def check_join(dev, card):
    """Phase 7: B3 against its plain version at the join's full shape."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid

    grid = UniformGrid(**BEIJING)
    a, b = join_stream(JOIN_WIN, 1), join_stream(JOIN_WIN, 2)
    left, right = join_side(grid, a), join_side(grid, b)
    err = 0.0

    head, planes, over, e = join_case(dev, grid, left, right, JOIN_R,
                                      JOIN_MAX_PAIRS, card, "headline")
    err = max(err, e)
    count = int(head[3])
    if over != 0 or not (0.8 * expected_pairs(JOIN_WIN, JOIN_R) < count
                         <= JOIN_MAX_PAIRS):
        raise AssertionError(f"B3 headline: count {count}, overflow {over}")

    # Points exactly on the radius: centred left points on the 2^-23
    # lattice and right points at +(delta, 0), so that d2 == r2 in float32
    # with r = delta (lattice differences below 2 are exact).
    k = 20_000
    delta = np.float32(round(JOIN_R * 2**23) / 2**23)
    lq = np.round(left[0].astype(np.float64) * 2**23) / 2**23
    lq = lq.astype(np.float32)
    rq = right[0].copy()
    rq[:k] = lq[:k] + np.array([delta, 0], np.float32)
    got, _, _, e = join_case(
        dev, grid, join_side(grid, lq, centered=True),
        join_side(grid, rq, centered=True), float(delta), JOIN_MAX_PAIRS,
        card, "on_radius")
    err = max(err, e)
    n = int(got[3])
    li, ri, dd = (t[:n].cpu().numpy() for t in got[:3])
    on = (li == ri) & (li < k)
    in_grid = ((join_side(grid, lq, centered=True)[2][:k] < grid.num_cells)
               & (join_side(grid, rq, centered=True)[2][:k]
                  < grid.num_cells))
    if on.sum() != in_grid.sum() or not np.all(dd[on] == delta):
        raise AssertionError("B3 on_radius lost points exactly on the radius")

    under = min(1024, count // 2)
    for budget in (under, count - under):
        got, _, _, e = join_case(dev, grid, left, right, JOIN_R, budget,
                                 card, f"over_budget_{budget}")
        err = max(err, e)
        m = len(got[0])
        if int(got[3]) != count or not all(
                same_bits(g[:m], h[:m]) for g, h in zip(got[:3], head[:3])):
            raise AssertionError("B3 over budget: not the first pairs")

    clustered = a.copy()
    clustered[:5000] = np.float32([116.40, 40.19])  # one cell, 5,000 points
    _, _, over, e = join_case(dev, grid, join_side(grid, clustered), right,
                              JOIN_R, JOIN_MAX_PAIRS, card, "clustered")
    err = max(err, e)
    if over < 5000 - JOIN_CAP:
        raise AssertionError(f"B3 clustered: overflow {over}")

    got, _, _, e = join_case(dev, grid, left, right, 0.03, JOIN_MAX_PAIRS,
                             card, "two_layers_over_budget")
    err = max(err, e)
    need = int(2 ** np.ceil(np.log2(int(got[3]))))
    got, _, _, e = join_case(dev, grid, left, right, 0.03, need, card,
                             "two_layers")
    err = max(err, e)

    none = np.zeros(JOIN_WIN, bool)
    got, _, _, e = join_case(dev, grid, left, join_side(grid, b, none),
                             JOIN_R, JOIN_MAX_PAIRS, card, "empty_side")
    if int(got[3]) != 0:
        raise AssertionError("B3 empty side has pairs")

    outside = a.copy()
    outside[::10, 0] += 3.0  # a tenth of the left side east of the grid
    got, _, _, e = join_case(dev, grid, join_side(grid, outside), right,
                             JOIN_R, JOIN_MAX_PAIRS, card, "out_of_grid")
    err = max(err, e)
    n = int(got[3])
    if not 0 < n < count or np.any(got[0][:n].cpu().numpy() % 10 == 0):
        raise AssertionError("B3 out_of_grid: an out-of-grid point joined")

    # The cases the one-pass design could get wrong. Live slots that are
    # not a prefix of their bucket:
    holed = holed_planes(planes, 11)
    got, e = b3_compare(holed, grid.n, 1, JOIN_R, JOIN_MAX_PAIRS, card,
                        "holes_not_prefix")
    err = max(err, e)
    if not 0 < int(got[3]) < count:
        raise AssertionError("B3 holes_not_prefix: no pairs, or no hole")

    # A saturated cell: 48 left slots x 432 live right candidates, all
    # pairs within r = +inf (approximate mode), in one cell.
    rng = np.random.default_rng(12)
    ci = grid.cell_indices(*QUERY)
    sat_l = a.copy()
    sat_l[:JOIN_CAP] = cluster_at(grid, ci, JOIN_CAP, rng)
    sat_r = b.copy()
    for k, (dx, dy) in enumerate((dx, dy) for dx in (-1, 0, 1)
                                 for dy in (-1, 0, 1)):
        sat_r[k * 60:(k + 1) * 60] = cluster_at(
            grid, (ci[0] + dx, ci[1] + dy), 60, rng)
    only = np.zeros(JOIN_WIN, bool)
    only[:JOIN_CAP] = True
    got, _, _, e = join_case(dev, grid, join_side(grid, sat_l, only),
                             join_side(grid, sat_r), float("inf"),
                             JOIN_MAX_PAIRS, card, "saturated_cell_r_inf",
                             layers=1)
    err = max(err, e)
    if int(got[3]) != JOIN_CAP * 9 * JOIN_CAP:
        raise AssertionError(f"B3 saturated cell: count {int(got[3])}")

    # Budgets that cut inside a cell and exactly at a cell's end (budgets
    # are whole 128-slot rows), and a zero budget.
    cell_of = left[2][head[0][:count].cpu().numpy()]
    rows = np.arange(128, count, 128)
    ends = rows[cell_of[rows - 1] != cell_of[rows]]
    inside = rows[cell_of[rows - 1] == cell_of[rows]]
    if not len(ends) or not len(inside):
        raise AssertionError("B3: no 128-slot row at (or inside) a cell end")
    for budget, label in ((int(inside[0]), "budget_inside_a_cell"),
                          (int(ends[0]), "budget_at_a_cell_end"),
                          (0, "budget_zero")):
        got, e = b3_compare(planes, grid.n, 1, JOIN_R, budget, card,
                            f"{label}_{budget}")
        err = max(err, e)
        if int(got[3]) != count or len(got[0]) != budget or not all(
                same_bits(g, h[:budget]) for g, h in zip(got[:3], head[:3])):
            raise AssertionError(f"B3 {label}: not the first pairs")

    # A grid whose cell count (101² = 10,201) is no multiple of the cells
    # a block takes.
    g101 = UniformGrid(**dict(BEIJING, num_partitions=101))
    got, _, _, e = join_case(dev, g101, join_side(g101, a),
                             join_side(g101, b), JOIN_R, JOIN_MAX_PAIRS,
                             card, "grid_101")
    err = max(err, e)
    if not 0.8 * expected_pairs(JOIN_WIN, JOIN_R) < int(got[3]):
        raise AssertionError("B3 grid_101: too few pairs")

    # Five calls in a row on the same planes: the scan's status words and
    # ticket start afresh each call.
    from spatialflink_tpu_torch.ops.join_kernel import join_extract_cuda

    runs = [join_extract_cuda(*planes, grid.n, 1, JOIN_R, JOIN_MAX_PAIRS)
            for _ in range(5)]
    torch.cuda.synchronize()
    if not all(same_bits(g, h) for r in runs for g, h in zip(r, head)):
        raise AssertionError("B3: repeated calls differ")
    print(f"B3 join_extract five_repeats: 5 calls array-equal to the "
          f"headline [{card}]")
    torch.cuda.synchronize()
    return err, planes, (left, right)


def join_candidate_pairs(grid, left, right, cap=JOIN_CAP):
    """Pair tests the headline's data needs: for each cell, its left
    points (at most ``cap``) times the right points (at most ``cap`` a
    cell) of its 3 × 3 neighbourhood."""
    n = grid.n

    def occupancy(cells):
        c = np.bincount(cells, minlength=grid.num_cells + 1)[:grid.num_cells]
        return np.minimum(c, cap).reshape(n, n).astype(np.int64)

    cl, cr = occupancy(left[2]), occupancy(right[2])
    crp = np.pad(cr, 1)
    nb = sum(crp[1 + dx:1 + dx + n, 1 + dy:1 + dy + n]
             for dx in (-1, 0, 1) for dy in (-1, 0, 1))
    return int((cl * nb).sum())


def soa_join_chunks(seed):
    """One run_soa input stream: 16 × 131,072 points, ts = i·1000 //
    131,072 ms, one chunk per window."""
    xy = join_stream(JOIN_WIN * JOIN_WINDOWS, seed)
    ts = (np.arange(JOIN_WIN * JOIN_WINDOWS, dtype=np.int64) * 1000) \
        // JOIN_WIN
    return [{"ts": ts[s:s + JOIN_WIN], "x": xy[s:s + JOIN_WIN, 0],
             "y": xy[s:s + JOIN_WIN, 1]}
            for s in range(0, JOIN_WIN * JOIN_WINDOWS, JOIN_WIN)]


def run_soa_path(device, chunks):
    """One run_soa at full width; returns (windows, seconds)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PointPointJoinQuery(conf, UniformGrid(**BEIJING), cap=JOIN_CAP,
                             device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks[0], chunks[1], JOIN_R,
                          max_pairs=JOIN_MAX_PAIRS))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_soa_join(got, want):
    import torch

    if len(got) != len(want) or len(got) != JOIN_WINDOWS:
        raise AssertionError(f"run_soa: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if g[0] != w[0] or g[1] != w[1] or g[5] != w[5] or g[6] != w[6]:
            raise AssertionError(f"run_soa: window {g[:2]} differs")
        if not all(same_bits(torch.from_numpy(x), torch.from_numpy(y))
                   for x, y in zip(g[2:5], w[2:5])):
            raise AssertionError(f"run_soa: arrays differ in {g[:2]}")
        n = g[5]
        if not (0.8 * expected_pairs(JOIN_WIN, JOIN_R) < n <= len(g[2])
                and g[6] == 0
                and np.all(g[2][:n] >= 0) and np.all(g[4][:n] <= JOIN_R)):
            raise AssertionError(f"run_soa: window {g[:2]} malformed")


def join_objects():
    """Point streams of the object path: JOIN_OBJ_WINDOWS seconds of
    JOIN_OBJ_POINTS points a second per side."""
    from spatialflink_tpu_torch.models.objects import Point

    n = JOIN_OBJ_POINTS * JOIN_OBJ_WINDOWS
    out = []
    for side, seed in (("l", 3), ("r", 4)):
        xy = join_stream(n, seed).astype(np.float64)
        ts = (np.arange(n, dtype=np.int64) * 1000) // JOIN_OBJ_POINTS
        out.append([Point(obj_id=f"{side}{i}", timestamp=int(t),
                          x=float(x), y=float(y))
                    for i, (t, (x, y)) in enumerate(zip(ts, xy))])
    return out


def run_objects(device, query_type, streams):
    """One ``run`` over Point objects; returns the pair multiset with
    distance bits, the windows' (start, end, overflow, count) and
    seconds."""
    import collections

    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        QueryConfiguration,
        QueryType,
    )

    conf = QueryConfiguration(query_type=QueryType[query_type],
                              window_size=1.0, slide_step=1.0,
                              realtime_batch_ms=100)
    op = PointPointJoinQuery(conf, UniformGrid(**BEIJING), cap=JOIN_CAP,
                             device=device)
    t0 = time.perf_counter()
    res = list(op.run(streams[0], streams[1], JOIN_R))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    pairs = collections.Counter(
        (p.obj_id, p.timestamp, q.obj_id, q.timestamp,
         int(np.float32(d).view(np.uint32)))
        for r in res for p, q, d in r.pairs)
    wins = [(r.start, r.end, r.overflow, r.window_count) for r in res]
    return pairs, wins, secs


def range_polygons():
    """Suite config 3's query set: 1,000 polygons from seed 3."""
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    return generate_query_polygons(RANGE_POLYS, 115.5, 39.6, 117.6, 41.1,
                                   grid_size=100, seed=3)


def packed_queries(grid, queries):
    """(centred float32 vertices, edge flags) of a query set, as the
    operators pack and ship it."""
    from spatialflink_tpu_torch.operators.base import (
        center_coords,
        pack_query_geometries,
    )

    verts, ev = pack_query_geometries(queries)
    return center_coords(grid, verts), ev


def range_chunks(n_win, per_win, seed):
    """A run_soa stream: bench_suite.py:47-54's positions from ``seed``,
    one-second tumbling windows (ts = i·1000 // per_win ms), one chunk a
    window."""
    xy = join_stream(n_win * per_win, seed)
    ts = (np.arange(n_win * per_win, dtype=np.int64) * 1000) // per_win
    return [{"ts": ts[s:s + per_win], "x": xy[s:s + per_win, 0],
             "y": xy[s:s + per_win, 1]}
            for s in range(0, n_win * per_win, per_win)]


def b4_case(dev, xy, verts, ev, sel, card, label):
    """B4 against its plain version on one input set, bit for bit.
    Returns (kernel output, max_abs_err)."""
    import torch

    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    def dev_t(a):
        if torch.is_tensor(a):
            return a.to(dev)
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    args = (dev_t(xy), dev_t(verts), dev_t(ev),
            None if sel is None else dev_t(sel))
    got = polyline_min_dist_cuda(*args)
    want = polyline_min_dist_plain(*args)
    torch.cuda.synchronize()
    ok = same_bits(got, want)
    err = max_abs_err(got, want)
    n, c = got.shape
    print(f"B4 polyline_min_dist {label}: N={n} C={c} "
          f"G={args[1].shape[0]} V={args[1].shape[1]} "
          f"mode={'dense' if sel is None else 'gathered'} bit_exact={ok} "
          f"[{card}]")
    if not ok:
        raise AssertionError(f"B4 {label}: kernel != plain version")
    return got, err


def check_polyline(dev, card):
    """Phase 11: B4 against its plain version. Returns (max_abs_err, the
    config-3 window's device lanes and candidates for phase 13)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.base import center_coords
    from spatialflink_tpu_torch.ops.polygon import pack_rings
    from spatialflink_tpu_torch.ops.range import bbox_candidates

    grid = UniformGrid(**BEIJING)
    polys = range_polygons()
    qv, qe = packed_queries(grid, polys)
    xy64 = join_stream(RANGE_WIN, 7).astype(np.float64)
    xy = center_coords(grid, xy64)
    err = 0.0

    _, e = b4_case(dev, xy, qv, qe, None, card, "config3_dense")
    err = max(err, e)
    xy_d = torch.from_numpy(xy).to(dev)
    qv_d, qe_d = (torch.from_numpy(a).to(dev) for a in (qv, qe))
    lanes = torch.ones(RANGE_WIN, dtype=torch.bool, device=dev)
    sel, _ = bbox_candidates(xy_d, lanes, qv_d, qe_d, RANGE_R, 8, 8192)
    _, e = b4_case(dev, xy_d, qv_d, qe_d, sel, card, "config3_gathered")
    err = max(err, e)
    n_odd = RANGE_WIN - 77
    _, e = b4_case(dev, xy[:n_odd], qv, qe, sel[:n_odd], card,
                   "n_not_multiple_of_block")
    err = max(err, e)
    # The cases the redesign could get wrong: G not a multiple of the 32
    # boundaries a dense block takes (config3_dense is G = 1,000), C not a
    # multiple of the 4-slot vectors, and invalid edges between valid ones.
    _, e = b4_case(dev, xy, qv[:33], qe[:33], None, card, "dense_g33")
    err = max(err, e)
    _, e = b4_case(dev, xy_d, qv_d, qe_d, sel[:, :3].contiguous(), card,
                   "gathered_c3")
    err = max(err, e)
    gaps = qe.copy()
    gaps[::2, 1] = False  # edges 0, 2, 3 valid
    gaps[1::3, 2] = False  # edges 0, 1, 3 (or 0, 3) valid
    if not (gaps[:, 0] & ~gaps[:, 1] & gaps[:, 2]).any():
        raise AssertionError("B4 gaps case has no invalid edge between "
                             "valid ones")
    _, e = b4_case(dev, xy, qv, gaps, None, card, "dense_invalid_mid_edges")
    err = max(err, e)
    _, e = b4_case(dev, xy_d, qv_d, torch.from_numpy(gaps).to(dev), sel, card,
                   "gathered_invalid_mid_edges")
    err = max(err, e)

    # Boundaries on the 2^-20 lattice (centred, so exact in float32):
    # vertices and edge midpoints lie on the boundary (d = 0), and points
    # at -delta along a horizontal edge from its first vertex are at
    # d^2 == delta^2 == r^2 exactly (delta = 2^-9, about RANGE_R).
    lat = np.round(qv[:64] * 2**20) / 2**20
    lat = lat.astype(np.float32)
    delta = np.float32(2.0 ** -9)
    first = lat[:, 0]
    on_edge = np.concatenate([
        lat[:, :4].reshape(-1, 2),
        ((lat[:, :4] + lat[:, 1:5]) / 2).reshape(-1, 2),
        first - np.array([delta, 0], np.float32)])
    got, e = b4_case(dev, on_edge, lat, qe[:64], None, card,
                     "on_edge_and_on_radius")
    err = max(err, e)
    m = 64 * 4
    own = torch.arange(64, device=dev)
    if not (torch.all(got[:2 * m].min(dim=1).values == 0)
            and torch.all(got[2 * m + own, own] == delta)):
        raise AssertionError("B4 on-edge / on-radius points off their "
                             "exact distances")

    rng = np.random.default_rng(31)
    ring = rng.uniform(-0.5, 0.5, (40, 2)).astype(np.float32)
    ring[5] = ring[4]
    ring[17:20] = ring[16]  # zero-length edges
    rings = [ring, rng.uniform(-0.2, 0.2, (9, 2)),
             rng.uniform(0.3, 0.6, (7, 2))]  # multi-ring seams
    v, e_ = pack_rings(rings, pad_to=64)
    pts = rng.uniform(-0.7, 0.7, (50_001, 2)).astype(np.float32)
    pts[:40] = ring
    _, e = b4_case(dev, pts, v[None].astype(np.float32), e_[None], None,
                   card, "degenerate_edges_and_seams")
    err = max(err, e)

    # Eight boundaries of 4,096 vertices (a noisy circle each, the last
    # with no valid edge): dense mode tiles them through shared memory,
    # and the set (295 KB) is too large to stage for the gathered mode.
    t = np.linspace(0, 2 * np.pi, 4096)
    big = np.stack([np.stack([0.4 * np.cos(t + k), 0.3 * np.sin(t + k)],
                             axis=1) + rng.normal(0, 1e-3, (4096, 2))
                    for k in range(8)]).astype(np.float32)
    big_ev = np.ones((8, 4095), bool)
    big_ev[7] = False
    pts = rng.uniform(-0.6, 0.6, (20_000, 2)).astype(np.float32)
    got, e = b4_case(dev, pts, big, big_ev, None, card, "v4096_dense")
    err = max(err, e)
    if not torch.all(got[:, 7] == torch.finfo(torch.float32).max):
        raise AssertionError("B4 all-invalid boundary is not FLT_MAX")
    sel_big = rng.integers(0, 8, (20_000, 3)).astype(np.int32)
    _, e = b4_case(dev, pts, big, big_ev, sel_big, card,
                   "v4096_gathered_unstaged")
    err = max(err, e)
    return err, (xy_d, qv_d, qe_d, sel)


def run_range(device, cls, chunks, queries, radius, **conf_kw):
    """One ``run_soa`` of a range operator; returns (windows, seconds,
    operator)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0, **conf_kw)
    op = cls(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks, queries, radius))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, op


def check_range_windows(got, want, label, radius, exact=True):
    """Window for window: starts, ends, matched arrays exact, distance
    bits equal; matches finite and, in exact mode, within the radius.
    Returns the matches per window."""
    if len(got) < len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if g[:2] != w[:2] or g[2].keys() != w[2].keys():
            raise AssertionError(f"{label}: window {g[:2]} differs")
        if not all(np.array_equal(g[2][k], w[2][k]) for k in g[2]):
            raise AssertionError(f"{label}: matches differ in {g[:2]}")
        if not np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32)):
            raise AssertionError(f"{label}: distances differ in {g[:2]}")
        if not np.all(np.isfinite(g[3])) or (
                exact and not np.all(g[3] <= np.float32(radius))):
            raise AssertionError(f"{label}: window {g[:2]} malformed")
    return [len(g[3]) for g in got]


def range_objects(n_windows, per_win, seed):
    """``Point`` objects of ``n_windows`` seconds of ``per_win`` points."""
    from spatialflink_tpu_torch.models.objects import Point

    xy = join_stream(n_windows * per_win, seed).astype(np.float64)
    ts = (np.arange(len(xy), dtype=np.int64) * 1000) // per_win
    return [Point(obj_id=f"p{i}", timestamp=int(t), x=float(x), y=float(y))
            for i, (t, (x, y)) in enumerate(zip(ts, xy))]


def run_range_objects(device, stream, queries):
    """One ``PointPolygonRangeQuery.run`` over Point objects; returns the
    windows as (start, end, window_count, ids, distance bits), seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPolygonRangeQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PointPolygonRangeQuery(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    res = list(op.run(iter(stream), queries, RANGE_R))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [(r.start, r.end, r.window_count,
             [o.obj_id for o in r.objects],
             np.asarray(r.dists, np.float32).view(np.uint32).tolist())
            for r in res], secs


def check_range(dev, card, b4_inputs, gpu="cuda"):
    """Phases 12 and 13: the range family's main path, run_soa at full
    width, then its other paths at a cut depth, each against its CPU
    twin; B4's times and the range window's parts. ``gpu`` is the device
    of the runs under test (``cpu`` only to rehearse the script's logic
    without a card). Returns (B4 launches, the gathered timing row)."""
    import torch

    # Phase 12: the range family's main path, run_soa at full width, then
    # its other paths at a cut depth, each against its CPU twin.
    from spatialflink_tpu_torch.models.objects import LineString, Point
    from spatialflink_tpu_torch.operators import (
        PointLineStringRangeQuery,
        PointPointRangeQuery,
        PointPolygonRangeQuery,
    )
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist,
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    t0 = time.perf_counter()
    polys = range_polygons()
    r_chunks = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)
    print(f"data: {RANGE_WINDOWS} x {RANGE_WIN} range points and "
          f"{len(polys)} query polygons in {time.perf_counter() - t0:.3f} s "
          f"(host set-up)")
    n_range = RANGE_WINDOWS * RANGE_WIN
    polyline_min_dist.launches = 0
    got, r_secs, op = run_range(gpu, PointPolygonRangeQuery, r_chunks,
                                polys, RANGE_R)
    b4_launches = polyline_min_dist.launches
    path = ("compact" if hasattr(op, "_cand_budget") else "pruned")
    # A depth cut: the CPU twin runs the first RANGE_CPU_WINDOWS windows
    # (its plain bbox pass is ~6 s a window on the host).
    hits = [len(g[3]) for g in got]
    if b4_launches < RANGE_WINDOWS or len(got) != RANGE_WINDOWS \
            or path != "pruned" or min(hits) == 0:
        raise AssertionError(f"range run_soa: {len(got)} windows, path "
                             f"{path}, {b4_launches} B4 launches")
    print(f"e2e range run_soa (config 3, {path} path, cand {op._ncand}): "
          f"{len(got)} windows, matches per window {hits}, {n_range} points "
          f"in {r_secs:.6f} s = {n_range / r_secs:.1f} points/s; launches "
          f"polyline_min_dist={b4_launches}; the first {RANGE_CPU_WINDOWS} "
          f"windows held against the CPU plain run [{card}]")

    def held(got=got, cut=r_chunks[:RANGE_CPU_WINDOWS], polys=polys,
             ncand=op._ncand):
        want, cpu_secs, cpu_ncand = twin("range", cut, polys)
        check_range_windows(got, want, "range run_soa", RANGE_R)
        if ncand != cpu_ncand:
            raise AssertionError("range run_soa: candidate counts differ")
        print(f"exact range run_soa: the first {len(want)} windows equal "
              f"the CPU plain run ({cpu_secs:.3f} s on the host CPU) "
              f"[{card}]")
    later(held)

    lines = [LineString(obj_id=f"line{i}", coords=p.rings[0][:4])
             for i, p in enumerate(polys[:32])]
    cut = r_chunks[:RANGE_CUT_WINDOWS]
    cases = [
        ("dense, 32 polygons", PointPolygonRangeQuery, cut, polys[:32],
         RANGE_R, {}),
        ("compact, 64 polygons", PointPolygonRangeQuery, cut, polys[:64],
         RANGE_R, {}),
        ("linestrings, 32", PointLineStringRangeQuery, cut, lines, RANGE_R,
         {}),
        ("approximate, 64 polygons", PointPolygonRangeQuery, cut, polys[:64],
         RANGE_R, {"approximate_query": True}),
        ("points, config 1", PointPointRangeQuery,
         range_chunks(RANGE_CUT_WINDOWS, PP_WIN, 42),
         [Point(x=QUERY[0], y=QUERY[1])], PP_R, {}),
    ]
    for label, cls, ch, qs, r, kw in cases:
        polyline_min_dist.launches = 0
        g, g_secs, g_op = run_range(gpu, cls, ch, qs, r, **kw)
        launched = polyline_min_dist.launches
        b4_launches += launched
        w, w_secs, _ = run_range("cpu", cls, ch, qs, r, **kw)
        h = check_range_windows(g, w, label, r,
                                exact=not kw.get("approximate_query"))
        if len(g) != len(ch) or sum(h) == 0:
            raise AssertionError(f"range {label}: {len(g)} windows, {h}")
        if cls is not PointPointRangeQuery and launched < len(ch):
            raise AssertionError(f"range {label}: {launched} B4 launches")
        if label.startswith("compact") and not hasattr(g_op, "_cand_budget"):
            raise AssertionError("range compact case took another path")
        print(f"e2e range run_soa {label}: {len(g)} windows, matches "
              f"{h}, {sum(len(c['ts']) for c in ch)} points in "
              f"{g_secs:.6f} s; launches polyline_min_dist={launched}; "
              f"equal to the CPU run ({w_secs:.3f} s) [{card}]")

    stream = range_objects(RANGE_OBJ_WINDOWS, RANGE_OBJ_POINTS, 9)
    polyline_min_dist.launches = 0
    g, o_secs = run_range_objects(gpu, stream, polys)
    launched = polyline_min_dist.launches
    b4_launches += launched
    w, c_secs = run_range_objects("cpu", stream, polys)
    if g != w or len(g) != RANGE_OBJ_WINDOWS or launched < len(g) \
            or not any(x[3] for x in g):
        raise AssertionError("range run on Point objects differs from the "
                             "CPU run")
    print(f"e2e range run (Point objects, 1,000 polygons): {len(g)} windows, "
          f"matches {[len(x[3]) for x in g]} in {o_secs:.6f} s; launches "
          f"polyline_min_dist={launched}; equal to the CPU run "
          f"({c_secs:.3f} s) [{card}]")

    # Phase 13: B4's time, the range window's parts, a profiler pass.
    xy_d, qv_d, qe_d, sel = b4_inputs
    n_valid_edges = qe_d.sum(dim=1)
    b4g = (xy_d, qv_d, qe_d, sel)
    b4g_ms, b4g_call = time_ms(lambda: polyline_min_dist_cuda(*b4g))
    b4g_plain, _ = time_ms(lambda: polyline_min_dist_plain(*b4g))
    g_bytes = (8 * RANGE_WIN + 8 * sel.numel() + qv_d.numel() * 4
               + qe_d.numel())
    g_ops = 20 * int(n_valid_edges[sel.long()].sum())
    b4g_bound, b4g_by = bound_ms(g_bytes, g_ops)
    b4d = (xy_d, qv_d[:32].contiguous(), qe_d[:32].contiguous(), None)
    b4d_ms, b4d_call = time_ms(lambda: polyline_min_dist_cuda(*b4d))
    b4d_plain, _ = time_ms(lambda: polyline_min_dist_plain(*b4d))
    d_bytes = 8 * RANGE_WIN + 4 * RANGE_WIN * 32 + b4d[1].numel() * 4 \
        + b4d[2].numel()
    b4d_bound, b4d_by = bound_ms(
        d_bytes, 20 * RANGE_WIN * int(n_valid_edges[:32].sum()))
    for label, args, ms, call, plain, bnd, by_, nb, no in (
            ("gathered (config 3, N=262,144, C=8)", b4g, b4g_ms, b4g_call,
             b4g_plain, b4g_bound, b4g_by, g_bytes, g_ops),
            ("dense (32 polygons, N=262,144)", b4d, b4d_ms, b4d_call,
             b4d_plain, b4d_bound, b4d_by, d_bytes,
             20 * RANGE_WIN * int(n_valid_edges[:32].sum()))):
        kern, mems = launches_per_call(
            lambda: polyline_min_dist_cuda(*args))
        print(f"time polyline_min_dist {label}: kernel {ms:.6f} ms device "
              f"({call:.6f} ms per call with its launch), {kern:g} kernel "
              f"launches and {mems:g} memsets per call, plain PyTorch "
              f"{plain:.6f} ms, bound {bnd:.6f} ms ({by_}: {nb} B, {no} "
              f"operations), library none, medians of {REPEATS} calls "
              f"[{card}]")

    from spatialflink_tpu_torch.ops.polygon import points_in_polygons
    from spatialflink_tpu_torch.ops.range import bbox_candidates

    lanes = torch.ones(RANGE_WIN, dtype=torch.bool, device=dev)
    bbox_ms, _ = time_ms(lambda: bbox_candidates(
        xy_d, lanes, qv_d, qe_d, RANGE_R, 8, 8192))
    pip_ms, _ = time_ms(lambda: points_in_polygons(xy_d, qv_d, qe_d, sel))
    print(f"range window parts (config 3, one window, device ms, medians "
          f"of {REPEATS}): bbox pass + top-8 {bbox_ms:.6f}, B4 gathered "
          f"{b4g_ms:.6f}, containment gathered {pip_ms:.6f}; the window's "
          f"wall in run_soa {1e3 * r_secs / RANGE_WINDOWS:.6f} ms [{card}]")
    profile_run(lambda: run_range(gpu, PointPolygonRangeQuery, r_chunks,
                                  polys, RANGE_R), card, "range run_soa")

    return b4_launches, (b4g_ms, b4g_plain, b4g_bound, b4g_by)


# ---------------------------------------------------------------------------
# Phases 14-16: the geometry-stream range path and the point-stream kNN run.


def geometry_rings(n, seed):
    """``n`` closed rings of 4-11 distinct vertices (lengths 5-12) about
    uniform centres over the Beijing extent, at radii up to 0.01 deg:
    (rings (n, 12, 2) float64, closed at lane m, distinct counts m)."""
    rng = np.random.default_rng(seed)
    m = rng.integers(4, 12, n)
    centre = np.stack([rng.uniform(115.5, 117.6, n),
                       rng.uniform(39.6, 41.1, n)], axis=1)
    lanes = np.arange(11)
    ang = np.sort(np.where(lanes < m[:, None],
                           rng.uniform(0, 2 * np.pi, (n, 11)), np.inf),
                  axis=1)
    ang = np.where(np.isfinite(ang), ang, 0.0)
    rad = rng.uniform(0.3, 1.0, (n, 11)) * 0.01
    ring = centre[:, None] + rad[..., None] * np.stack(
        [np.cos(ang), np.sin(ang)], axis=-1)
    closed = np.concatenate([ring, np.zeros((n, 1, 2))], axis=1)
    closed[np.arange(n), m] = ring[:, 0]
    return closed, m


def geometry_chunks(n_win, per_win, seed=11, polygonal=True, holes=False):
    """A ragged ``run_soa`` stream: one chunk a one-second tumbling window
    (ts = i·1000 // per_win ms), oids over ``GEOM_OBJECTS``; polygons as
    closed rings, linestrings as the same rings opened. ``holes``: every
    polygon gets a hole (the ring shrunk to 0.3 about its first vertex's
    centre), the two rings packed with a seam, and the chunks carry the
    edge masks."""
    n = n_win * per_win
    rings, m = geometry_rings(n, seed)
    oid = np.random.default_rng(seed + 1).integers(
        0, GEOM_OBJECTS, n).astype(np.int32)
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_win
    lengths = m + 1 if polygonal else m
    lanes = np.arange(rings.shape[1])
    verts = rings[lanes[None, :] < lengths[:, None]]
    edges = None
    if holes:
        c = np.stack([rings[i, :m[i]].mean(axis=0) for i in range(n)])
        inner = c[:, None] + 0.3 * (rings - c[:, None])
        parts, edge_parts = [], []
        for i in range(n):
            k = m[i] + 1
            parts += [rings[i, :k], inner[i, :k]]
            e = np.ones(2 * k - 1, bool)
            e[k - 1] = False  # the seam between the rings
            edge_parts.append(e)
        verts = np.concatenate(parts)
        lengths = 2 * (m + 1)
        edges = np.concatenate(edge_parts)
    off = np.concatenate([[0], np.cumsum(lengths)])
    e_off = np.concatenate([[0], np.cumsum(lengths - 1)])
    chunks = []
    for s in range(0, n, per_win):
        e = s + per_win
        c = {"ts": ts[s:e], "oid": oid[s:e], "lengths": lengths[s:e],
             "verts": verts[off[s]:off[e]]}
        if edges is not None:
            c["edge_valid"] = edges[e_off[s]:e_off[e]]
        chunks.append(c)
    return chunks


def geometry_objects(chunks):
    """The ``Polygon`` objects of a (closed-ring) ragged stream."""
    from spatialflink_tpu_torch.models.objects import Polygon

    out = []
    for c in chunks:
        off = np.concatenate([[0], np.cumsum(c["lengths"])])
        for i, (t, o) in enumerate(zip(c["ts"], c["oid"])):
            out.append(Polygon(obj_id=f"g{o}", timestamp=int(t),
                               rings=[c["verts"][off[i]:off[i + 1]]]))
    return out


def geometry_queries(kind):
    """The first ``GEOM_QUERIES`` polygons of config 3's set, their
    outlines opened, or their first vertices as points."""
    from spatialflink_tpu_torch.models.objects import LineString, Point

    polys = range_polygons()[:GEOM_QUERIES]
    if kind == "polygon":
        return polys
    if kind == "linestring":
        return [LineString(obj_id=f"line{i}", coords=p.rings[0][:4])
                for i, p in enumerate(polys)]
    return [Point(obj_id=f"pt{i}", x=float(p.rings[0][0, 0]),
                  y=float(p.rings[0][0, 1])) for i, p in enumerate(polys)]


def run_geometry(device, cls, chunks, queries, **conf_kw):
    """One ``run_soa`` of a geometry-stream range operator; returns
    (windows, seconds)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0, **conf_kw)
    op = cls(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks, queries, GEOM_R))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_geometry_windows(got, want, label, exact=True):
    """Window for window: starts, ends, counts, kept indices and oids
    exact, distance bits equal; distances finite and, in exact mode,
    within the radius. Returns the matches per window."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if (g[0], g[1], g[5]) != (w[0], w[1], w[5]):
            raise AssertionError(f"{label}: window {g[:2]} differs")
        if not (np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])):
            raise AssertionError(f"{label}: matches differ in {g[:2]}")
        if not np.array_equal(g[4].view(np.uint32), w[4].view(np.uint32)):
            raise AssertionError(f"{label}: distances differ in {g[:2]}")
        if not np.all(np.isfinite(g[4])) or (
                exact and not np.all(g[4] <= np.float32(GEOM_R))):
            raise AssertionError(f"{label}: window {g[:2]} malformed")
    return [len(g[2]) for g in got]


def run_geometry_objects(device, objs, queries):
    """``PolygonPolygonRangeQuery.run`` on ``Polygon`` objects; returns
    the windows as (start, end, count, ids, distance bits), seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PolygonPolygonRangeQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PolygonPolygonRangeQuery(conf, UniformGrid(**BEIJING),
                                  device=device)
    t0 = time.perf_counter()
    res = list(op.run(iter(objs), queries, GEOM_R))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return [(r.start, r.end, r.window_count,
             [(o.obj_id, o.timestamp) for o in r.objects],
             np.asarray(r.dists, np.float32).view(np.uint32).tolist())
            for r in res], time.perf_counter() - t0


def check_geometry(card, gpu="cuda"):
    """Phase 14: ``PolygonPolygonRangeQuery.run_soa`` at full width, then
    the other classes, approximate mode, a multi-ring stream and ``run``
    at a cut depth, each against its CPU twin. ``gpu``: the device of the
    runs under test (``cpu`` only to rehearse the script's logic without
    a card). Returns (B4 launches, the full-width chunks, seconds)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    t0 = time.perf_counter()
    chunks = geometry_chunks(GEOM_WINDOWS, GEOM_WIN)
    polys = geometry_queries("polygon")
    print(f"data: {GEOM_WINDOWS} x {GEOM_WIN} polygon objects "
          f"({sum(int(c['lengths'].sum()) for c in chunks)} vertices) and "
          f"{len(polys)} query polygons in {time.perf_counter() - t0:.3f} s "
          f"(host set-up)")
    polyline_min_dist.launches = 0
    got, secs = run_geometry(gpu, ops.PolygonPolygonRangeQuery, chunks,
                             polys)
    b4_launches = polyline_min_dist.launches
    # A depth cut: the CPU twin runs the first GEOM_CPU_WINDOWS windows
    # (~15-30 s a window on the host).

    def held(got=got[:GEOM_CPU_WINDOWS], cut=chunks[:GEOM_CPU_WINDOWS],
             polys=polys):
        want, cpu_secs = twin("geometry_range", cut, polys)
        check_geometry_windows(got, want, "geometry run_soa")
        print(f"exact geometry range run_soa: the first {len(want)} windows "
              f"equal the CPU plain run ({cpu_secs:.3f} s on the host CPU) "
              f"[{card}]")
    later(held)
    hits = [len(g[2]) for g in got]
    if len(got) != GEOM_WINDOWS or not all(
            np.all(np.isfinite(g[4])) and np.all(g[4] <= np.float32(GEOM_R))
            for g in got):
        raise AssertionError(f"geometry run_soa: {len(got)} windows, or a "
                             f"distance past the radius")
    if b4_launches < 2 * GEOM_WINDOWS or min(hits) == 0:
        raise AssertionError(f"geometry run_soa: {b4_launches} B4 launches, "
                             f"matches {hits}")
    n = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e geometry range run_soa (PolygonPolygon, {GEOM_QUERIES} "
          f"polygons, r={GEOM_R}): {len(got)} windows, matches per window "
          f"{hits}, {n} objects in {secs:.6f} s = {n / secs:.1f} objects/s; "
          f"launches polyline_min_dist={b4_launches}; the first "
          f"{GEOM_CPU_WINDOWS} windows held against the CPU plain run "
          f"[{card}]")

    cut = geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN)
    lines = geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN, polygonal=False)
    cases = [
        ("PolygonPoint", ops.PolygonPointRangeQuery, cut, "point", {}),
        ("PolygonLineString", ops.PolygonLineStringRangeQuery, cut,
         "linestring", {}),
        ("LineStringPoint", ops.LineStringPointRangeQuery, lines, "point",
         {}),
        ("LineStringPolygon", ops.LineStringPolygonRangeQuery, lines,
         "polygon", {}),
        ("LineStringLineString", ops.LineStringLineStringRangeQuery, lines,
         "linestring", {}),
        ("PolygonPolygon approximate", ops.PolygonPolygonRangeQuery, cut,
         "polygon", {"approximate_query": True}),
        ("PolygonPolygon multi-ring", ops.PolygonPolygonRangeQuery,
         geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN, holes=True),
         "polygon", {}),
    ]
    for label, cls, ch, qkind, kw in cases:
        qs = geometry_queries(qkind)
        polyline_min_dist.launches = 0
        g, g_secs = run_geometry(gpu, cls, ch, qs, **kw)
        launched = polyline_min_dist.launches
        b4_launches += launched
        w, w_secs = run_geometry("cpu", cls, ch, qs, **kw)
        h = check_geometry_windows(g, w, label,
                                   exact=not kw.get("approximate_query"))
        if sum(h) == 0 or launched < 2 * len(ch):
            raise AssertionError(f"geometry {label}: matches {h}, "
                                 f"{launched} B4 launches")
        print(f"e2e geometry range run_soa {label}: {len(g)} windows, "
              f"matches {h}, {GEOM_CUT_WINDOWS * GEOM_CUT_WIN} objects in "
              f"{g_secs:.6f} s; launches polyline_min_dist={launched}; equal "
              f"to the CPU run ({w_secs:.3f} s) [{card}]")

    objs = geometry_objects(cut)
    polyline_min_dist.launches = 0
    g, o_secs = run_geometry_objects(gpu, objs, polys)
    launched = polyline_min_dist.launches
    b4_launches += launched
    w, c_secs = run_geometry_objects("cpu", objs, polys)
    if g != w or len(g) != GEOM_CUT_WINDOWS or launched < 2 * len(g) \
            or not any(x[3] for x in g):
        raise AssertionError("geometry run on Polygon objects differs from "
                             "the CPU run")
    print(f"e2e geometry range run (Polygon objects): {len(g)} windows, "
          f"matches {[len(x[3]) for x in g]} in {o_secs:.6f} s; launches "
          f"polyline_min_dist={launched}; equal to the CPU run "
          f"({c_secs:.3f} s) [{card}]")
    return b4_launches, chunks, secs


def knn_points(n_win, per_win, seed, n_ids=KNN_RUN_IDS):
    """``Point`` objects of ``n_win`` one-second windows of ``per_win``
    points (bench_suite.py:47-54's positions from ``seed``), objIDs over
    ``n_ids`` objects."""
    from spatialflink_tpu_torch.models.objects import Point

    xy = join_stream(n_win * per_win, seed).astype(np.float64)
    ids = np.random.default_rng(seed + 1).integers(0, n_ids, len(xy))
    ts = (np.arange(len(xy), dtype=np.int64) * 1000) // per_win
    return [Point(obj_id=f"o{i}", timestamp=int(t), x=float(x), y=float(y))
            for i, t, (x, y) in zip(ids.tolist(), ts.tolist(), xy.tolist())]


def knn_query(kind):
    """Polygon 0 of config 3's set, its outline opened, or ``QUERY``."""
    from spatialflink_tpu_torch.models.objects import LineString, Point

    poly = range_polygons()[0]
    if kind == "polygon":
        return poly
    if kind == "linestring":
        return LineString(obj_id="line0", coords=poly.rings[0][:-1])
    return Point(obj_id="query", x=QUERY[0], y=QUERY[1])


def knn_results(res):
    """``KnnWindowResult``s as (start, end, count, objIDs, distance bits,
    representative (id, ts)) tuples."""
    return [(r.start, r.end, r.window_count, [n[0] for n in r.neighbors],
             np.float32([n[1] for n in r.neighbors]).view(np.uint32).tolist(),
             [(n[2].obj_id, n[2].timestamp) for n in r.neighbors])
            for r in res]


def run_knn(device, kind, stream, k=KNN_RUN_K, method="run", **conf_kw):
    """One point-stream kNN ``run`` (or ``query_panes``, by ``method``);
    returns the windows as ``knn_results``, seconds."""
    import torch

    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.grid import UniformGrid

    cls = {"point": ops.PointPointKNNQuery,
           "polygon": ops.PointPolygonKNNQuery,
           "linestring": ops.PointLineStringKNNQuery}[kind]
    conf_kw.setdefault("window_size", 1.0)
    conf_kw.setdefault("slide_step", 1.0)
    op = cls(ops.QueryConfiguration(**conf_kw), UniformGrid(**BEIJING),
             device=device)
    t0 = time.perf_counter()
    res = list(getattr(op, method)(iter(stream), knn_query(kind), KNN_RUN_R,
                                   k))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return knn_results(res), time.perf_counter() - t0


def check_knn_windows(got, want, label, k):
    """Window for window equal to the CPU run, distances ascending within
    the radius; returns the results per window."""
    if got != want or not got:
        raise AssertionError(f"{label}: windows differ from the CPU run")
    for w in got:
        d = np.uint32(w[4]).view(np.float32)
        if len(w[3]) > k or not np.all(np.diff(d) >= 0) \
                or not np.all(d <= np.float32(KNN_RUN_R)):
            raise AssertionError(f"{label}: window {w[:2]} malformed")
    return [len(w[3]) for w in got]


def check_knn_run(card, gpu="cuda"):
    """Phase 15: point-stream kNN ``run`` on ``Point`` objects at full
    width for point, polygon and linestring queries, then approximate
    mode, CountBased windows and the C1 error at a cut depth, each
    against its CPU twin. Returns (B4 launches, seconds a kind, the
    full-width stream)."""
    from spatialflink_tpu_torch.operators import QueryType
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    t0 = time.perf_counter()
    stream = knn_points(KNN_RUN_WINDOWS, KNN_RUN_WIN, 5)
    print(f"data: {KNN_RUN_WINDOWS} x {KNN_RUN_WIN} Point objects in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    b4_launches, walls = 0, {}
    n = len(stream)
    for kind in ("polygon", "linestring", "point"):
        polyline_min_dist.launches = 0
        got, secs = run_knn(gpu, kind, stream)
        launched = polyline_min_dist.launches
        b4_launches += launched
        want, cpu_secs = run_knn("cpu", kind, stream)
        sizes = check_knn_windows(got, want, f"kNN run {kind}", KNN_RUN_K)
        if len(got) != KNN_RUN_WINDOWS or (kind != "point" and (
                launched < KNN_RUN_WINDOWS or min(sizes) < KNN_RUN_K)):
            raise AssertionError(f"kNN run {kind}: results {sizes}, "
                                 f"{launched} B4 launches")
        walls[kind] = secs
        print(f"e2e kNN run {kind} query: {len(got)} windows, results "
              f"{sizes}, {n} points in {secs:.6f} s = {n / secs:.1f} "
              f"points/s; launches polyline_min_dist={launched}; windows "
              f"equal the CPU plain run ({cpu_secs:.3f} s on the host CPU) "
              f"[{card}]")

    cut = stream[:KNN_RUN_CUT]
    for label, kind, kw in (
            ("approximate polygon", "polygon", {"approximate_query": True}),
            ("approximate linestring", "linestring",
             {"approximate_query": True}),
            ("CountBased polygon", "polygon",
             {"query_type": QueryType.CountBased,
              "count_window_size": 7_000})):
        polyline_min_dist.launches = 0
        got, _ = run_knn(gpu, kind, cut, **kw)
        launched = polyline_min_dist.launches
        b4_launches += launched
        want, _ = run_knn("cpu", kind, cut, **kw)
        sizes = check_knn_windows(got, want, f"kNN run {label}", KNN_RUN_K)
        if launched < len(got):
            raise AssertionError(f"kNN run {label}: {launched} B4 launches")
        print(f"e2e kNN run {label}: {len(got)} windows, results {sizes}; "
              f"launches polyline_min_dist={launched}; equal to the CPU run "
              f"[{card}]")
    few = knn_points(1, KNN_RUN_CUT, 6, n_ids=32)
    raised = []
    for device in (gpu, "cpu"):
        try:
            run_knn(device, "polygon", few, k=100)
        except ValueError as e:
            raised.append(str(e))
    if len(raised) != 2:
        raise AssertionError(f"kNN run C1: k=100 over 32 objIDs raised "
                             f"{len(raised)} of 2 times")
    print(f"kNN run C1: k=100 over 32 objIDs (64 segments) raises "
          f"ValueError on {gpu} and on the CPU: {raised[0]!r} [{card}]")
    return b4_launches, walls, stream


def time_geometry(dev, card, chunks, geo_secs, knn_stream, knn_walls):
    """Phase 16: the parts of one full-width geometry-range window, the
    host's share of both paths, B4 at this slice's three shapes, the e2e
    rates and a profiler pass. Returns the B4 timing rows by shape."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.batch import (
        GeometryBatch,
        PointBatch,
        flag_prefix_planes,
    )
    from spatialflink_tpu_torch.operators import (
        PointPolygonKNNQuery,
        PolygonPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.operators.base import (
        center_coords,
        flags_for_queries,
    )
    from spatialflink_tpu_torch.ops import range as tr
    from spatialflink_tpu_torch.ops.polygon import points_in_polygons
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )
    from spatialflink_tpu_torch.streams.soa import RaggedSoaWindowAssembler

    grid = UniformGrid(**BEIJING)
    polys = geometry_queries("polygon")
    c = chunks[0]
    batch = GeometryBatch.from_ragged(c["ts"], c["oid"], c["lengths"],
                                      c["verts"])
    flags = flags_for_queries(grid, GEOM_R, polys)
    oflags = batch.any_cell_flagged(grid, flags,
                                    prefix=flag_prefix_planes(grid, flags))
    qv_np, qe_np = packed_queries(grid, polys)

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    verts, ev, valid, of = (on_card(center_coords(grid, batch.verts)),
                            on_card(batch.edge_valid), on_card(batch.valid),
                            on_card(oflags))
    qv, qe = on_card(qv_np), on_card(qe_np)
    n, v = verts.shape[:2]
    q, vq = qv.shape[:2]
    a_xy, b_xy = verts.reshape(n * v, 2), qv.reshape(q * vq, 2)
    a_ok, b_ok = tr._vert_valid(ev), tr._vert_valid(qe)
    d_ab = polyline_min_dist_cuda(a_xy, qv, qe)
    d_ba = polyline_min_dist_cuda(b_xy, verts, ev)
    in_ab = points_in_polygons(a_xy, qv, qe)
    in_ba = points_in_polygons(b_xy, verts, ev)

    def reductions():
        d = torch.minimum(tr._vertex_min(d_ab, a_ok, n, v),
                          tr._vertex_min(d_ba, b_ok, q, vq).T)
        d = torch.where((in_ab & a_ok.reshape(-1, 1))
                        .reshape(n, v, q).any(dim=1), 0.0, d)
        d = torch.where((in_ba & b_ok.reshape(-1, 1))
                        .reshape(q, vq, n).any(dim=1).T, 0.0, d)
        return tr._emit_mask(valid, of, d.amin(dim=1), GEOM_R, False)

    parts = {
        "B4 a->b": time_ms(lambda: polyline_min_dist_cuda(a_xy, qv, qe))[0],
        "B4 b->a": time_ms(lambda: polyline_min_dist_cuda(b_xy, verts,
                                                          ev))[0],
        "containment a in b": time_ms(
            lambda: points_in_polygons(a_xy, qv, qe))[0],
        "containment b in a": time_ms(
            lambda: points_in_polygons(b_xy, verts, ev))[0],
        "reductions and mask": time_ms(reductions)[0],
        "whole kernel": time_ms(lambda: tr.geometry_range_query_kernel(
            verts, ev, valid, of, qv, qe, GEOM_R, obj_polygonal=True,
            query_polygonal=True))[0],
    }
    print(f"geometry window parts (PolygonPolygon, N={n} objects of V={v}, "
          f"Q={q} queries of V={vq}, one window, device ms, medians of "
          f"{REPEATS}): "
          + ", ".join(f"{k} {t:.6f}" for k, t in parts.items())
          + f"; the window's wall in run_soa "
          f"{1e3 * geo_secs / GEOM_WINDOWS:.6f} ms [{card}]")

    # The host's share: each path's host steps alone, no device work.
    flags_host = flags_for_queries(grid, GEOM_R, polys)
    prefix = flag_prefix_planes(grid, flags_host)
    t0 = time.perf_counter()
    for w in RaggedSoaWindowAssembler(1000, 1000).stream(chunks):
        b = GeometryBatch.from_ragged(w.ts, w.oid, w.lengths, w.verts)
        b.any_cell_flagged(grid, flags_host, prefix=prefix)
        center_coords(grid, b.verts)
    geo_host = time.perf_counter() - t0
    knn_op = PointPolygonKNNQuery(QueryConfiguration(window_size=1.0,
                                                     slide_step=1.0),
                                  grid, device="cpu")
    t0 = time.perf_counter()
    for w in knn_op.windows(iter(knn_stream)):
        center_coords(grid, knn_op.point_batch(w.events).xy)
    knn_host = time.perf_counter() - t0
    print(f"host steps alone: geometry ragged windowing, from_ragged, "
          f"flags and centring {geo_host:.6f} s ({100 * geo_host / geo_secs:.1f}"
          f"% of the run_soa wall); kNN object windowing, point batches and "
          f"centring {knn_host:.6f} s ({100 * knn_host / knn_walls['polygon']:.1f}"
          f"% of the polygon run's wall) [{card}]")

    first = knn_stream[:KNN_RUN_WIN]
    knn_xy = on_card(center_coords(grid, PointBatch.from_points(first).xy))
    kv_np, ke_np = packed_queries(grid, [knn_query("polygon")])
    kv, ke = on_card(kv_np), on_card(ke_np)
    rows = {}
    for label, args in (
            ("geometry a->b", (a_xy, qv, qe, None)),
            ("geometry b->a", (b_xy, verts, ev, None)),
            ("kNN polygon G=1", (knn_xy, kv, ke, None))):
        xy, bv, be, _ = args
        ms, call = time_ms(lambda: polyline_min_dist_cuda(*args))
        plain, _ = time_ms(lambda: polyline_min_dist_plain(*args))
        kern, mems = launches_per_call(lambda: polyline_min_dist_cuda(*args))
        npts, g = xy.shape[0], bv.shape[0]
        nbytes = 8 * npts + bv.numel() * 4 + be.numel() + 4 * npts * g
        nops = 20 * npts * int(be.sum())
        bnd, by_ = bound_ms(nbytes, nops)
        rows[label] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bnd,
                           bound_by=by_, points=npts, boundaries=g,
                           kernels_per_call=kern)
        print(f"time polyline_min_dist {label} (N={npts} points, G={g} "
              f"boundaries of V={bv.shape[1]}): kernel {ms:.6f} ms device "
              f"({call:.6f} ms per call with its launch), {kern:g} kernel "
              f"launches and {mems:g} memsets per call, plain PyTorch "
              f"{plain:.6f} ms, bound {bnd:.6f} ms ({by_}: {nbytes} B, "
              f"{nops} operations), library none, medians of {REPEATS} "
              f"calls [{card}]")
    n_geo = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e rates: geometry range run_soa {n_geo / geo_secs:.1f} "
          f"objects/s; kNN run "
          + ", ".join(f"{k} {len(knn_stream) / t:.1f} points/s"
                      for k, t in knn_walls.items())
          + f" [{card}]")
    profile_run(lambda: run_geometry("cuda", PolygonPolygonRangeQuery,
                                     chunks, polys), card,
                "geometry range run_soa")
    return rows


# ---------------------------------------------------------------------------
# Phases 17-19: geometry-stream kNN, the pane-carry and SoA kNN paths.


def run_knn_geometry(device, cls, chunks, query, k=KNN_GEOM_K, **conf_kw):
    """One geometry-stream kNN ``run_soa``; returns the windows as (start,
    end, oids, distance bits, nv), seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0, **conf_kw)
    op = cls(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks, query, KNN_GEOM_R, k, GEOM_OBJECTS))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return [(w[0], w[1], w[2].tolist(),
             np.asarray(w[3], np.float32).view(np.uint32).tolist(), w[4])
            for w in out], time.perf_counter() - t0


def check_topk_windows(got, want, label, k, radius, exact=True):
    """Window for window equal to the CPU run (starts, ends, ``nv``, ids
    in order, distance bits); distances ascending and, in exact mode,
    within the radius. Returns the results per window."""
    if got != want or not got:
        raise AssertionError(f"{label}: windows differ from the CPU run")
    for w in got:
        d = np.uint32(w[3]).view(np.float32)
        if len(w[2]) != w[4] or w[4] > k or not np.all(np.diff(d) >= 0) \
                or not np.all(np.isfinite(d)) \
                or (exact and not np.all(d <= np.float32(radius))):
            raise AssertionError(f"{label}: window {w[:2]} malformed")
    return [w[4] for w in got]


def knn_geometry_objects(chunks, n_ids=None):
    """``geometry_objects`` with the objIDs folded onto ``n_ids``."""
    from spatialflink_tpu_torch.models.objects import Polygon

    objs = geometry_objects(chunks)
    if n_ids is None:
        return objs
    return [Polygon(obj_id=f"g{int(o.obj_id[1:]) % n_ids}",
                    timestamp=o.timestamp, rings=o.rings) for o in objs]


def run_knn_geometry_objects(device, objs, k=KNN_GEOM_K):
    """``PolygonPolygonKNNQuery.run`` on ``Polygon`` objects; returns the
    windows as ``knn_results``, seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PolygonPolygonKNNQuery,
        QueryConfiguration,
    )

    op = PolygonPolygonKNNQuery(
        QueryConfiguration(window_size=1.0, slide_step=1.0),
        UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    res = list(op.run(iter(objs), knn_query("polygon"), KNN_GEOM_R, k))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return knn_results(res), time.perf_counter() - t0


def check_knn_geometry(card, chunks, gpu="cuda"):
    """Phase 17: ``PolygonPolygonKNNQuery.run_soa`` at full width on phase
    14's stream, then the other five classes, approximate mode, the
    multi-ring stream, ``run`` on ``Polygon`` objects and the C1 error at
    a cut depth, each against its CPU twin. Returns (B4 launches,
    seconds of the full-width run)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    query = knn_query("polygon")
    polyline_min_dist.launches = 0
    got, secs = run_knn_geometry(gpu, ops.PolygonPolygonKNNQuery, chunks,
                                 query)
    b4_launches = polyline_min_dist.launches
    want, cpu_secs = run_knn_geometry("cpu", ops.PolygonPolygonKNNQuery,
                                      chunks, query)
    sizes = check_topk_windows(got, want, "geometry kNN run_soa",
                               KNN_GEOM_K, KNN_GEOM_R)
    if len(got) != GEOM_WINDOWS or min(sizes) < KNN_GEOM_K \
            or b4_launches < 2 * GEOM_WINDOWS:
        raise AssertionError(f"geometry kNN run_soa: results {sizes} of "
                             f"k={KNN_GEOM_K} at r={KNN_GEOM_R}, "
                             f"{b4_launches} B4 launches")
    n = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e geometry kNN run_soa (PolygonPolygon, polygon 0 of config "
          f"3, r={KNN_GEOM_R}, k={KNN_GEOM_K}): {len(got)} windows, results "
          f"{sizes}, {n} objects in {secs:.6f} s = {n / secs:.1f} objects/s; "
          f"launches polyline_min_dist={b4_launches}; windows equal the CPU "
          f"plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

    cut = geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN)
    lines = geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN, polygonal=False)
    cases = [
        ("PolygonPoint", ops.PolygonPointKNNQuery, cut, "point", {}),
        ("PolygonLineString", ops.PolygonLineStringKNNQuery, cut,
         "linestring", {}),
        ("LineStringPoint", ops.LineStringPointKNNQuery, lines, "point", {}),
        ("LineStringPolygon", ops.LineStringPolygonKNNQuery, lines,
         "polygon", {}),
        ("LineStringLineString", ops.LineStringLineStringKNNQuery, lines,
         "linestring", {}),
        ("PolygonPolygon approximate", ops.PolygonPolygonKNNQuery, cut,
         "polygon", {"approximate_query": True}),
        ("LineStringPoint approximate", ops.LineStringPointKNNQuery, lines,
         "point", {"approximate_query": True}),
        ("PolygonPolygon multi-ring", ops.PolygonPolygonKNNQuery,
         geometry_chunks(GEOM_CUT_WINDOWS, GEOM_CUT_WIN, holes=True),
         "polygon", {}),
    ]
    for label, cls, ch, qkind, kw in cases:
        approx = kw.get("approximate_query", False)
        polyline_min_dist.launches = 0
        g, g_secs = run_knn_geometry(gpu, cls, ch, knn_query(qkind), **kw)
        launched = polyline_min_dist.launches
        b4_launches += launched
        w, w_secs = run_knn_geometry("cpu", cls, ch, knn_query(qkind), **kw)
        h = check_topk_windows(g, w, f"geometry kNN {label}", KNN_GEOM_K,
                               KNN_GEOM_R, exact=not approx)
        if sum(h) == 0 or (not approx and launched < 2 * len(ch)):
            raise AssertionError(f"geometry kNN {label}: results {h}, "
                                 f"{launched} B4 launches")
        print(f"e2e geometry kNN run_soa {label}: {len(g)} windows, results "
              f"{h}, {GEOM_CUT_WINDOWS * GEOM_CUT_WIN} objects in "
              f"{g_secs:.6f} s; launches polyline_min_dist={launched}; "
              f"equal to the CPU run ({w_secs:.3f} s) [{card}]")

    objs = knn_geometry_objects(cut)
    polyline_min_dist.launches = 0
    g, o_secs = run_knn_geometry_objects(gpu, objs)
    launched = polyline_min_dist.launches
    b4_launches += launched
    w, c_secs = run_knn_geometry_objects("cpu", objs)
    if g != w or len(g) != GEOM_CUT_WINDOWS or launched < 2 * len(g) \
            or not all(x[3] for x in g):
        raise AssertionError("geometry kNN run on Polygon objects differs "
                             "from the CPU run")
    print(f"e2e geometry kNN run (Polygon objects): {len(g)} windows, "
          f"results {[len(x[3]) for x in g]} in {o_secs:.6f} s; launches "
          f"polyline_min_dist={launched}; equal to the CPU run "
          f"({c_secs:.3f} s) [{card}]")
    few = knn_geometry_objects(cut[:1], n_ids=32)
    raised = []
    for device in (gpu, "cpu"):
        try:
            run_knn_geometry_objects(device, few, k=100)
        except ValueError as e:
            raised.append(str(e))
    if len(raised) != 2:
        raise AssertionError(f"geometry kNN C1: k=100 over 32 objIDs raised "
                             f"{len(raised)} of 2 times")
    print(f"geometry kNN C1: k=100 over 32 objIDs (64 segments) raises "
          f"ValueError on {gpu} and on the CPU: {raised[0]!r} [{card}]")
    return b4_launches, secs


def pane_chunks():
    """Config 2's stream as bench_suite.py:47-54 makes it (seed 42): one
    SoA chunk a one-second pane of ``PANE_PTS`` points, oids over 16,384
    objects."""
    n = PANE_PTS * PANES
    rng = np.random.default_rng(42)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1).astype(np.float32)
    oid = rng.integers(0, NUM_SEGMENTS, n).astype(np.int32)
    ts = (np.arange(n, dtype=np.int64) * 1000) // PANE_PTS
    return [{"ts": ts[s:s + PANE_PTS], "x": xy[s:s + PANE_PTS, 0],
             "y": xy[s:s + PANE_PTS, 1], "oid": oid[s:s + PANE_PTS]}
            for s in range(0, n, PANE_PTS)]


def run_point_soa(device, method, chunks):
    """One ``PointPointKNNQuery.run_soa`` or ``run_soa_panes`` at config
    2's windows; returns the windows as (start, end, oids, distance bits,
    nv), seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )

    op = PointPointKNNQuery(
        QueryConfiguration(window_size=PANE_WINDOW_S, slide_step=1.0),
        UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(getattr(op, method)(chunks, Point(x=QUERY[0], y=QUERY[1]),
                                   PANE_R, PANE_K, NUM_SEGMENTS))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return [(w[0], w[1], w[2].tolist(),
             np.asarray(w[3], np.float32).view(np.uint32).tolist(), w[4])
            for w in out], time.perf_counter() - t0


def multi_arrays(n):
    """The multi-query config's arrays (bench_suite.py:503-515): ``n``
    positions (float32-rounded) and oids from seed 29, and its 64 query
    points from seed 23: (xy, oid, qxy)."""
    rng = np.random.default_rng(29)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1).astype(np.float32).astype(np.float64)
    oid = rng.integers(0, NUM_SEGMENTS, n)
    rq = np.random.default_rng(23)
    qxy = np.stack([rq.uniform(115.6, 117.5, MULTI_Q),
                    rq.uniform(39.7, 41.0, MULTI_Q)], axis=1)
    return xy, oid, qxy.astype(np.float32).astype(np.float64)


def multi_stream(n_win, per_win):
    """``multi_arrays`` as ``Point`` objects, ``per_win`` a one-second
    window, and its 64 query points."""
    from spatialflink_tpu_torch.models.objects import Point

    n = n_win * per_win
    xy, oid, qxy = multi_arrays(n)
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_win
    pts = [Point(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
           for i, t, (x, y) in zip(oid.tolist(), ts.tolist(), xy.tolist())]
    return pts, [Point(obj_id=f"mq{i}", x=x, y=y)
                 for i, (x, y) in enumerate(qxy.tolist())]


def run_multi(device, stream, queries, query_ids=None):
    """``PointPointKNNQuery.run_multi`` over ``stream``, or, with
    ``query_ids``, ``run`` with each of those queries alone. Returns the
    results per query (each a list of windows as ``knn_results``),
    seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )

    def op():
        return PointPointKNNQuery(
            QueryConfiguration(window_size=1.0, slide_step=1.0),
            UniformGrid(**BEIJING), device=device)

    t0 = time.perf_counter()
    if query_ids is None:
        multi = list(op().run_multi(iter(stream), queries, MULTI_R, MULTI_K))
        out = [knn_results([m.results[qi] for m in multi])
               for qi in range(len(queries))]
    else:
        out = [knn_results(op().run(iter(stream), queries[qi], MULTI_R,
                                    MULTI_K)) for qi in query_ids]
    if device != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_knn_panes(card, gpu="cuda"):
    """Phase 18: ``run_soa_panes`` and ``run_soa`` at config 2's width,
    each window equal to the other and to the CPU run; then, at a cut
    depth, ``query_panes`` for point, polygon (exact and approximate) and
    linestring queries, each equal to its CPU run and to ``run``, and
    ``run_multi`` at the multi-query config, equal to its CPU run and to
    ``run`` with a query alone. Returns (B4 launches, e2e rates)."""
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    t0 = time.perf_counter()
    chunks = pane_chunks()
    n = PANE_PTS * PANES
    print(f"data: {PANES} panes x {PANE_PTS} points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    rates = {}
    panes, p_secs = run_point_soa(gpu, "run_soa_panes", chunks)
    soa, s_secs = run_point_soa(gpu, "run_soa", chunks)
    want, c_secs = run_point_soa("cpu", "run_soa", chunks)
    sizes = check_topk_windows(panes, want, "run_soa_panes", PANE_K, PANE_R)
    check_topk_windows(soa, want, "run_soa", PANE_K, PANE_R)
    if len(panes) != PANES + int(PANE_WINDOW_S) - 1 \
            or min(sizes) < PANE_K:
        raise AssertionError(f"run_soa_panes: {len(panes)} windows, results "
                             f"{sizes}")
    rates["run_soa_panes"] = n / p_secs
    rates["run_soa"] = n / s_secs
    print(f"e2e run_soa_panes (config 2: {PANES} panes of {PANE_PTS}, "
          f"{PANE_WINDOW_S:g} s windows by 1 s, k={PANE_K}, r={PANE_R}): "
          f"{len(panes)} windows, all {PANE_K} full, {n} points in "
          f"{p_secs:.6f} s = {n / p_secs:.1f} points/s; run_soa on the same "
          f"stream {s_secs:.6f} s = {n / s_secs:.1f} points/s; every window "
          f"equal between the two and to the CPU run_soa ({c_secs:.3f} s on "
          f"the host CPU) [{card}]")

    b4_launches = 0
    stream = knn_points(QP_PANES, QP_PANE_PTS, 7)
    for label, kind, kw in (
            ("point", "point", {}), ("polygon", "polygon", {}),
            ("approximate polygon", "polygon", {"approximate_query": True}),
            ("linestring", "linestring", {})):
        polyline_min_dist.launches = 0
        kw.update(window_size=2.0, slide_step=1.0)
        got, q_secs = run_knn(gpu, kind, stream, method="query_panes", **kw)
        launched = polyline_min_dist.launches
        b4_launches += launched
        cpu, _ = run_knn("cpu", kind, stream, method="query_panes", **kw)
        run, _ = run_knn(gpu, kind, stream, **kw)
        sizes = check_knn_windows(got, cpu, f"query_panes {label}",
                                  KNN_RUN_K)
        if got != run or len(got) != QP_PANES + 1 or max(sizes) == 0 or (
                kind != "point" and launched < QP_PANES):
            raise AssertionError(f"query_panes {label}: results {sizes}, "
                                 f"{launched} B4 launches, equal to run: "
                                 f"{got == run}")
        rates[f"query_panes {label}"] = len(stream) / q_secs
        print(f"e2e query_panes {label} (Point objects, {QP_PANES} panes of "
              f"{QP_PANE_PTS}, 2 s windows by 1 s): {len(got)} windows, "
              f"results {sizes} in {q_secs:.6f} s = "
              f"{len(stream) / q_secs:.1f} points/s; launches "
              f"polyline_min_dist={launched}; equal to the CPU run and to "
              f"run [{card}]")

    t0 = time.perf_counter()
    pts, queries = multi_stream(MULTI_WINDOWS, MULTI_WIN)
    print(f"data: {MULTI_WINDOWS} x {MULTI_WIN} Point objects and "
          f"{MULTI_Q} query points in {time.perf_counter() - t0:.3f} s "
          f"(host set-up)")
    got, m_secs = run_multi(gpu, pts, queries)
    cpu, mc_secs = run_multi("cpu", pts, queries)
    alone_ids = [0, MULTI_Q - 1]
    alone, _ = run_multi(gpu, pts, queries, query_ids=alone_ids)
    per_q = [sum(check_knn_windows(r, c, f"run_multi query {qi}", MULTI_K))
             for qi, (r, c) in enumerate(zip(got, cpu))]
    if [got[i] for i in alone_ids] != alone:
        raise AssertionError("run_multi differs from run with a query alone")
    if len(got[0]) != MULTI_WINDOWS or sum(per_q) == 0:
        raise AssertionError(f"run_multi: results {per_q}")
    n_m = MULTI_WINDOWS * MULTI_WIN
    rates["run_multi"] = n_m / m_secs
    print(f"e2e run_multi ({MULTI_Q} queries, k={MULTI_K}, r={MULTI_R}, "
          f"{MULTI_WINDOWS} windows of {MULTI_WIN} Point objects): results "
          f"per query {min(per_q)}-{max(per_q)}, {n_m} points in "
          f"{m_secs:.6f} s = {n_m / m_secs:.1f} points/s; equal to the CPU "
          f"run ({mc_secs:.3f} s) and, for queries {alone_ids}, to run with "
          f"the query alone [{card}]")
    cut = multi_stream(MULTI_WINDOWS, MULTI_CUT)[0]
    got, _ = run_multi(gpu, cut, queries)
    alone, a_secs = run_multi(gpu, cut, queries,
                              query_ids=list(range(MULTI_Q)))
    if got != alone or not any(w[3] for r in got for w in r):
        raise AssertionError("run_multi at the cut differs from run with each "
                             "query alone")
    print(f"run_multi at {MULTI_WINDOWS} x {MULTI_CUT} points: every one of "
          f"the {MULTI_Q} queries equal to run with that query alone "
          f"({a_secs:.3f} s for the {MULTI_Q} runs) [{card}]")
    return b4_launches, rates


def time_knn(dev, card, chunks, geo_knn_secs, rates):
    """Phase 19: the parts of one full-width geometry kNN window, B4 at
    this slice's shapes, the pane digest and merge, the e2e rates of
    phases 17 and 18, and a profiler pass over phase 17's run. Returns
    the B4 timing rows by shape."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.batch import (
        GeometryBatch,
        flag_prefix_planes,
    )
    from spatialflink_tpu_torch.operators import PolygonPolygonKNNQuery
    from spatialflink_tpu_torch.operators.base import (
        center_coords,
        device_point_args,
        flags_for_queries,
    )
    from spatialflink_tpu_torch.ops import knn as tknn
    from spatialflink_tpu_torch.ops import range as tr
    from spatialflink_tpu_torch.ops.polygon import points_in_polygons
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    grid = UniformGrid(**BEIJING)
    query = knn_query("polygon")
    c = chunks[0]
    batch = GeometryBatch.from_ragged(c["ts"], c["oid"], c["lengths"],
                                      c["verts"])
    flags = flags_for_queries(grid, KNN_GEOM_R, [query])
    oflags = batch.any_cell_flagged(grid, flags,
                                    prefix=flag_prefix_planes(grid, flags))
    qv_np, qe_np = packed_queries(grid, [query])

    def on_card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    verts, ev, valid, of, oid = (
        on_card(center_coords(grid, batch.verts)), on_card(batch.edge_valid),
        on_card(batch.valid), on_card(oflags), on_card(batch.oid))
    qv, qe = on_card(qv_np[0]), on_card(qe_np[0])
    n, v = verts.shape[:2]
    a_xy, b_xy = verts.reshape(n * v, 2), qv
    d_pair = tr.geometry_pair_distance(verts, ev, qv[None], qe[None], True,
                                       True)[:, 0]
    parts = {
        "B4 a->b (G=1)": time_ms(lambda: polyline_min_dist_cuda(
            a_xy, qv[None], qe[None]))[0],
        "B4 b->a": time_ms(lambda: polyline_min_dist_cuda(b_xy, verts,
                                                          ev))[0],
        "containment a in b": time_ms(
            lambda: points_in_polygons(a_xy, qv[None], qe[None]))[0],
        "containment b in a": time_ms(
            lambda: points_in_polygons(b_xy, verts, ev))[0],
        "top-k": time_ms(lambda: tknn._topk_from_point_dists(
            d_pair, valid, of, oid, KNN_GEOM_R, KNN_GEOM_K,
            GEOM_OBJECTS))[0],
        "whole kernel": time_ms(lambda: tknn.knn_geometry_query_kernel(
            verts, ev, valid, of, oid, qv, qe, KNN_GEOM_R, KNN_GEOM_K,
            GEOM_OBJECTS, obj_polygonal=True, query_polygonal=True))[0],
    }
    print(f"geometry kNN window parts (PolygonPolygon, N={n} objects of "
          f"V={v}, one query of V={qv.shape[0]}, one window, device ms, "
          f"medians of {REPEATS}): "
          + ", ".join(f"{k} {t:.6f}" for k, t in parts.items())
          + f"; the window's wall in run_soa "
          f"{1e3 * geo_knn_secs / GEOM_WINDOWS:.6f} ms [{card}]")

    # A config 2 pane on the card (its centred lanes, as run_soa_panes
    # ships them) for the pane digest, B4 at G = 1 and the merge.
    pc = pane_chunks()[:5]
    xy64 = np.stack([pc[0]["x"], pc[0]["y"]], axis=1).astype(np.float64)
    xy_p, valid_p, cell_p, oid_p = device_point_args(grid, xy64,
                                                     pc[0]["oid"])
    pane_xy, pane_ok, pane_oid = (on_card(xy_p), on_card(
        valid_p & (cell_p < grid.num_cells)), on_card(oid_p))
    q = on_card(center_coords(grid, [QUERY])[0])
    digests = [tknn.knn_pane_digest_compact(pane_xy, pane_ok, None, None,
                                            pane_oid, q, PANE_R, 0,
                                            NUM_SEGMENTS)] * 5
    digest_ms = time_ms(lambda: tknn.knn_pane_digest_compact(
        pane_xy, pane_ok, None, None, pane_oid, q, PANE_R, 0,
        NUM_SEGMENTS))[0]
    geo_digest_ms = time_ms(lambda: tknn.knn_pane_digest_geometry_compact(
        pane_xy, pane_ok, None, None, pane_oid, qv, qe, PANE_R, 0,
        NUM_SEGMENTS, True))[0]
    merge_ms = time_ms(lambda: tknn.knn_merge_digest_list(
        [d.seg_min for d in digests], [d.rep for d in digests],
        np.zeros(5, np.int32), PANE_K))[0]
    print(f"pane digest and merge (config 2: a pane of {PANE_PTS} points, "
          f"{NUM_SEGMENTS} segments, 5 panes a window; device ms, medians "
          f"of {REPEATS}): point-query digest {digest_ms:.6f} a pane, "
          f"polygon-query digest (B4 at G = 1 and containment) "
          f"{geo_digest_ms:.6f} a pane, merge and top-{PANE_K} "
          f"{merge_ms:.6f} a window; a window's device work "
          f"{digest_ms + merge_ms:.6f} (one new pane and the merge) "
          f"[{card}]")

    rows = {}
    for label, args in (
            ("kNN geometry a->b G=1", (a_xy, qv[None], qe[None])),
            ("kNN geometry b->a", (b_xy, verts, ev)),
            ("pane digest G=1", (pane_xy, qv[None], qe[None]))):
        xy, bv, be = args
        ms, call = time_ms(lambda: polyline_min_dist_cuda(*args))
        plain, _ = time_ms(lambda: polyline_min_dist_plain(*args))
        kern, mems = launches_per_call(lambda: polyline_min_dist_cuda(*args))
        npts, g = xy.shape[0], bv.shape[0]
        nbytes = 8 * npts + bv.numel() * 4 + be.numel() + 4 * npts * g
        nops = 20 * npts * int(be.sum())
        bnd, by_ = bound_ms(nbytes, nops)
        rows[label] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bnd,
                           bound_by=by_, points=npts, boundaries=g,
                           kernels_per_call=kern)
        print(f"time polyline_min_dist {label} (N={npts} points, G={g} "
              f"boundaries of V={bv.shape[1]}): kernel {ms:.6f} ms device "
              f"({call:.6f} ms per call with its launch), {kern:g} kernel "
              f"launches and {mems:g} memsets per call, plain PyTorch "
              f"{plain:.6f} ms, bound {bnd:.6f} ms ({by_}: {nbytes} B, "
              f"{nops} operations), library none, medians of {REPEATS} "
              f"calls [{card}]")
    n_geo = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e rates: geometry kNN run_soa {n_geo / geo_knn_secs:.1f} "
          f"objects/s; "
          + ", ".join(f"{k} {r:.1f} points/s" for k, r in rates.items())
          + f" [{card}]")
    profile_run(lambda: run_knn_geometry("cuda", PolygonPolygonKNNQuery,
                                         chunks, query), card,
                "geometry kNN run_soa")
    return rows



# ---------------------------------------------------------------------------
# Phases 20-22: the rest of the join (the geometry joins, query_panes).


def pg_points():
    """The suite's join_point_1000polygons points: the positions of
    ``_stream(8 * 131_072, seed=19)`` (bench_suite.py:47-55, :825), drawn
    in one call, re-timed to ``PG_WIN`` points a second."""
    xy = join_stream(PG_WINDOWS * PG_WIN, 19)
    ts = (np.arange(len(xy), dtype=np.int64) * 1000) // PG_WIN
    return xy, ts


def point_chunks(xy, ts, per_win):
    """One SoA point chunk a one-second window."""
    return [{"ts": ts[s:s + per_win], "x": xy[s:s + per_win, 0],
             "y": xy[s:s + per_win, 1]}
            for s in range(0, len(xy), per_win)]


def pg_polygons():
    """The suite's 1,000 zone polygons (bench_suite.py:812-814)."""
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    return generate_query_polygons(PG_POLYS, 115.5, 39.6, 117.6, 41.1,
                                   grid_size=100, seed=13)


def polygon_chunks(polys, n_win, polygonal=True):
    """``polys`` (closed 5-vertex rings) as a ragged stream, all of them in
    every one-second window (ts spread over the window); ``polygonal``
    False sends their outlines opened (4 vertices)."""
    rings = [p.rings[0] if polygonal else p.rings[0][:4] for p in polys]
    m = len(rings)
    verts = np.concatenate(rings)
    lengths = np.array([len(r) for r in rings], np.int64)
    return [{"ts": w * 1000 + (np.arange(m, dtype=np.int64) * 1000) // m,
             "oid": np.arange(m, dtype=np.int32), "lengths": lengths,
             "verts": verts} for w in range(n_win)]


def polygon_objects(polys, n_win):
    """``polys`` as ``Polygon`` objects, all of them in every window."""
    from spatialflink_tpu_torch.models.objects import Polygon

    m = len(polys)
    return [Polygon(obj_id=p.obj_id, timestamp=w * 1000 + i * 1000 // m,
                    rings=p.rings)
            for w in range(n_win) for i, p in enumerate(polys)]


def run_join_soa(device, cls, left, right, radius, **conf_kw):
    """One geometry-join ``run_soa`` in one-second windows; returns the
    windows as (start, end, left idx, right idx, distance bits, count),
    seconds and the operator (its grown retry state)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0, **conf_kw)
    op = cls(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(left, right, radius))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [(w[0], w[1], w[2], w[3],
             np.asarray(w[4], np.float32).view(np.uint32), w[5])
            for w in out], secs, op


def check_join_windows(got, want, label, radius, exact=True):
    """Window for window equal to the CPU run: starts, ends, counts, both
    index arrays in order, distance bits; distances finite and, in exact
    mode, within the radius. Returns the pairs per window."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if (g[0], g[1], g[5]) != (w[0], w[1], w[5]) or not all(
                np.array_equal(a, b) for a, b in zip(g[2:5], w[2:5])):
            raise AssertionError(f"{label}: window {g[:2]} differs from the "
                                 f"CPU run")
        d = g[4].view(np.float32)
        if len(g[2]) != g[5] or np.any(g[2] < 0) or np.any(g[3] < 0) \
                or not np.all(np.isfinite(d)) \
                or (exact and not np.all(d <= np.float32(radius))):
            raise AssertionError(f"{label}: window {g[:2]} malformed")
    return [g[5] for g in got]


def run_join_objects(device, cls, left, right, radius):
    """A geometry join's ``run`` on objects; returns the windows as
    (start, end, count, [(left id, ts, right id, ts, distance bits)])
    and seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    op = cls(QueryConfiguration(window_size=1.0, slide_step=1.0),
             UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    res = list(op.run(iter(left), iter(right), radius))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return [(r.start, r.end, r.window_count,
             [(a.obj_id, a.timestamp, b.obj_id, b.timestamp,
               int(np.float32(d).view(np.uint32))) for a, b, d in r.pairs])
            for r in res], time.perf_counter() - t0


def join_cut_cases(gpu, card, cases, label_of):
    """Each (label, class, left, right, conf) case on ``gpu`` and on the
    CPU, the windows equal; B4 launched at least ``min_b4`` times in
    exact mode. Returns the B4 launches."""
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    total = 0
    for label, cls, left, right, kw, min_b4 in cases:
        approx = kw.get("approximate_query", False)
        polyline_min_dist.launches = 0
        g, g_secs, op = run_join_soa(gpu, cls, left, right, PG_R, **kw)
        launched = polyline_min_dist.launches
        total += launched
        w, w_secs, _ = run_join_soa("cpu", cls, left, right, PG_R, **kw)
        h = check_join_windows(g, w, f"{label_of} {label}", PG_R,
                               exact=not approx)
        if sum(h) == 0 or (approx and launched) or (
                not approx and launched < min_b4):
            raise AssertionError(f"{label_of} {label}: pairs {h}, "
                                 f"{launched} B4 launches")
        print(f"e2e {label_of} run_soa {label}: {len(g)} windows, pairs {h} "
              f"in {g_secs:.6f} s; launches polyline_min_dist={launched}; "
              f"cand {op._cand}, pair_cap {op._pair_cap}, budget "
              f"{op._geom_max_pairs}; equal to the CPU run ({w_secs:.3f} s) "
              f"[{card}]")
    return total


def check_join_point_geometry(card, gpu="cuda"):
    """Phase 20: ``PointPolygonJoinQuery.run_soa`` at the suite's
    join_point_1000polygons, then the other point ⋈ geometry paths at a
    cut depth, each against its CPU twin. Returns (B4 launches, seconds
    and the operator of the full-width run, the full-width inputs)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    t0 = time.perf_counter()
    xy, ts = pg_points()
    polys = pg_polygons()
    left = point_chunks(xy, ts, PG_WIN)
    right = polygon_chunks(polys, PG_WINDOWS)
    print(f"data: {PG_WINDOWS} x {PG_WIN} points and {len(polys)} polygons "
          f"a window in {time.perf_counter() - t0:.3f} s (host set-up)")
    polyline_min_dist.launches = 0
    got, secs, op = run_join_soa(gpu, ops.PointPolygonJoinQuery, left,
                                 right, PG_R)
    b4_launches = polyline_min_dist.launches

    def held(got=got, left=left, right=right):
        want, cpu_secs = twin("pg_join", left, right)
        check_join_windows(got, want, "point-polygon join run_soa", PG_R)
        print(f"exact point-polygon join run_soa: windows equal the CPU "
              f"plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")
    later(held)
    pairs = check_join_windows(got, got, "point-polygon join run_soa",
                               PG_R)
    if len(got) != PG_WINDOWS or b4_launches < PG_WINDOWS:
        raise AssertionError(f"point-polygon join run_soa: {len(got)} "
                             f"windows, {b4_launches} B4 launches")
    n = PG_WINDOWS * PG_WIN
    print(f"e2e point-polygon join run_soa (join_point_1000polygons: "
          f"{PG_WINDOWS} x {PG_WIN} points, {len(polys)} polygons, "
          f"r={PG_R}): pairs per window {pairs}, {sum(pairs)} in all (the "
          f"JAX suite recorded {SUITE_PG_PAIRS} from uncentred float32 "
          f"coordinates, BENCH_SUITE.json; a sanity check, not a gate), "
          f"{n} points in {secs:.6f} s = {n / secs:.1f} points/s; launches "
          f"polyline_min_dist={b4_launches}; cand {op._cand}, pair_cap "
          f"{op._pair_cap}, budget {op._geom_max_pairs}; windows held "
          f"against the CPU plain run [{card}]")

    cut_n = JOIN_CUT_WINDOWS * JOIN_CUT_WIN
    cut_ts = (np.arange(cut_n, dtype=np.int64) * 1000) // JOIN_CUT_WIN
    cut = point_chunks(xy[:cut_n], cut_ts, JOIN_CUT_WIN)
    c_polys = polygon_chunks(polys, JOIN_CUT_WINDOWS)
    c_lines = polygon_chunks(polys, JOIN_CUT_WINDOWS, polygonal=False)
    w = JOIN_CUT_WINDOWS
    b4_launches += join_cut_cases(gpu, card, [
        ("PointLineString", ops.PointLineStringJoinQuery, cut, c_lines, {},
         w),
        ("PointPolygon approximate (emit all)", ops.PointPolygonJoinQuery,
         cut, c_polys, {"approximate_query": True}, 0),
        ("PolygonPoint approximate (bbox distance)",
         ops.PolygonPointJoinQuery, cut, c_polys,
         {"approximate_query": True}, 0),
        ("LineStringPoint", ops.LineStringPointJoinQuery, cut, c_lines, {},
         w),
    ], "point-geometry join")

    from spatialflink_tpu_torch.models.objects import Point

    pts = [Point(obj_id=f"p{i}", timestamp=int(t), x=float(x), y=float(y))
           for i, (t, (x, y)) in enumerate(zip(
               cut_ts.tolist(), xy[:cut_n].astype(np.float64).tolist()))]
    pobjs = polygon_objects(polys, JOIN_CUT_WINDOWS)
    polyline_min_dist.launches = 0
    g, o_secs = run_join_objects(gpu, ops.PointPolygonJoinQuery, pts, pobjs,
                                 PG_R)
    launched = polyline_min_dist.launches
    b4_launches += launched
    w_, c_secs = run_join_objects("cpu", ops.PointPolygonJoinQuery, pts,
                                  pobjs, PG_R)
    if g != w_ or len(g) != JOIN_CUT_WINDOWS or launched < len(g) \
            or not all(x[3] for x in g):
        raise AssertionError("point-polygon join run on objects differs "
                             "from the CPU run")
    print(f"e2e point-polygon join run (Point and Polygon objects): "
          f"{len(g)} windows, pairs {[len(x[3]) for x in g]} in "
          f"{o_secs:.6f} s; launches polyline_min_dist={launched}; equal to "
          f"the CPU run ({c_secs:.3f} s) [{card}]")
    return b4_launches, secs, op, (left, right)


def check_join_geometry_geometry(card, geo_chunks, gpu="cuda"):
    """Phase 21: ``PolygonPolygonJoinQuery.run_soa`` on the first
    ``GG_WINDOWS`` windows of phase 14's stream against config 3's 1,000
    polygons, the other classes, approximate
    mode, the multi-ring stream and ``run`` at a cut depth, each against
    its CPU twin. Returns (B4 launches, seconds and operator of the
    full-width run, its inputs)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    polys = range_polygons()
    # A depth cut: the first GG_WINDOWS windows of phase 14's stream on
    # both sides, every card window compared with its CPU twin.
    geo_chunks = geo_chunks[:GG_WINDOWS]
    right = polygon_chunks(polys, GG_WINDOWS)
    polyline_min_dist.launches = 0
    got, secs, op = run_join_soa(gpu, ops.PolygonPolygonJoinQuery,
                                 geo_chunks, right, PG_R)
    b4_launches = polyline_min_dist.launches
    # The CPU twin runs the first GG_CPU_WINDOWS of them (~35-55 s a
    # window on the host).

    def held(got=got[:GG_CPU_WINDOWS], left=geo_chunks[:GG_CPU_WINDOWS],
             right=right[:GG_CPU_WINDOWS]):
        want, cpu_secs = twin("gg_join", left, right)
        check_join_windows(got, want, "polygon-polygon join run_soa", PG_R)
        print(f"exact polygon-polygon join run_soa: the first {len(want)} "
              f"windows equal the CPU plain run ({cpu_secs:.3f} s on the "
              f"host CPU) [{card}]")
    later(held)
    pairs = check_join_windows(got, got, "polygon-polygon join run_soa",
                               PG_R)
    if len(got) != GG_WINDOWS or b4_launches < 2 * GG_WINDOWS \
            or min(pairs) == 0:
        raise AssertionError(f"polygon-polygon join run_soa: pairs {pairs}, "
                             f"{b4_launches} B4 launches")
    n = GG_WINDOWS * GEOM_WIN
    print(f"e2e polygon-polygon join run_soa ({GG_WINDOWS} x {GEOM_WIN} "
          f"polygons of phase 14 ⋈ config 3's {len(polys)} polygons, "
          f"r={PG_R}): pairs per window {pairs}, {n} objects in "
          f"{secs:.6f} s = {n / secs:.1f} objects/s; launches "
          f"polyline_min_dist={b4_launches}; cand {op._cand}, pair_cap "
          f"{op._pair_cap}, budget {op._geom_max_pairs}; the first "
          f"{GG_CPU_WINDOWS} windows held against the CPU plain run "
          f"[{card}]")

    w = JOIN_CUT_WINDOWS
    cut = geometry_chunks(w, JOIN_CUT_WIN)
    lines = geometry_chunks(w, JOIN_CUT_WIN, polygonal=False)
    c_polys = polygon_chunks(polys, w)
    c_lines = polygon_chunks(polys, w, polygonal=False)
    b4_launches += join_cut_cases(gpu, card, [
        ("PolygonLineString", ops.PolygonLineStringJoinQuery, cut, c_lines,
         {}, 2 * w),
        ("LineStringPolygon", ops.LineStringPolygonJoinQuery, lines,
         c_polys, {}, 2 * w),
        ("LineStringLineString", ops.LineStringLineStringJoinQuery, lines,
         c_lines, {}, 2 * w),
        ("PolygonPolygon approximate", ops.PolygonPolygonJoinQuery, cut,
         c_polys, {"approximate_query": True}, 0),
        ("PolygonPolygon multi-ring", ops.PolygonPolygonJoinQuery,
         geometry_chunks(w, JOIN_CUT_WIN, holes=True), c_polys, {}, 2 * w),
    ], "geometry-geometry join")

    objs = geometry_objects(cut)
    pobjs = polygon_objects(polys, w)
    polyline_min_dist.launches = 0
    g, o_secs = run_join_objects(gpu, ops.PolygonPolygonJoinQuery, objs,
                                 pobjs, PG_R)
    launched = polyline_min_dist.launches
    b4_launches += launched
    w_, c_secs = run_join_objects("cpu", ops.PolygonPolygonJoinQuery, objs,
                                  pobjs, PG_R)
    if g != w_ or len(g) != w or launched < 2 * len(g) \
            or not all(x[3] for x in g):
        raise AssertionError("polygon-polygon join run on objects differs "
                             "from the CPU run")
    print(f"e2e polygon-polygon join run (Polygon objects): {len(g)} "
          f"windows, pairs {[len(x[3]) for x in g]} in {o_secs:.6f} s; "
          f"launches polyline_min_dist={launched}; equal to the CPU run "
          f"({c_secs:.3f} s) [{card}]")
    return b4_launches, secs, op, (geo_chunks, right)


def run_query_panes(device, streams, method="query_panes", launches=None):
    """``PointPointJoinQuery.query_panes`` (or ``run``) over the two
    ``Point`` streams in 2 s windows by 1 s. Returns the windows as
    (start, end, overflow, count, [(left id, ts, right id, ts, distance
    bits)]) and seconds; ``launches``, a list, collects B3's launch count
    after each window."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    op = PointPointJoinQuery(
        QueryConfiguration(window_size=2.0, slide_step=1.0),
        UniformGrid(**BEIJING), cap=JOIN_CAP, device=device)
    out = []
    t0 = time.perf_counter()
    for r in getattr(op, method)(iter(streams[0]), iter(streams[1]),
                                 JOIN_R):
        out.append((r.start, r.end, r.overflow, r.window_count,
                    [(a.obj_id, a.timestamp, b.obj_id, b.timestamp,
                      int(np.float32(d).view(np.uint32)))
                     for a, b, d in r.pairs]))
        if launches is not None:
            launches.append(join_extract.launches)
    if device != "cpu":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def qpj_streams():
    """The query_panes join's two ``Point`` streams (seeds 3 and 4)."""
    from spatialflink_tpu_torch.models.objects import Point

    n = QPJ_PANES * QPJ_PANE_PTS
    streams = []
    for side, seed in (("l", 3), ("r", 4)):
        xy = join_stream(n, seed).astype(np.float64)
        ts = (np.arange(n, dtype=np.int64) * 1000) // QPJ_PANE_PTS
        streams.append([Point(obj_id=f"{side}{i}", timestamp=int(t),
                              x=float(x), y=float(y))
                        for i, (t, (x, y)) in enumerate(zip(ts, xy))])
    return streams


def check_join_panes(card, gpu="cuda"):
    """``PointPointJoinQuery.query_panes`` at a cut depth: each window
    equal to its CPU run in order and to ``run`` as a multiset, B3
    launched once for each new block of two non-empty panes. Returns
    (B3 launches, points/s)."""
    import collections

    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    n = QPJ_PANES * QPJ_PANE_PTS
    streams = qpj_streams()
    join_extract.launches = 0
    after = []
    got, secs = run_query_panes(gpu, streams, launches=after)
    launches = join_extract.launches

    def held(got=got, streams=streams):
        cpu, c_secs = twin("query_panes", streams)
        if got != cpu:
            raise AssertionError("query_panes differs from its CPU run")
        print(f"exact query_panes join: {len(got)} windows equal the CPU "
              f"run in order ({c_secs:.3f} s) [{card}]")
    later(held)
    run, _ = run_query_panes(gpu, streams, method="run")
    for g, r in zip(got, run):
        if g[:4] != r[:4] or g[2] != 0 or collections.Counter(g[4]) != \
                collections.Counter(r[4]):
            raise AssertionError(f"query_panes window {g[:2]} differs from "
                                 f"run")
    # Blocks joined in each window: (p, q) of its panes, both non-empty,
    # not joined by an earlier window.
    live = range(0, QPJ_PANES * 1000, 1000)
    seen, new = set(), []
    for g in got:
        starts = [p for p in range(g[0], g[1], 1000) if p in live]
        blocks = {(p, q) for p in starts for q in starts} - seen
        seen |= blocks
        new.append(len(blocks))
    steps = np.diff([0] + after).tolist()
    if len(got) != len(run) or steps != new or not any(g[4] for g in got):
        raise AssertionError(f"query_panes: B3 launches a window {steps}, "
                             f"new blocks {new}")
    rate = 2 * n / secs
    print(f"e2e query_panes join ({QPJ_PANES} panes of {QPJ_PANE_PTS} Point "
          f"objects a side, 2 s windows by 1 s, r={JOIN_R}): {len(got)} "
          f"windows, pairs {[len(g[4]) for g in got]} in {secs:.6f} s = "
          f"{rate:.1f} points/s; B3 launches a window {steps} (its new "
          f"blocks), {launches} in all; equal to run as multisets, held "
          f"against the CPU run in order [{card}]")
    return launches, rate


def time_join(dev, card, pg, gg, qp_rate):
    """Phase 22: the parts of one full-width phase-20 and phase-21 window,
    B4 at the joins' gathered shapes beside its bound and plain version,
    the e2e rates, and a profiler pass over phase 20's run. ``pg`` and
    ``gg``: (seconds, operator, (left, right)) of phases 20 and 21.
    Returns the B4 timing rows by shape."""
    import torch

    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.models.batch import GeometryBatch
    from spatialflink_tpu_torch.operators.base import device_point_args
    from spatialflink_tpu_torch.ops import join as tjoin
    from spatialflink_tpu_torch.ops.polygon import points_in_polygons
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )
    from spatialflink_tpu_torch.ops.range import tile_lanes

    def batch(c):
        return GeometryBatch.from_ragged(c["ts"], c["oid"], c["lengths"],
                                         c["verts"])

    rows = {}

    def b4_row(label, args):
        xy, bv, be, sel = args
        ms, call = time_ms(lambda: polyline_min_dist_cuda(*args))
        plain, _ = time_ms(lambda: polyline_min_dist_plain(*args))
        kern, mems = launches_per_call(lambda: polyline_min_dist_cuda(*args))
        npts, c = sel.shape
        nbytes = 8 * npts + 8 * sel.numel() + bv.numel() * 4 + be.numel()
        nops = 20 * int(be.sum(dim=1)[sel.long()].sum())
        bnd, by_ = bound_ms(nbytes, nops)
        rows[label] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=bnd,
                           bound_by=by_, points=npts, slots=c,
                           boundaries=bv.shape[0], kernels_per_call=kern)
        print(f"time polyline_min_dist {label} (N={npts} points, C={c} "
              f"gathered slots of G={bv.shape[0]} boundaries of "
              f"V={bv.shape[1]}): kernel {ms:.6f} ms device ({call:.6f} ms "
              f"per call with its launch), {kern:g} kernel launches and "
              f"{mems:g} memsets per call, plain PyTorch {plain:.6f} ms, "
              f"bound {bnd:.6f} ms ({by_}: {nbytes} B, {nops} operations), "
              f"library none, medians of {REPEATS} calls [{card}]")
        return ms

    # Phase 20's first window, as run_soa builds it.
    pg_secs, pg_op, (left, right) = pg
    grid = pg_op.grid
    op = ops.PointPolygonJoinQuery(pg_op.conf, grid, device=dev)
    c0 = left[0]
    xy64 = np.stack([c0["x"], c0["y"]], axis=1).astype(np.float64)
    lxy, lvalid, lcell, _ = device_point_args(grid, xy64, None)
    gb = batch(right[0])
    ho = np.argsort(lcell, kind="stable")
    args, r = op._point_side_args(lambda: lxy[ho], lvalid[ho], lcell[ho],
                                  gb, PG_R)
    pxy, pv, gverts, gev, gvalid, gbbox = args
    cand = min(pg_op._cand, gbbox.shape[0])
    pair_cap = min(pg_op._pair_cap, cand)
    mp = pg_op._geom_max_pairs
    block = op._point_block
    sx, bvalid, _, gids, _, _ = tjoin.point_tiles(pxy, pv, gbbox, gvalid, r,
                                                  block, cand)
    sel = gids.repeat_interleave(block, dim=0)
    nb = bvalid.shape[0]
    masks = tjoin.point_geometry_join_masks(*args, r, True, block, cand)
    parts = {
        "bbox prune and first-cand": time_ms(lambda: tjoin.point_tiles(
            pxy, pv, gbbox, gvalid, r, block, cand))[0],
        "B4 gathered": b4_row("join point-polygon gathered",
                              (sx, gverts, gev, sel)),
        "containment gathered": time_ms(lambda: points_in_polygons(
            sx, gverts, gev, sel))[0],
        "_compact_pairs": time_ms(lambda: tjoin.compact_pruned(
            masks, pair_cap, mp))[0],
        "whole kernel": time_ms(
            lambda: tjoin.point_geometry_join_pruned_kernel(
                *args, r, polygonal=True, block=block, cand=cand,
                max_pairs=mp, pair_cap=pair_cap))[0],
    }
    print(f"point-polygon join window parts (join_point_1000polygons, one "
          f"window: N={PG_WIN} points in {nb} tiles of {block}, "
          f"{gverts.shape[0]} polygons of V={gverts.shape[1]}, cand {cand}, "
          f"pair_cap {pair_cap}; device ms, medians of {REPEATS}): "
          + ", ".join(f"{k} {t:.6f}" for k, t in parts.items())
          + f"; the window's wall in run_soa "
          f"{1e3 * pg_secs / PG_WINDOWS:.6f} ms [{card}]")

    # Phase 21's first window.
    gg_secs, gg_op, (gleft, gright) = gg
    gop = ops.PolygonPolygonJoinQuery(gg_op.conf, grid, device=dev)
    la, ra = batch(gleft[0]), batch(gright[0])
    _, gargs = gop._window_args(la, ra)
    averts, aev, avalid, abox, bverts, bev, bvalid, bbox = gargs
    gcand = min(gg_op._cand, bbox.shape[0])
    gpair_cap = min(gg_op._pair_cap, gcand)
    gmp = gg_op._geom_max_pairs
    gblock = gop._geom_block
    _, _, gborig, ggids, _, _ = tjoin.geometry_tiles(
        abox, avalid, bbox, bvalid, PG_R, gblock, gcand)
    pad = gborig.numel() - averts.shape[0]
    sav = torch.nn.functional.pad(averts, (0, 0, 0, 0, 0, pad))
    sae = torch.nn.functional.pad(aev, (0, 0, 0, pad))
    a_xy, sel_ab, b_xy, sel_ba = tile_lanes(sav, bverts, ggids)
    gmasks = tjoin.geometry_geometry_join_masks(*gargs, PG_R, True, True,
                                                gblock, gcand)
    gparts = {
        "bbox prune and first-cand": time_ms(lambda: tjoin.geometry_tiles(
            abox, avalid, bbox, bvalid, PG_R, gblock, gcand))[0],
        "B4 a->b gathered": b4_row("join geometry a->b gathered",
                                   (a_xy, bverts, bev, sel_ab)),
        "B4 b->a gathered": b4_row("join geometry b->a gathered",
                                   (b_xy, sav, sae, sel_ba)),
        "containment a in b": time_ms(lambda: points_in_polygons(
            a_xy, bverts, bev, sel_ab))[0],
        "containment b in a": time_ms(lambda: points_in_polygons(
            b_xy, sav, sae, sel_ba))[0],
        "_compact_pairs": time_ms(lambda: tjoin.compact_pruned(
            gmasks, gpair_cap, gmp))[0],
    }
    print(f"polygon-polygon join window parts (one window: {GEOM_WIN} "
          f"polygons of V={averts.shape[1]} in {ggids.shape[0]} tiles of "
          f"{gblock}, {bverts.shape[0]} polygons of V={bverts.shape[1]}, "
          f"cand {gcand}, pair_cap {gpair_cap}; device ms, medians of "
          f"{REPEATS}): " + ", ".join(f"{k} {t:.6f}"
                                      for k, t in gparts.items())
          + f"; the window's wall in run_soa "
          f"{1e3 * gg_secs / GG_WINDOWS:.6f} ms [{card}]")
    print(f"e2e rates: point-polygon join run_soa "
          f"{PG_WINDOWS * PG_WIN / pg_secs:.1f} points/s, polygon-polygon "
          f"join run_soa {GG_WINDOWS * GEOM_WIN / gg_secs:.1f} objects/s, "
          f"query_panes join {qp_rate:.1f} points/s [{card}]")
    profile_run(lambda: run_join_soa("cuda", ops.PointPolygonJoinQuery,
                                     left, right, PG_R), card,
                "point-polygon join run_soa")
    return rows


def tjoin_chunks(seed):
    """One tjoin_10s_1s_sliding stream: ``TJ_SLIDES`` one-second chunks of
    ``TJ_SLIDE_PTS`` points, positions as bench_suite.py:976-983 draws
    them (x, then y, then the ids), unquantized."""
    n = TJ_SLIDE_PTS * TJ_SLIDES
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1)
    oid = rng.integers(0, TJ_IDS, n).astype(np.int32)
    ts = (np.arange(n, dtype=np.int64) * 1000) // TJ_SLIDE_PTS
    return [{"ts": ts[s:s + TJ_SLIDE_PTS], "x": xy[s:s + TJ_SLIDE_PTS, 0],
             "y": xy[s:s + TJ_SLIDE_PTS, 1], "oid": oid[s:s + TJ_SLIDE_PTS]}
            for s in range(0, n, TJ_SLIDE_PTS)]


def run_tjoin_soa(device, chunks, slide_s=1):
    """``PointPointTJoinQuery.run_soa`` in 10 s windows by ``slide_s``;
    returns the windows (start, end, left ids, right ids, distance bits,
    count, overflow), seconds and the operator."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=TJ_WINDOW_S, slide_step=slide_s)
    op = PointPointTJoinQuery(conf, UniformGrid(**BEIJING), cap=TJ_CAP,
                              device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks[0], chunks[1], TJ_R, TJ_IDS,
                          max_pairs=TJ_MAX_PAIRS))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [(w[0], w[1], w[2], w[3], np.asarray(w[4], np.float32).view(
        np.uint32), w[5], w[6]) for w in out], secs, op


def traj_points(chunks, n, per_win, prefix):
    """The first ``n`` points of a chunk stream as ``Point`` objects,
    re-timed to ``per_win`` a second, ids ``prefix`` + the dense id."""
    from spatialflink_tpu_torch.models.objects import Point

    x = np.concatenate([c["x"] for c in chunks])[:n]
    y = np.concatenate([c["y"] for c in chunks])[:n]
    oid = np.concatenate([c["oid"] for c in chunks])[:n]
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_win
    return [Point(obj_id=f"{prefix}{o}", timestamp=int(t), x=float(a),
                  y=float(b))
            for o, t, a, b in zip(oid.tolist(), ts.tolist(),
                                  x.astype(np.float64).tolist(),
                                  y.astype(np.float64).tolist())]


def traj_lines(trajs):
    return [(t.obj_id, t.timestamp, t.coords.tobytes()) for t in trajs]


def run_objects_family(device, cls, method, streams, *args, **conf_kw):
    """``cls(...).<method>(*streams, *args)`` on ``Point`` objects in
    one-second windows; returns the results reduced to comparable tuples
    and seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    op_kw = conf_kw.pop("op_kw", {})
    conf_kw.setdefault("window_size", 1.0)
    conf_kw.setdefault("slide_step", 1.0)
    op = cls(QueryConfiguration(**conf_kw), UniformGrid(**BEIJING),
             device=device, **op_kw)
    t0 = time.perf_counter()
    res = list(getattr(op, method)(*(iter(s) for s in streams), *args))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    out = []
    for r in res:
        if hasattr(r, "pairs"):
            body = [(a.obj_id, b.obj_id, a.coords.tobytes(),
                     b.coords.tobytes(), int(np.float32(d).view(np.uint32)))
                    for a, b, d in r.pairs]
        elif hasattr(r, "neighbors"):
            body = [(o, int(np.float32(d).view(np.uint32)), t.coords.tobytes())
                    for o, d, t in r.neighbors]
        elif hasattr(r, "trajectories"):
            body = traj_lines(r.trajectories)
        elif hasattr(r, "cells"):
            body = r.cells
        else:
            body = r.stats
        out.append((r.start, r.end, r.window_count, body))
    return out, secs


def tjoin_object_streams(chunks):
    """Phase 23's ``Point`` streams: the first 2 x ``T_CUT`` points of
    each side."""
    return [traj_points(c, 2 * T_CUT, T_CUT, side)
            for c, side in zip(chunks, ("l", "r"))]


def check_tjoin(card, gpu="cuda"):
    """Phase 23: ``PointPointTJoinQuery.run_soa`` at the JAX suite's
    tjoin_10s_1s_sliding width through B3, every window's overflow 0 and
    the first, a middle and the last full window equal to the CPU run;
    then ``run`` and ``run_single`` on 2 x 20,000 ``Point``s a side
    against the CPU. Returns (B3 launches, the run_soa windows, seconds,
    the inputs)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    t0 = time.perf_counter()
    chunks = (tjoin_chunks(31), tjoin_chunks(32))
    print(f"data: 2 x {TJ_SLIDES} x {TJ_SLIDE_PTS} tJoin points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    join_extract.launches = 0
    got, secs, op = run_tjoin_soa(gpu, chunks)
    launches = join_extract.launches
    n_windows = TJ_SLIDES + TJ_WINDOW_S - 1
    if len(got) != n_windows or launches < n_windows:
        raise AssertionError(f"tJoin run_soa: {len(got)} windows, {launches} "
                             f"B3 launches")

    def held(by_start={g[0]: g for g in got}, chunks=chunks):
        want, cpu_secs = twin("tjoin_soa", chunks)
        if tuple(w[0] for w in want) != TJ_CPU_STARTS:
            raise AssertionError(f"tJoin run_soa: CPU windows "
                                 f"{[w[0] for w in want]}")
        for w in want:
            g = by_start[w[0]]
            if g[:2] != w[:2] or g[5:] != w[5:] or not all(
                    np.array_equal(a, b) for a, b in zip(g[2:5], w[2:5])):
                raise AssertionError(f"tJoin run_soa: window {w[:2]} "
                                     f"differs from the CPU run")
        print(f"exact tJoin run_soa: the windows starting "
              f"{list(TJ_CPU_STARTS)} ms (the first, a middle and the last "
              f"full window) equal the CPU plain run ({cpu_secs:.3f} s on "
              f"the host CPU for those 3) [{card}]")
    later(held)
    for g in got:
        d = g[4].view(np.float32)
        if g[6] != 0 or len(g[2]) != g[5] or np.any(np.diff(
                g[2].astype(np.int64) * TJ_IDS + g[3]) <= 0) \
                or not np.all(d <= np.float32(TJ_R)):
            raise AssertionError(f"tJoin run_soa: window {g[:2]} malformed "
                                 f"or overflowed ({g[6]})")
    n = 2 * TJ_SLIDES * TJ_SLIDE_PTS
    print(f"e2e tJoin run_soa (tjoin_10s_1s_sliding: 2 x {TJ_SLIDES} slides "
          f"of {TJ_SLIDE_PTS} points, {TJ_WINDOW_S} s windows by 1 s, "
          f"{TJ_IDS} ids, r={TJ_R}, cap {TJ_CAP}): {len(got)} windows, "
          f"overflow 0 in each, trajectory pairs per window "
          f"{[g[5] for g in got]}, {n} points in {secs:.6f} s = "
          f"{n / secs:.1f} points/s; launches join_extract={launches}; "
          f"trajectory-pair budget grown to {op._max_tpairs}; the windows "
          f"starting {list(TJ_CPU_STARTS)} ms held against the CPU plain "
          f"run [{card}]")

    pts = tjoin_object_streams(chunks)
    obj_launches = 0
    for method, streams in (("run", pts), ("run_single", pts[:1])):
        join_extract.launches = 0
        g, o_secs = run_objects_family(gpu, ops.PointPointTJoinQuery, method,
                                       streams, TJ_R, op_kw={"cap": TJ_CAP})
        launched = join_extract.launches
        obj_launches += launched
        if len(g) != 2 or launched < 2 or not all(x[3] for x in g):
            raise AssertionError(
                f"tJoin {method}: pairs {[len(x[3]) for x in g]}, "
                f"{launched} B3 launches")
        print(f"e2e tJoin {method} (Point objects, 2 windows of {T_CUT} a "
              f"side): trajectory pairs {[len(x[3]) for x in g]} in "
              f"{o_secs:.6f} s; launches join_extract={launched}; held "
              f"against the CPU run [{card}]")

        def held(g=g, method=method, streams=streams):
            w, c_secs = twin(f"tjoin_{method}", streams)
            if g != w:
                raise AssertionError(f"tJoin {method}: differs from the CPU "
                                     f"run")
            print(f"exact tJoin {method}: equal to the CPU run "
                  f"({c_secs:.3f} s) [{card}]")
        later(held)
    return launches + obj_launches, got, secs, chunks


def time_tjoin(dev, card, got, secs, chunks):
    """Phase 23's parts: B3 and the dedup at one full window's shape
    beside B3's bound and plain version, the host SoA assembly, and a
    profiler pass over the run. Returns B3's timing row."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration
    from spatialflink_tpu_torch.operators.base import soa_point_batches
    from spatialflink_tpu_torch.operators.trajectory import _local_ranks
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )
    from spatialflink_tpu_torch.ops.trajectory import traj_pair_dedup_kernel

    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=TJ_WINDOW_S,
                              slide_step=TJ_WINDOW_S)
    sides = [next(soa_point_batches(grid, c, conf)) for c in chunks]
    t0 = time.perf_counter()
    for c in chunks:
        for _ in soa_point_batches(grid, c, QueryConfiguration(
                window_size=TJ_WINDOW_S, slide_step=1.0)):
            pass
    asm_secs = time.perf_counter() - t0
    lanes = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
             for s in sides for a in s[1:4]]
    planes, over = join_planes(*lanes, grid_n=grid.n, layers=1,
                               cap_left=TJ_CAP, cap_right=TJ_CAP)
    b3 = (*planes, grid.n, 1, TJ_R, TJ_MAX_PAIRS)
    res = join_extract_cuda(*b3)
    count = int(res[3])
    b3_ms, b3_call = time_ms(lambda: join_extract_cuda(*b3))
    b3_plain, _ = time_ms(lambda: join_extract_plain(*b3))
    host = [(s[1], None, s[3]) for s in sides]
    tests = join_candidate_pairs(grid, *host, cap=TJ_CAP)
    b3_bytes = sum(t.numel() * t.element_size() for t in planes) \
        + 12 * TJ_MAX_PAIRS + 4
    b3_bound, b3_by = bound_ms(b3_bytes, 6 * tests)
    ranks = [_local_ranks(s[4], s[0].count) for s in sides]
    l_loc, r_loc = (torch.from_numpy(r[1]).to(dev) for r in ranks)
    num_l, num_r = ranks[0][2], ranks[1][2]
    tp = traj_pair_dedup_kernel(*res[:3], l_loc, r_loc, num_l, num_r,
                                65_536)
    dd_ms, dd_call = time_ms(lambda: traj_pair_dedup_kernel(
        *res[:3], l_loc, r_loc, num_l, num_r, 65_536))
    t0 = time.perf_counter()
    for _ in range(10):
        for s in sides:
            _local_ranks(s[4], s[0].count)
    rank_ms = (time.perf_counter() - t0) * 1e3 / 10
    n_win = len(got)
    print(f"time tJoin window parts (the window starting 0: "
          f"{sides[0][0].count} and {sides[1][0].count} points, {count} "
          f"point pairs, {int(tp.count)} trajectory pairs, bucket overflow "
          f"{int(over)}): B3 join_extract {b3_ms:.6f} ms device "
          f"({b3_call:.6f} ms per call), plain PyTorch {b3_plain:.6f} ms, "
          f"bound {b3_bound:.6f} ms ({b3_by}: {b3_bytes} B, {tests} "
          f"candidate pair tests x 6 operations); the dedup "
          f"(traj_pair_dedup_kernel, {num_l} x {num_r} keys) {dd_ms:.6f} ms "
          f"device ({dd_call:.6f} ms per call); host np.unique relabel "
          f"{rank_ms:.6f} ms a window; host SoA assembly of both streams "
          f"{asm_secs:.6f} s, {100 * asm_secs / secs:.1f}% of the run_soa "
          f"wall ({1e3 * secs / n_win:.6f} ms a window) [{card}]")
    profile_run(lambda: run_tjoin_soa("cuda", chunks), card,
                "tJoin run_soa")
    return {"ms": b3_ms, "per_call_ms": b3_call, "plain_ms": b3_plain,
            "bound_ms": b3_bound, "bound_by": b3_by,
            "dedup_ms": dd_ms}


def tstats_stream():
    """bench_tstats_pane's stream (bench_suite.py:1251-1257, seed 17)."""
    rng = np.random.default_rng(17)
    ts = np.sort(rng.integers(0, TS_SPAN_MS, TS_POINTS)).astype(np.int64)
    xy = np.stack([rng.uniform(115.5, 117.6, TS_POINTS),
                   rng.uniform(39.6, 41.1, TS_POINTS)], axis=1)
    oid = rng.integers(0, TS_IDS, TS_POINTS).astype(np.int64)
    return ts, xy, oid


def check_pane_windows(got, want, bound, label):
    if not (np.array_equal(got.starts, want.starts)
            and np.array_equal(got.count, want.count)
            and np.array_equal(got.temporal, want.temporal)
            and got.spatial.shape == want.spatial.shape):
        raise AssertionError(f"{label}: starts, counts or temporal sums "
                             f"differ")
    err = np.abs(got.spatial.astype(np.float64) - want.spatial)
    if not np.all(err <= bound[None, :]):
        raise AssertionError(f"{label}: spatial sums past the bound")
    return float(err.max()), float((err / np.maximum(bound, 1e-30)[None, :]
                                    ).max())


def check_tstats(dev, card, gpu="cuda"):
    """Phase 24: ``traj_stats_sliding``'s device engine on the card at
    bench_tstats_pane's shape, against the CPU run of the same engine and
    the numpy engine (counts and temporal sums exact, spatial sums within
    ``pane_spatial_bound``); ``PointTStatsQuery.run_soa`` on the same
    stream at 10 s / 1 s against the CPU (spatial within
    ``spatial_sum_bound``); ``run`` WindowBased, RealTime and CountBased
    on 20,000 ``Point``s. Returns seconds of the device engine."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointTStatsQuery,
        QueryConfiguration,
        QueryType,
    )
    from spatialflink_tpu_torch.ops.trajectory import (
        spatial_sum_bound,
        traj_stats_pane_kernel,
    )
    from spatialflink_tpu_torch.streams.panes import (
        pane_operands,
        pane_spatial_bound,
        traj_stats_sliding,
    )

    t0 = time.perf_counter()
    ts, xy, oid = tstats_stream()
    print(f"data: {TS_POINTS} tStats points in {time.perf_counter() - t0:.3f}"
          f" s (host set-up)")
    args = (ts, xy, oid, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS)
    traj_stats_sliding(ts[:1000], xy[:1000], oid[:1000], TS_BUCKET,
                       TS_WINDOW_MS, TS_SLIDE_MS, backend="device", device=gpu)
    t0 = time.perf_counter()
    got = traj_stats_sliding(*args, backend="device", device=gpu)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = traj_stats_sliding(*args, backend="device", device="cpu")
    cpu_secs = time.perf_counter() - t0
    xy32 = xy.astype(np.float32).astype(np.float64)
    t0 = time.perf_counter()
    ref = traj_stats_sliding(ts, xy32, oid, TS_BUCKET, TS_WINDOW_MS,
                             TS_SLIDE_MS, backend="numpy")
    np_secs = time.perf_counter() - t0
    bound = pane_spatial_bound(*args)
    e_cpu = check_pane_windows(got, cpu, bound, "pane engine vs its CPU run")
    e_np = check_pane_windows(got, ref, bound, "pane engine vs numpy")
    ppw = TS_WINDOW_MS // TS_SLIDE_MS
    print(f"e2e traj_stats_sliding device engine (bench_tstats_pane: "
          f"{TS_POINTS} points, {TS_IDS} ids in a {TS_BUCKET} bucket, "
          f"{TS_WINDOW_MS} ms windows by {TS_SLIDE_MS} ms, ppw {ppw}): "
          f"{len(got.starts)} windows in {secs:.6f} s = "
          f"{TS_POINTS / secs:.1f} points/s; starts, counts and temporal "
          f"sums equal the CPU run ({cpu_secs:.3f} s) and the numpy engine "
          f"({np_secs:.3f} s on the host); spatial sums within "
          f"pane_spatial_bound (bound {bound.min():.6g}-{bound.max():.6g}): "
          f"max |err| {e_cpu[0]:.6g} vs the CPU run ({e_cpu[1]:.3g} of the "
          f"bound), {e_np[0]:.6g} vs numpy ({e_np[1]:.3g}) [{card}]")

    t0 = time.perf_counter()
    operands, p_lo, n_panes = pane_operands(ts, xy, oid, TS_BUCKET,
                                            TS_SLIDE_MS)
    host_ms = (time.perf_counter() - t0) * 1e3
    lanes = [torch.from_numpy(a).to(dev) for a in operands]
    statics = dict(num_oids=TS_BUCKET, slide_ms=TS_SLIDE_MS, ppw=ppw,
                   n_panes=n_panes)
    k_ms, k_call = time_ms(lambda: traj_stats_pane_kernel(*lanes, **statics))
    n_starts = n_panes + ppw - 1
    k_bytes = 17 * len(operands[0]) + 20 * TS_BUCKET * n_starts
    k_bound, k_by = bound_ms(k_bytes, 20 * len(operands[0])
                             + 8 * TS_BUCKET * n_starts)
    print(f"time pane engine parts: host sort, rebase and pad "
          f"{host_ms:.6f} ms; traj_stats_pane_kernel {k_ms:.6f} ms device "
          f"({k_call:.6f} ms per call; plain PyTorch, no hand kernel), bound "
          f"{k_bound:.6f} ms ({k_by}: {k_bytes} B) at {len(operands[0])} "
          f"lanes x {TS_BUCKET} oids x {n_starts} starts [{card}]")
    profile_run(lambda: traj_stats_sliding(*args, backend="device",
                                           device="cuda"), card,
                "traj_stats_sliding device engine")

    chunks = [{"ts": ts[s:s + 100_000], "x": xy[s:s + 100_000, 0],
               "y": xy[s:s + 100_000, 1], "oid": oid[s:s + 100_000]}
              for s in range(0, TS_POINTS, 100_000)]
    conf = QueryConfiguration(window_size=10.0, slide_step=1.0)
    outs = {}
    for d in (gpu, "cpu"):
        op = PointTStatsQuery(conf, UniformGrid(**BEIJING), device=d)
        t0 = time.perf_counter()
        outs[d] = (list(op.run_soa(chunks, TS_BUCKET)),
                   time.perf_counter() - t0)
    (g_soa, s_secs), (c_soa, c_secs) = outs[gpu], outs["cpu"]
    worst = 0.0
    for g, w in zip(g_soa, c_soa):
        b = spatial_sum_bound(g[4], np.maximum(g[2], w[2]))
        err = np.abs(g[2].astype(np.float64) - w[2])
        if g[0:2] != w[0:2] or not np.array_equal(g[3], w[3]) \
                or not np.array_equal(g[4], w[4]) or not np.all(err <= b):
            raise AssertionError(f"tStats run_soa: window {g[:2]} differs "
                                 f"from the CPU run")
        worst = max(worst, float(err.max()))
    if len(g_soa) != len(c_soa) or len(g_soa) != 39:
        raise AssertionError(f"tStats run_soa: {len(g_soa)} windows")
    print(f"e2e tStats run_soa (the same stream, 10 s windows by 1 s): "
          f"{len(g_soa)} windows, {TS_POINTS} points in {s_secs:.6f} s = "
          f"{TS_POINTS / s_secs:.1f} points/s; counts and temporal sums "
          f"equal the CPU run ({c_secs:.3f} s), spatial within "
          f"spatial_sum_bound, max |err| {worst:.6g} [{card}]")

    pts = [p for p in traj_points(
        [{"x": xy[:, 0], "y": xy[:, 1], "oid": oid}], 2 * T_CUT, T_CUT, "t")]
    for label, kw in (("WindowBased", {}),
                      ("RealTime", {"query_type": QueryType.RealTime,
                                    "realtime_batch_ms": 100}),
                      ("CountBased", {"query_type": QueryType.CountBased,
                                      "count_window_size": 5_000})):
        g, o_secs = run_objects_family(gpu, PointTStatsQuery, "run", [pts],
                                       **kw)
        w, w_secs = run_objects_family("cpu", PointTStatsQuery, "run", [pts],
                                       **kw)
        ok = [x[:3] for x in g] == [x[:3] for x in w] and len(g) >= 2
        for a, b in zip(g, w):
            ok = ok and a[3].keys() == b[3].keys() and all(
                a[3][k][1] == b[3][k][1] and abs(a[3][k][0] - b[3][k][0])
                <= spatial_sum_bound(a[2], max(a[3][k][0], b[3][k][0]))
                for k in a[3])
        if not ok:
            raise AssertionError(f"tStats run {label} differs from the CPU "
                                 f"run")
        print(f"e2e tStats run {label} (2 x {T_CUT} Point objects): "
              f"{len(g)} windows in {o_secs:.6f} s; equal to the CPU run "
              f"({w_secs:.3f} s), spatial within spatial_sum_bound [{card}]")
    return secs


def traj_soa(device, cls, chunks, *args, window=1.0, slide=1.0, **op_kw):
    """One ``run_soa`` of a trajectory operator; returns (windows,
    seconds)."""
    import torch

    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.grid import UniformGrid

    op = cls(ops.QueryConfiguration(window_size=window, slide_step=slide),
             UniformGrid(**BEIJING), device=device, **op_kw)
    t0 = time.perf_counter()
    out = list(op.run_soa(chunks, *args))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def check_traj_families(card, gpu="cuda"):
    """Phase 25: tRange ``run_soa`` on config 3's stream against 32
    polygons, tKnn, tAggregate (SUM) and tFilter ``run_soa`` on config
    2's stream; the other aggregates, the inactive threshold and ``run``
    on ``Point``s at 2 x 20,000; each against its CPU run. Returns the
    e2e rates."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.models.objects import Point

    soa = traj_soa

    def same(a, b):
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if hasattr(a, "cells"):
            return (a.start, a.end, a.window_count, a.cells) == \
                (b.start, b.end, b.window_count, b.cells)
        return a == b

    def case(label, cls, chunks, *args, n, twin_name=None, **kw):
        g, secs = soa(gpu, cls, chunks, *args, **kw)
        if not g:
            raise AssertionError(f"{label}: no window")
        if twin_name is not None:
            print(f"e2e {label}: {len(g)} windows, {n} points in {secs:.6f} "
                  f"s = {n / secs:.1f} points/s; held against the CPU run "
                  f"[{card}]")

            def held():
                w, c_secs = twin(twin_name, chunks)
                if not same(g, w):
                    raise AssertionError(f"{label} differs from the CPU run")
                print(f"exact {label}: equal to the CPU run ({c_secs:.3f} "
                      f"s) [{card}]")
            later(held)
            return g, n / secs
        w, c_secs = soa("cpu", cls, chunks, *args, **kw)
        if not same(g, w):
            raise AssertionError(f"{label} differs from the CPU run")
        print(f"e2e {label}: {len(g)} windows, {n} points in {secs:.6f} s = "
              f"{n / secs:.1f} points/s; equal to the CPU run "
              f"({c_secs:.3f} s) [{card}]")
        return g, n / secs

    rates = {}
    polys = range_polygons()[:TR_QUERIES]
    rchunks = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)
    rng = np.random.default_rng(77)
    for c in rchunks:
        c["oid"] = rng.integers(0, TR_IDS, len(c["ts"])).astype(np.int32)
    g, rates["tRange run_soa"] = case(
        f"tRange run_soa (config 3's stream: {RANGE_WINDOWS} windows of "
        f"{RANGE_WIN}, {TR_IDS} ids; {TR_QUERIES} polygons of config 3)",
        ops.PointPolygonTRangeQuery, rchunks, polys, TR_IDS,
        n=RANGE_WINDOWS * RANGE_WIN)
    hits = [len(x[2]) for x in g]
    if min(hits) == 0:
        raise AssertionError(f"tRange run_soa: hits {hits}")
    print(f"  tRange hit trajectories per window {hits}")

    pchunks = pane_chunks()
    n2 = PANES * PANE_PTS
    q = Point(x=QUERY[0], y=QUERY[1])
    g, rates["tKnn run_soa"] = case(
        f"tKnn run_soa (config 2: {PANES} panes of {PANE_PTS}, "
        f"{PANE_WINDOW_S:g} s windows by 1 s, k={PANE_K}, r={PANE_R})",
        ops.PointPointTKNNQuery, pchunks, q, PANE_R, PANE_K, NUM_SEGMENTS,
        n=n2, window=PANE_WINDOW_S)
    if min(x[4] for x in g) < PANE_K:
        raise AssertionError("tKnn run_soa: a window short of k")
    g, rates["tAggregate run_soa"] = case(
        "tAggregate run_soa SUM (config 2's stream, 5 s by 1 s)",
        ops.PointTAggregateQuery, pchunks, n=n2, window=PANE_WINDOW_S,
        aggregate="SUM", twin_name="tagg_sum")
    print(f"  tAggregate cells in the last window: {len(g[-1].cells)}")
    g, rates["tFilter run_soa"] = case(
        f"tFilter run_soa (config 2's stream, {TF_IDS} ids)",
        ops.PointTFilterQuery, pchunks, list(range(TF_IDS)), n=n2,
        window=PANE_WINDOW_S)

    cut = [{k: v[:2 * T_CUT] for k, v in pchunks[0].items()}]
    cut[0]["ts"] = (np.arange(2 * T_CUT, dtype=np.int64) * 1000) // T_CUT
    for mode, kw in (("ALL", {}), ("AVG", {}), ("MIN", {}), ("MAX", {}),
                     ("ALL, inactive 500 ms",
                      {"inactive_threshold_ms": 500})):
        case(f"tAggregate run_soa {mode} (2 x {T_CUT})",
             ops.PointTAggregateQuery, cut, n=2 * T_CUT,
             aggregate=mode.split(",")[0], **kw)

    pts = traj_points(pchunks, 2 * T_CUT, T_CUT, "o")
    for label, cls, args, op_kw in (
            ("tRange", ops.PointPolygonTRangeQuery, (polys,), {}),
            ("tKnn", ops.PointPointTKNNQuery, (q, PANE_R, PANE_K), {}),
            ("tAggregate SUM", ops.PointTAggregateQuery, (), {}),
            ("tFilter", ops.PointTFilterQuery,
             ([f"o{i}" for i in range(TF_IDS)],), {})):
        g, o_secs = run_objects_family(gpu, cls, "run", [pts], *args,
                                       op_kw=op_kw)
        w, c_secs = run_objects_family("cpu", cls, "run", [pts], *args,
                                       op_kw=op_kw)
        if g != w or len(g) != 2 or not all(x[3] for x in g):
            raise AssertionError(f"{label} run differs from the CPU run")
        print(f"e2e {label} run (2 x {T_CUT} Point objects): results "
              f"{[len(x[3]) for x in g]} in {o_secs:.6f} s; equal to the CPU "
              f"run ({c_secs:.3f} s) [{card}]")
    profile_run(lambda: soa("cuda", ops.PointPolygonTRangeQuery, rchunks,
                            polys, TR_IDS), card, "tRange run_soa")
    return rates


def tpanes_stream():
    """bench_tjoin_panes' two streams (bench_suite.py:1104-1112, seed 23:
    x, y and the ids of the left side, then the right's), in chunks of 100
    panes; pane p's points at ts in [10p, 10p + 10) ms."""
    rng = np.random.default_rng(23)
    n = TP_PANES * TP_PANE_PTS
    ts = (np.arange(n, dtype=np.int64) * TP_SLIDE_MS) // TP_PANE_PTS
    per = 100 * TP_PANE_PTS
    sides = []
    for _ in range(2):
        x = rng.uniform(115.5, 117.6, n)
        y = rng.uniform(39.6, 41.1, n)
        oid = rng.integers(0, TP_IDS, n).astype(np.int32)
        sides.append([{"ts": ts[i:i + per], "x": x[i:i + per],
                       "y": y[i:i + per], "oid": oid[i:i + per]}
                      for i in range(0, n, per)])
    return sides


def tpanes_cut(chunks, panes):
    """Each side of ``tpanes_stream`` cut to its first ``panes`` panes,
    as one chunk (a cut may reach past the first chunk of 100)."""
    n = panes * TP_PANE_PTS
    return [[{k: np.concatenate([c[k] for c in side])[:n] for k in side[0]}]
            for side in chunks]


def tpanes_columns(chunks):
    """Each side's chunks as whole (ts, x, y, oid) columns."""
    return [[np.concatenate([c[k] for c in side])
             for k in ("ts", "x", "y", "oid")] for side in chunks]


def tjoin_panes_cpu(cols):
    """Phase 26's engine run on the CPU over the stream cut to its first
    ``TP_CPU_PANES`` panes: every window ending before that pane. Returns
    (the windows' (K²,) minima rows, seconds, overflow counters, cap_c)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.trajectory import tjoin_pane_fields
    from spatialflink_tpu_torch.ops import tjoin_panes as tp
    from spatialflink_tpu_torch.ops.compaction import (
        max_window_cell_count,
        pick_capacity,
    )

    grid = UniformGrid(**BEIJING)
    m = TP_CPU_PANES
    keep = [c[0] < m * TP_SLIDE_MS for c in cols]
    t0 = time.perf_counter()
    cpu_fields = [tjoin_pane_fields(grid, *(a[k] for a in c),
                                    TP_SLIDE_MS, 0, m)
                  for c, k in zip(cols, keep)]
    cpu_cap = pick_capacity(max(max_window_cell_count(*f[2], TP_PPW)
                                for f in cpu_fields), TP_CAP_W)
    cc, cw = tp.tjoin_pane_scan(
        tp.tjoin_pane_init(grid.num_cells, TP_CAP_W, TP_PPW, TP_IDS,
                           device="cpu"), range(m),
        *(tuple(torch.from_numpy(a) for a in f[0]) for f in cpu_fields),
        TP_R, grid.n, TP_CAP_W, grid.candidate_layers(TP_R), TP_PPW, TP_IDS,
        TP_PAIR_SEL, cpu_cap)
    secs = time.perf_counter() - t0
    return (cw.numpy(), secs, [int(cc.cap_overflow), int(cc.sel_overflow),
                               int(cc.cmp_overflow)], cpu_cap)


def run_tjoin_panes(device, chunks, backend="device"):
    """``PointPointTJoinQuery.run_soa_panes`` at phase 26's configuration,
    the device engine unless ``backend`` says otherwise (on the CPU
    ``"auto"`` would take the native engine); returns the windows,
    seconds (the device synchronised) and the operator."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=TP_PPW * TP_SLIDE_MS / 1000,
                              slide_step=TP_SLIDE_MS / 1000)
    op = PointPointTJoinQuery(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    out = list(op.run_soa_panes(chunks[0], chunks[1], TP_R, TP_IDS,
                                cap_w=TP_CAP_W, pair_sel=TP_PAIR_SEL,
                                backend=backend))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, op


def pane_window(s, row):
    """The operator's window tuple of slide ``s`` from its (K²,) minima
    row (``run_soa_panes``' decode; panes rebased to 0)."""
    start = (s - TP_PPW + 1) * TP_SLIDE_MS
    hit = np.flatnonzero(np.isfinite(row))
    return (start, start + TP_PPW * TP_SLIDE_MS,
            (hit // TP_IDS).astype(np.int32), (hit % TP_IDS).astype(np.int32),
            row[hit].astype(np.float64), int(len(hit)), 0)


def same_window(a, b) -> bool:
    """Starts, ends, counts and overflow equal, id arrays equal in order,
    distances bit-equal (as float32 when one side is float32)."""
    da, db = np.asarray(a[4]), np.asarray(b[4])
    if da.dtype != db.dtype:
        da, db = da.astype(np.float32), db.astype(np.float32)
    return (a[0:2] == b[0:2] and a[5:] == b[5:]
            and np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3])
            and da.tobytes() == db.tobytes())


def check_tjoin_panes(dev, card, gpu="cuda"):
    """Phase 26: ``run_soa_panes`` at tjoin_panes_10s_10ms on the card;
    its host steps, the engine's steady state and its parts timed; the
    windows held against the engine's CPU run over a cut, ``run_soa``
    (B3) and the segmented pipelined scan. Returns the e2e seconds."""
    import torch

    from spatialflink_tpu_torch import pipeline
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.operators.base import ship
    from spatialflink_tpu_torch.operators.trajectory import tjoin_pane_fields
    from spatialflink_tpu_torch.ops import tjoin_panes as tp
    from spatialflink_tpu_torch.ops.compaction import (
        max_window_cell_count,
        pick_capacity,
    )

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    chunks = tpanes_stream()
    print(f"data: 2 x {TP_PANES} x {TP_PANE_PTS} pane-carry tJoin points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    grid = UniformGrid(**BEIJING)
    layers = grid.candidate_layers(TP_R)
    n_slides = TP_PANES + TP_PPW - 1
    n_pts = 2 * TP_PANES * TP_PANE_PTS

    # 1. The operator end to end on the card, after the segmented
    # pipelined scan of the stream's first TP_TRACE_PANES panes (it takes
    # the one-time costs of the first launches out of the timed run). The
    # cut's first TP_TRACE_PANES windows are the whole stream's; all of
    # them are held to the one scan of the cut below.
    cut = tpanes_cut(chunks, TP_TRACE_PANES)
    pipeline.install(pipeline.PipelinePolicy(depth=TP_SEG_DEPTH))
    try:
        seg, seg_secs, _ = run_tjoin_panes(gpu, cut)
    finally:
        pipeline.uninstall()
    got, secs, op = run_tjoin_panes(gpu, chunks)
    if not all(same_window(a, b) for a, b in zip(
            seg[:TP_TRACE_PANES], got)):
        raise AssertionError("run_soa_panes: the segmented pipelined scan "
                             "of a cut stream differs from the one scan "
                             "of the whole stream")
    scans, occ = op.pane_scans, op.pane_occupancy
    cap_c = scans[0][2]
    by_start = {w[0]: w for w in got}
    last_full = by_start[(TP_PANES - TP_PPW) * TP_SLIDE_MS]
    if len(got) != n_slides or len(scans) != 1 \
            or scans[0][3:] != (0, 0, 0) or cap_c != pick_capacity(
                occ, TP_CAP_W) or last_full[5] == 0:
        raise AssertionError(f"run_soa_panes: {len(got)} windows, scans "
                             f"{scans}, occupancy {occ}")
    for w in got:
        if len(w[2]) != w[5] or np.any(np.diff(
                w[2].astype(np.int64) * TP_IDS + w[3]) <= 0) \
                or not np.all(w[4] <= np.float32(TP_R)):
            raise AssertionError(f"run_soa_panes: window {w[:2]} malformed")
    print(f"e2e tJoin run_soa_panes (tjoin_panes_10s_10ms: 2 x {TP_PANES} "
          f"panes of {TP_PANE_PTS} points, {TP_PPW * TP_SLIDE_MS} ms windows "
          f"by {TP_SLIDE_MS} ms, ppw {TP_PPW}, {TP_IDS} ids, r={TP_R}, cap_w "
          f"{TP_CAP_W}, pair_sel {TP_PAIR_SEL}): {len(got)} windows fired, "
          f"one scan, overflow counters (cap, sel, cmp) {scans[0][3:]}; "
          f"capacity plan: occupancy {occ} -> cap_c {cap_c}; trajectory "
          f"pairs in the last full window (start {last_full[0]} ms) "
          f"{last_full[5]}; {n_pts} points in {secs:.6f} s = "
          f"{n_pts / secs:.1f} points/s, every window fetched (after the "
          f"segmented pipelined scan of the first {TP_TRACE_PANES} panes a "
          f"side, {len(seg)} windows in {seg_secs:.3f} s, its first "
          f"{TP_TRACE_PANES} equal to the one scan's) [{card}]")
    # The device's idle share over the operator run on the cut (a cut of
    # depth: the trace's cost grows with its kernels); its windows are
    # the reference for every window of the segmented pipelined scan:
    # its segment boundaries, the carry chained across them, the panes
    # copied on the side stream and those expiring from the whole stream.
    tr_slides = TP_TRACE_PANES + TP_PPW - 1
    traced = []
    tr_wall, tr_busy, tr_kern = trace_busy(
        lambda: traced.extend(run_tjoin_panes(gpu, cut)[0]))
    if len(seg) != tr_slides or len(traced) != tr_slides or not all(
            same_window(a, b) for a, b in zip(seg, traced)):
        raise AssertionError(f"run_soa_panes: the segmented pipelined scan "
                             f"of the first {TP_TRACE_PANES} panes differs "
                             f"from the one scan ({len(seg)} / "
                             f"{len(traced)} windows)")
    print(f"profile e2e run_soa_panes (the stream's first {TP_TRACE_PANES} "
          f"panes a side, {tr_slides} slides, CUDA activity): wall "
          f"{tr_wall:.6f} s traced, device busy "
          f"{tr_busy:.6f} s ({100 * tr_busy / tr_wall:.1f}%, idle "
          f"{100 - 100 * tr_busy / tr_wall:.1f}%), {tr_kern} kernels = "
          f"{tr_kern / tr_slides:.2f} a slide; its {len(traced)} windows "
          f"equal the segmented pipelined scan's (depth {TP_SEG_DEPTH}) "
          f"[{card}]")

    # Its host steps, timed alone.
    cols = tpanes_columns(chunks)
    t0 = time.perf_counter()
    fields = [tjoin_pane_fields(grid, *c, TP_SLIDE_MS, 0, n_slides)
              for c in cols]
    fields_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    plan_occ = max(max_window_cell_count(*f[2], TP_PPW) for f in fields)
    plan_cap = pick_capacity(plan_occ, TP_CAP_W)
    plan_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lf, rf = (ship(*f[0], device=dev).arrive() for f in fields)
    torch.cuda.synchronize()
    h2d_ms = (time.perf_counter() - t0) * 1e3
    h2d_bytes = sum(a.nbytes for f in fields for a in f[0])
    if (plan_occ, plan_cap) != (occ, cap_c):
        raise AssertionError(f"capacity plan {plan_occ}/{plan_cap} differs "
                             f"from the operator's {occ}/{cap_c}")
    print(f"time run_soa_panes host steps: pane fields (sort, pad, "
          f"pane_cell_ranks) of both sides {fields_ms:.6f} ms, capacity plan "
          f"(max_window_cell_count x 2) {plan_ms:.6f} ms, H2D of {h2d_bytes} "
          f"B {h2d_ms:.6f} ms; together "
          f"{(fields_ms + plan_ms + h2d_ms) / 10 / secs:.1f}% of the e2e "
          f"wall [{card}]")

    # 2. The engine alone: a warm scan of ppw slides, then the steady
    # state from that carry with the expiring panes passed explicitly.
    radius_args = (TP_R, grid.n, TP_CAP_W, layers, TP_PPW, TP_IDS,
                   TP_PAIR_SEL, cap_c)

    def part(f, lo, hi):
        return tuple(a[lo:hi] for a in f)

    warm = tp.tjoin_pane_init(grid.num_cells, TP_CAP_W, TP_PPW, TP_IDS,
                              device=dev)
    tp.tjoin_pane_scan(warm, range(TP_PPW), part(lf, 0, TP_PPW),
                       part(rf, 0, TP_PPW), *radius_args)
    expire = [(f[4][:TP_STEADY], f[7][:TP_STEADY]) for f in (lf, rf)]

    def clone(c):
        return tp.TJoinPaneCarry(*(a.clone() for a in c))

    def steady():
        c = clone(warm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c, w = tp.tjoin_pane_scan(
            c, range(TP_PPW, TP_PANES), part(lf, TP_PPW, TP_PANES),
            part(rf, TP_PPW, TP_PANES), *radius_args,
            lps_expire=expire[0], rps_expire=expire[1])
        counters = torch.stack([c.cap_overflow, c.sel_overflow,
                                c.cmp_overflow]).tolist()
        return time.perf_counter() - t0, counters, w

    _, counters, w = steady()
    rows = w.cpu().numpy()
    for i, row in enumerate(rows):
        if not same_window(pane_window(TP_PPW + i, row), got[TP_PPW + i]):
            raise AssertionError(f"steady scan: slide {TP_PPW + i} differs "
                                 f"from the operator's window")
    times = [steady()[0] for _ in range(TP_REPS)]
    eng = statistics.median(times)
    n_steady = 2 * TP_PANE_PTS * TP_STEADY
    if counters != [0, 0, 0]:
        raise AssertionError(f"steady scan overflowed: {counters}")

    # Its parts at one steady slide (t = ppw), each on its own carry copy.
    t = TP_PPW
    lp, rp = (tuple(a[t] for a in f) for f in (lf, rf))
    xs = (t, lp, rp, (lf[4][0], lf[7][0]), (rf[4][0], rf[7][0]))
    pc = clone(warm)
    probe_args = (TP_R, False, grid.n, TP_CAP_W, cap_c, layers, TP_PPW,
                  TP_IDS, TP_PAIR_SEL)

    def probe_a():
        return tp._probe_compact(pc.rwx, pc.rwy, pc.rwoid, pc.rwtag,
                                 pc.rwcur, pc.rwlive, lp[0], lp[1], lp[2],
                                 lp[3], lp[6], lp[7], *probe_args)

    def probe_b():
        return tp._probe_compact(pc.lwx, pc.lwy, pc.lwoid, pc.lwtag,
                                 pc.lwcur, pc.lwlive, rp[0], rp[1], rp[2],
                                 rp[3], rp[6], rp[7], TP_R, True,
                                 *probe_args[2:])

    flat, dist, _, _ = probe_a()
    p_ids = TP_IDS * TP_IDS
    bs = tp.block_size(TP_PPW)

    def scatters():
        bflat = torch.div(flat, p_ids * bs, rounding_mode="floor") * p_ids \
            + flat % p_ids
        pc.digests.scatter_reduce_(0, flat.long(), dist, "amin")
        pc.block_digests.scatter_reduce_(0, bflat.long(), dist, "amin")

    def insert():
        tp._insert(pc.lwx, pc.lwy, pc.lwoid, pc.lwtag, pc.lwcur, t, lp[0],
                   lp[1], lp[4], lp[5], lp[6], lp[7], TP_CAP_W, TP_PPW)

    dig = pc.digests[:-1].view(TP_PPW, p_ids)
    blk = pc.block_digests[:-1].view(TP_PPW // bs, p_ids)

    def reduce():
        dig[0].fill_(float("inf"))
        torch.amin(dig[0:bs], dim=0, out=blk[0])
        return torch.amin(blk, dim=0)

    parts = {name: time_ms(fn) for name, fn in (
        ("probe A (left pane x right window)", probe_a),
        ("probe B (right pane x left window)", probe_b),
        ("digest scatter-mins (one direction)", scatters),
        ("insert (one side)", insert), ("block reduce", reduce))}
    sc = clone(warm)
    step_ms = time_ms(lambda: tp.tjoin_pane_step(sc, xs, *radius_args))[1]
    kern, mems = launches_per_call(lambda: tp.tjoin_pane_step(
        sc, xs, *radius_args))
    # Whether a step waits for the device: torch warns at each
    # synchronising call in this mode.
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tp.tjoin_pane_step(sc, xs, *radius_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    lanes = TP_PANE_PTS * (2 * layers + 1) ** 2 * cap_c
    print(f"time pane engine alone (steady state: {TP_STEADY} slides after "
          f"a warm scan of {TP_PPW}, median of {TP_REPS}): "
          f"{eng:.6f} s = {n_steady / eng:.1f} points/s, "
          f"{1e3 * eng / TP_STEADY:.6f} ms a slide (host wall), scans "
          f"{', '.join(f'{x:.3f}' for x in times)} s; per slide: "
          + "; ".join(f"{k} {v[0]:.6f} ms device ({v[1]:.6f} ms per call)"
                      for k, v in parts.items())
          + f"; one whole step {step_ms:.6f} ms per call, {kern:g} kernel "
          f"launches and {mems:g} memsets, {syncs} host synchronisations; a "
          f"probe reads {lanes} lanes ({TP_PANE_PTS} points x "
          f"{(2 * layers + 1) ** 2} cells x cap_c {cap_c}) [{card}]")
    # The profiler's kernel rows over a short steady scan.
    pr = clone(warm)
    wall_ms, busy_ms = profile_run(
        lambda: tp.tjoin_pane_scan(
            pr, range(TP_PPW, TP_PPW + TP_PROFILE_SLIDES),
            part(lf, TP_PPW, TP_PPW + TP_PROFILE_SLIDES),
            part(rf, TP_PPW, TP_PPW + TP_PROFILE_SLIDES), *radius_args,
            lps_expire=[a[:TP_PROFILE_SLIDES] for a in expire[0]],
            rps_expire=[a[:TP_PROFILE_SLIDES] for a in expire[1]]),
        card, f"pane engine, {TP_PROFILE_SLIDES} steady slides")
    print(f"  steady engine: device busy {busy_ms / TP_PROFILE_SLIDES:.6f} "
          f"ms a slide of {wall_ms / TP_PROFILE_SLIDES:.6f} ms [{card}]")

    # 3a. The engine's CPU run of the stream cut to its first
    # TP_CPU_PANES panes: every window ending before that pane.
    m = TP_CPU_PANES

    def held(got=got[:m], cols=cols):
        cw, cpu_secs, cpu_counters, cpu_cap = twin("tjoin_panes", cols)
        if cpu_counters != [0, 0, 0] or not all(
                same_window(pane_window(s, cw[s]), got[s])
                for s in range(m)):
            raise AssertionError(f"run_soa_panes: the card's windows differ "
                                 f"from the CPU run of the first {m} panes "
                                 f"(counters {cpu_counters})")
        print(f"exact run_soa_panes: the card's windows equal the engine's "
              f"CPU run of the first {m} panes over all {m} windows ending "
              f"before pane {m} ({m - TP_PPW + 1} full; {cpu_secs:.3f} s on "
              f"the host CPU, cap_c {cpu_cap}) [{card}]")
    later(held)

    # 3b. run_soa through B3 on 10 s tumbling windows of the stream.
    soa_op = PointPointTJoinQuery(
        QueryConfiguration(window_size=TP_PPW * TP_SLIDE_MS / 1000,
                           slide_step=TP_PPW * TP_SLIDE_MS / 1000),
        grid, cap=cap_c, device=gpu)
    t0 = time.perf_counter()
    soa = list(soa_op.run_soa(chunks[0], chunks[1], TP_R, TP_IDS,
                              max_pairs=1 << 21))
    torch.cuda.synchronize()
    soa_secs = time.perf_counter() - t0
    starts = [w[0] for w in soa]
    if starts != [0, TP_PPW * TP_SLIDE_MS] or any(w[6] for w in soa) \
            or not all(same_window(by_start[w[0]], w[:6] + (0,))
                       for w in soa):
        raise AssertionError(f"run_soa_panes differs from run_soa at "
                             f"{starts} (overflow {[w[6] for w in soa]})")

    print(f"exact run_soa_panes: the card's windows held against the "
          f"engine's CPU run of the first {m} panes, equal to run_soa "
          f"through B3 at the windows starting {starts} ms (10 s "
          f"tumbling, cap {cap_c}, overflow 0, pairs "
          f"{[w[5] for w in soa]}, {soa_secs:.3f} s) and, over all "
          f"{tr_slides} windows of the first {TP_TRACE_PANES} panes, to "
          f"the segmented pipelined scan; ids in order, distance bits "
          f"[{card}]")
    print(f"phase 26 wall: {time.perf_counter() - t_phase:.3f} s [{card}]")
    return secs


# ---------------------------------------------------------------------------
# Phases 27-28: ingest (serde, sources, shapefile, CRS) and the apps.


class CsvChunkParser:
    """``oid,ts,x,y`` lines → a SoA chunk, through numpy's text reader:
    phase 27's cross-check of the native parser (``native.py:
    NativePointParser``) on the same file."""

    def parse(self, block: bytes):
        import io

        rows = np.loadtxt(io.BytesIO(block), delimiter=",",
                          dtype=np.float64, ndmin=2)
        return {"oid": rows[:, 0].astype(np.int32),
                "ts": rows[:, 1].astype(np.int64),
                "x": np.ascontiguousarray(rows[:, 2]),
                "y": np.ascontiguousarray(rows[:, 3])}


class TimedParser:
    """A chunk parser that adds up the seconds spent in its ``parse`` and
    keeps the chunks it returned, so a run's parse share and its parsed
    stream come from that run itself."""

    def __init__(self, parser):
        self.parser, self.secs, self.chunks = parser, 0.0, []

    def parse(self, block: bytes):
        t0 = time.perf_counter()
        out = self.parser.parse(block)
        self.secs += time.perf_counter() - t0
        self.chunks.append(out)
        return out


def write_csv_points(path, chunks):
    """The stream as ``oid,ts,x,y`` lines in ``to_csv_point``'s format
    (``repr`` coordinates), oids ``i % TR_IDS``; a sample of the lines is
    checked against ``to_csv_point`` itself. Returns the line count."""
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.streams.serde import to_csv_point

    ts = np.concatenate([c["ts"] for c in chunks])
    x = np.concatenate([c["x"] for c in chunks]).astype(np.float64)
    y = np.concatenate([c["y"] for c in chunks]).astype(np.float64)
    oid = np.arange(len(ts)) % TR_IDS
    cols = (list(map(str, oid.tolist())), list(map(str, ts.tolist())),
            list(map(repr, x.tolist())), list(map(repr, y.tolist())))
    lines = list(map(",".join, zip(*cols)))
    for i in list(range(1000)) + list(range(len(lines) - 1000, len(lines))):
        want = to_csv_point(Point(obj_id=str(oid[i]), timestamp=int(ts[i]),
                                  x=float(x[i]), y=float(y[i])))
        if lines[i] != want:
            raise AssertionError(f"CSV line {i}: {lines[i]!r} != {want!r}")
    with open(path, "w") as f:
        f.write("\n".join(lines))
        f.write("\n")
    return len(lines)


def same_points_windows(got, want, label, keys=("ts", "x", "y")):
    """run_soa windows of two runs of one stream: starts, ends, matched
    ts/x/y values and distance bits equal. Returns matches a window."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{label}: {len(got)} windows vs {len(want)}")
    for g, w in zip(got, want):
        if g[:2] != w[:2]:
            raise AssertionError(f"{label}: window {g[:2]} vs {w[:2]}")
        for k in keys:
            if not np.array_equal(np.asarray(g[2][k], np.float64),
                                  np.asarray(w[2][k], np.float64)):
                raise AssertionError(f"{label}: {k} differs in {g[:2]}")
        if not np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32)):
            raise AssertionError(f"{label}: distances differ in {g[:2]}")
    return [len(g[3]) for g in got]


def range_run_windows(device, stream, queries, radius=RANGE_R):
    """One ``PointPolygonRangeQuery.run`` (1 s tumbling) over Point
    objects: the windows as (start, end, window count, matched (id, ts,
    x, y), distance bits), and seconds."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPolygonRangeQuery,
        QueryConfiguration,
    )

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PointPolygonRangeQuery(conf, UniformGrid(**BEIJING), device=device)
    t0 = time.perf_counter()
    res = list(op.run(iter(stream), queries, radius))
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return [(r.start, r.end, r.window_count,
             [(o.obj_id, o.timestamp, o.x, o.y) for o in r.objects],
             np.asarray(r.dists, np.float32).view(np.uint32).tolist())
            for r in res], secs


def same_rings(got, want, label, reverse=False):
    """Polygons read back: one ring each, bit-equal to the generated ring
    (reversed where the file stores it clockwise)."""
    if len(got) != len(want):
        raise AssertionError(f"{label}: {len(got)} polygons read back")
    for g, w in zip(got, want):
        ring = w.rings[0][::-1] if reverse else w.rings[0]
        if len(g.rings) != 1 or not np.array_equal(
                g.rings[0].view(np.uint64), ring.view(np.uint64)):
            raise AssertionError(f"{label}: polygon {w.obj_id} differs")


def check_ingest(card, gpu="cuda"):
    """Phase 27: config 3 read back from files through the port's serde,
    shapefile and sources into the range operators on the card, against
    the arrays fed directly and the CPU; the synthetic GPS source into
    ``run``; the CRS transforms and haversine at 1M points. Returns (B4
    launches, the synthetic stream's Points)."""
    import tempfile

    import torch

    from spatialflink_tpu_torch.operators import PointPolygonRangeQuery
    from spatialflink_tpu_torch.ops.distances import haversine_distance
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.streams.deserialization import (
        polygon_stream,
        to_output_record,
    )
    from spatialflink_tpu_torch.streams.serde import (
        parse_csv_point,
        to_csv_point,
        to_geojson,
    )
    from spatialflink_tpu_torch.streams.shapefile import (
        read_shapefile,
        write_shapefile,
    )
    from spatialflink_tpu_torch.streams.soa import csv_chunk_source
    from spatialflink_tpu_torch.streams.sources import (
        SyntheticGpsSource,
        csv_source,
    )
    from spatialflink_tpu_torch.utils import crs

    t_phase = time.perf_counter()
    polys = range_polygons()
    chunks = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)
    n_pts = RANGE_WINDOWS * RANGE_WIN
    launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        # Polygons: three files, read back.
        t0 = time.perf_counter()
        paths = {k: f"{tmp}/polygons.{k}" for k in ("geojson", "wkt", "shp")}
        with open(paths["geojson"], "w") as f:
            f.write("\n".join(to_geojson(p) for p in polys) + "\n")
        with open(paths["wkt"], "w") as f:
            f.write("\n".join(to_output_record(p, "WKT") for p in polys)
                    + "\n")
        write_shapefile(paths["shp"], polys)
        with open(paths["geojson"]) as f:
            from_geojson = list(polygon_stream(f))
        with open(paths["wkt"]) as f:
            from_wkt = list(polygon_stream(f, input_type="WKT"))
        from_shp = list(read_shapefile(paths["shp"]))
        poly_secs = time.perf_counter() - t0
        same_rings(from_geojson, polys, "GeoJSON polygons")
        same_rings(from_shp, polys, "shapefile polygons", reverse=True)
        if [p.obj_id for p in from_geojson] != [p.obj_id for p in polys] \
                or [p.obj_id for p in from_shp] != \
                [str(i + 1) for i in range(len(polys))]:
            raise AssertionError("polygon ids differ")
        wkt_err = max(float(np.abs(w.rings[0] - p.rings[0]).max())
                      for w, p in zip(from_wkt, polys))
        print(f"ingest polygons: {len(polys)} written and read back as "
              f"GeoJSON lines, WKT lines and a shapefile in {poly_secs:.3f} "
              f"s; GeoJSON rings bit-equal to the generated ones, shapefile "
              f"rings bit-equal reversed (clockwise exteriors), WKT rings "
              f"within {wkt_err:.3g} deg (six significant digits) [{card}]")

        # The CSV stream through csv_chunk_source into run_soa.
        t0 = time.perf_counter()
        csv_path = f"{tmp}/points.csv"
        n_lines = write_csv_points(csv_path, chunks)
        print(f"data: {n_lines} CSV lines written in "
              f"{time.perf_counter() - t0:.3f} s (host set-up)")
        conf_kw = dict(window_size=1.0, slide_step=1.0)
        from spatialflink_tpu_torch.grid import UniformGrid
        from spatialflink_tpu_torch.operators import QueryConfiguration

        op = PointPolygonRangeQuery(QueryConfiguration(**conf_kw),
                                    UniformGrid(**BEIJING), device=gpu)
        from spatialflink_tpu_torch import native

        if not native.available():
            raise AssertionError("27: the native library did not build or "
                                 "failed its ABI check")
        polyline_min_dist.launches = 0
        parser, got = TimedParser(native.NativePointParser()), []
        # One run, timed and traced: the wall, the device's idle share and
        # the seconds inside parse() all come from it.
        csv_ms, _ = profile_run(lambda: got.extend(op.run_soa(
            csv_chunk_source(csv_path, parser), from_geojson, RANGE_R)),
            card, "ingest CSV -> run_soa")
        csv_secs = csv_ms / 1e3
        csv_launches = polyline_min_dist.launches
        launches += csv_launches
        parsed = parser.chunks
        # The numpy parser on the same file: ts, x and y bit-equal, the
        # oids equal through the native interner's names.
        np_parser = TimedParser(CsvChunkParser())
        for _ in csv_chunk_source(csv_path, np_parser):
            pass
        names = np.asarray([int(parser.parser.object_name(i)) for i in
                            range(parser.parser.num_objects)], np.int64)
        for k in ("ts", "x", "y", "oid"):
            a = np.concatenate([c[k] for c in parsed])
            b = np.concatenate([c[k] for c in np_parser.chunks])
            if k == "oid":
                a = names[a]
            if a.shape != b.shape or not np.array_equal(
                    a.astype(b.dtype).view(np.uint8), b.view(np.uint8)):
                raise AssertionError(f"27: the native parser's {k} differs "
                                     f"from the numpy parser's")
        direct, direct_secs, _ = run_range(gpu, PointPolygonRangeQuery,
                                           chunks, polys, RANGE_R)
        hits = same_points_windows(got, direct, "CSV run_soa vs arrays")
        cut = [{k: v[c["ts"] < 1000 * INGEST_CPU_WINDOWS]
                for k, v in c.items()} for c in parsed]
        want, cpu_secs, _ = run_range(
            "cpu", PointPolygonRangeQuery, [c for c in cut if len(c["ts"])],
            from_geojson, RANGE_R)
        same_points_windows(got[:INGEST_CPU_WINDOWS], want,
                            "CSV run_soa vs CPU", keys=("ts", "x", "y", "oid"))
        if len(got) != RANGE_WINDOWS or csv_launches < RANGE_WINDOWS \
                or min(hits) == 0:
            raise AssertionError(f"CSV run_soa: {len(got)} windows, "
                                 f"{csv_launches} B4 launches")
        print(f"e2e ingest CSV -> run_soa (config 3, {len(parsed)} chunks "
              f"of ~4 MiB): {len(got)} windows, matches {hits}, {n_pts} "
              f"points from file to fetched results in {csv_secs:.6f} s = "
              f"{n_pts / csv_secs:.1f} points/s (one run, under "
              f"torch.profiler); inside the native parser "
              f"(NativePointParser) {parser.secs:.6f} s of it "
              f"({100 * parser.secs / csv_secs:.1f}% of the wall; with the "
              f"numpy parser it was 65.4% of the wall, PERF.md's earlier "
              f"runs; the numpy parser takes {np_parser.secs:.6f} s on the "
              f"same file here, every column equal); the same "
              f"stream from arrays {direct_secs:.6f} s = "
              f"{n_pts / direct_secs:.1f} points/s; launches "
              f"polyline_min_dist={csv_launches}; every window bit-equal to "
              f"the arrays' run, the first {INGEST_CPU_WINDOWS} to the CPU "
              f"run ({cpu_secs:.3f} s on the host CPU) [{card}]")

        # The GeoJSON-read polygons as a stream through
        # PolygonPolygonRangeQuery.run, against shapefile-read queries.
        polyline_min_dist.launches = 0
        g, g_secs = run_geometry_objects(gpu, from_geojson,
                                         from_shp[:GEOM_QUERIES])
        pp_launches = polyline_min_dist.launches
        launches += pp_launches
        w, w_secs = run_geometry_objects("cpu", from_geojson,
                                         from_shp[:GEOM_QUERIES])
        if g != w or not g or pp_launches < len(g) \
                or sum(len(x[3]) for x in g) < GEOM_QUERIES:
            raise AssertionError("GeoJSON polygons' run differs from the CPU "
                                 "run")
        print(f"e2e ingest GeoJSON polygons -> PolygonPolygonRangeQuery.run "
              f"({len(from_geojson)} polygons against the first "
              f"{GEOM_QUERIES} shapefile-read ones, r={GEOM_R}): {len(g)} "
              f"windows, matches {[len(x[3]) for x in g]} in {g_secs:.6f} s; "
              f"launches polyline_min_dist={pp_launches}; equal to the CPU "
              f"run ({w_secs:.3f} s) [{card}]")

        # csv_source into run, against the WKT-read polygons.
        stream = range_objects(RANGE_OBJ_WINDOWS, RANGE_OBJ_POINTS, 9)
        obj_path = f"{tmp}/objects.csv"
        with open(obj_path, "w") as f:
            f.write("oid,ts,x,y\n")
            f.write("\n".join(to_csv_point(p) for p in stream) + "\n")
            f.write("a,not-a-time,1,2\nbroken line\n")
        t0 = time.perf_counter()
        read = list(csv_source(obj_path, functools.partial(
            parse_csv_point, strict=True), skip_header=True))
        read_secs = time.perf_counter() - t0
        if [(p.obj_id, p.timestamp, p.x, p.y) for p in read] != \
                [(p.obj_id, p.timestamp, p.x, p.y) for p in stream]:
            raise AssertionError("csv_source points differ from the written")
        polyline_min_dist.launches = 0
        g, g_secs = range_run_windows(gpu, read, from_wkt)
        run_launches = polyline_min_dist.launches
        launches += run_launches
        w, w_secs = range_run_windows("cpu", read, from_wkt)
        if g != w or len(g) != RANGE_OBJ_WINDOWS or run_launches < len(g) \
                or not any(x[3] for x in g):
            raise AssertionError("csv_source run differs from the CPU run")
        print(f"e2e ingest csv_source -> run (WKT-read polygons): "
              f"{len(read)} Points read in {read_secs:.3f} s (2 bad lines, "
              f"one with an unparseable time, skipped), {len(g)} windows, "
              f"matches "
              f"{[len(x[3]) for x in g]} in {g_secs:.6f} s; launches "
              f"polyline_min_dist={run_launches}; equal to the CPU run "
              f"({w_secs:.3f} s) [{card}]")

    # The synthetic GPS source at its default rate and devices into run,
    # cut to SYN_DURATION_MS of its default 30 s.
    t0 = time.perf_counter()
    src = SyntheticGpsSource(BEIJING["min_x"], BEIJING["max_x"],
                             BEIJING["min_y"], BEIJING["max_y"],
                             duration_ms=SYN_DURATION_MS)
    gps = list(src)
    gen_secs = time.perf_counter() - t0
    polyline_min_dist.launches = 0
    g, g_secs = range_run_windows(gpu, gps, polys[:SYN_QUERIES])
    syn_launches = polyline_min_dist.launches
    launches += syn_launches
    w, w_secs = range_run_windows("cpu", gps, polys[:SYN_QUERIES])
    if g != w or len(g) != src.duration_ms // 1000 \
            or syn_launches < len(g) or not sum(len(x[3]) for x in g):
        raise AssertionError("synthetic source run differs from the CPU run")
    print(f"e2e ingest SyntheticGpsSource -> run ({src.total_events} events "
          f"at {src.target_eps}/s over {src.num_devices} devices, made in "
          f"{gen_secs:.3f} s; {SYN_QUERIES} polygons): {len(g)} windows, "
          f"{sum(len(x[3]) for x in g)} matches in {g_secs:.6f} s = "
          f"{len(gps) / g_secs:.1f} events/s; launches "
          f"polyline_min_dist={syn_launches}; equal to the CPU run "
          f"({w_secs:.3f} s) [{card}]")

    # CRS and haversine at 1M float64 points over Belgium.
    rng = np.random.default_rng(43)
    lon = rng.uniform(BELGIUM[0], BELGIUM[1], CRS_POINTS)
    lat = rng.uniform(BELGIUM[2], BELGIUM[3], CRS_POINTS)
    t0 = time.perf_counter()
    e_np, n_np = crs.wgs84_to_epsg25831(lon, lat)
    lo_np, la_np = crs.epsg25831_to_wgs84(e_np, n_np)
    np_secs = time.perf_counter() - t0
    lon_d = torch.from_numpy(lon).to(gpu)
    lat_d = torch.from_numpy(lat).to(gpu)

    def on_card():
        e, n = crs.wgs84_to_epsg25831(lon_d, lat_d, xp=torch)
        lo, la = crs.epsg25831_to_wgs84(e, n, xp=torch)
        ll = torch.stack([lon_d, lat_d], dim=1)
        return e, n, lo, la, haversine_distance(ll[:-1], ll[1:])

    on_card()
    if torch.device(gpu).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    e, n, lo, la, hav = on_card()
    if torch.device(gpu).type == "cuda":
        torch.cuda.synchronize()
    card_secs = time.perf_counter() - t0
    ll_cpu = torch.from_numpy(np.stack([lon, lat], axis=1))
    hav_cpu = haversine_distance(ll_cpu[:-1], ll_cpu[1:]).numpy()
    for a, b, what in ((e, e_np, "easting"), (n, n_np, "northing"),
                       (lo, lo_np, "inverse lon"), (la, la_np, "inverse lat"),
                       (hav, hav_cpu, "haversine")):
        np.testing.assert_allclose(a.cpu().numpy(), b, rtol=1e-12, atol=0,
                                   err_msg=what)
    trip = max(float((lo.cpu() - lon_d.cpu()).abs().max()),
               float((la.cpu() - lat_d.cpu()).abs().max()))
    if trip >= 1e-11:
        raise AssertionError(f"CRS round trip off by {trip} deg")
    print(f"crs: utm_forward + utm_inverse + haversine at {CRS_POINTS} "
          f"float64 points over Belgium in {1e3 * card_secs:.3f} ms on the "
          f"card (numpy forward + inverse {1e3 * np_secs:.3f} ms on the "
          f"host); within rtol 1e-12 of the host runs, round trip within "
          f"{trip:.3g} deg [{card}]")
    print(f"phase 27 wall: {time.perf_counter() - t_phase:.3f} s [{card}]")
    return launches, gps


def checkin_stream():
    """CHECKIN_EVENTS check-in events from seed 44: uniform users, rooms
    and directions, each event with probability CHECKIN_REPEAT its
    user's previous door again (a missed opposite event)."""
    from spatialflink_tpu_torch.apps.checkin import CheckInEvent

    rng = np.random.default_rng(44)
    n = CHECKIN_EVENTS
    users = rng.integers(0, CHECKIN_USERS, n).tolist()
    doors = (rng.integers(0, CHECKIN_ROOMS, n) * 2
             + rng.integers(0, 2, n)).tolist()
    repeat = (rng.uniform(size=n) < CHECKIN_REPEAT).tolist()
    ts = (1_000 + np.arange(n) * 3 + rng.integers(0, 3, n)).tolist()
    names = [f"room{d // 2}-{'in' if d % 2 == 0 else 'out'}"
             for d in range(2 * CHECKIN_ROOMS)]
    last = {}
    out = []
    for i in range(n):
        u = users[i]
        d = last[u] if repeat[i] and u in last else doors[i]
        last[u] = d
        out.append(CheckInEvent(f"e{i}", names[d], f"u{u}", ts[i]))
    return out


def check_apps(card, gps, gpu="cuda"):
    """Phase 28: the check-in app's device path against its host walk,
    the stay-time SoA path on the card against the CPU, and the pane
    aggregates against a brute-force window loop."""
    import torch

    from spatialflink_tpu_torch.apps.checkin import (
        check_in_query,
        check_in_query_soa,
    )
    from spatialflink_tpu_torch.apps.staytime import cell_stay_time_soa
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.streams.panes import sliding_aggregate

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    events = checkin_stream()
    print(f"data: {len(events)} check-in events in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    caps = {f"room{i}": 10 + i % 7 for i in range(0, CHECKIN_ROOMS, 2)}
    t0 = time.perf_counter()
    host = [(r, c, o) for r, c, o, _ in check_in_query(iter(events), caps)]
    host_secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    soa = [(r, c, o) for r, c, o, _ in
           check_in_query_soa(iter(events), caps, device=gpu)]
    soa_secs = time.perf_counter() - t0
    if soa != host:
        raise AssertionError("check_in_query_soa differs from the host walk")
    ins = outs = 0
    prev = {}
    for ev in events:
        p = prev.get(ev.user_id)
        if p is not None and p.device_id == ev.device_id:
            ins += ev.direction == "out"
            outs += ev.direction == "in"
        prev[ev.user_id] = ev
    if not (ins and outs) or len(host) != len(events) + ins + outs:
        raise AssertionError(f"check-in: synthesized {ins} in, {outs} out")
    print(f"e2e check_in_query_soa: {len(events)} events ({CHECKIN_USERS} "
          f"users, {CHECKIN_ROOMS} rooms; {outs} missed outs and {ins} "
          f"missed ins synthesized) -> "
          f"{len(soa)} emissions in {soa_secs:.6f} s = "
          f"{len(events) / soa_secs:.1f} events/s, equal to the host walk "
          f"({host_secs:.3f} s = {len(events) / host_secs:.1f} events/s) "
          f"[{card}]")

    grid = UniformGrid(**BEIJING)
    n_dev = max(int(p.obj_id[3:]) for p in gps) + 1
    arrays = {"ts": np.array([p.timestamp for p in gps], np.int64),
              "x": np.array([p.x for p in gps]),
              "y": np.array([p.y for p in gps]),
              "oid": np.array([int(p.obj_id[3:]) for p in gps], np.int32)}
    step = 20_000
    chunks = [{k: v[i:i + step] for k, v in arrays.items()}
              for i in range(0, len(gps), step)]
    out = {}
    for d in (gpu, "cpu"):
        t0 = time.perf_counter()
        out[d] = list(cell_stay_time_soa(iter(chunks), STAY_WINDOW_S,
                                         STAY_SLIDE_S, grid, device=d))
        out[d + "_secs"] = time.perf_counter() - t0
    got, want = out[gpu], out["cpu"]
    if len(got) != len(want) or not got:
        raise AssertionError(f"stay time: {len(got)} vs {len(want)} windows")
    for (s, e, c, dw), (ws, we, wc, wd) in zip(got, want):
        if (s, e) != (ws, we) or not np.array_equal(c, wc) \
                or not np.array_equal(dw, wd) or dw.dtype != np.int64:
            raise AssertionError(f"stay time window {(s, e)} differs")
    print(f"e2e cell_stay_time_soa ({STAY_WINDOW_S} s by {STAY_SLIDE_S} s, "
          f"config 3's grid, the synthetic stream): {len(got)} windows, "
          f"{sum(len(c) for _, _, c, _ in got)} (window, cell) dwell sums, "
          f"{len(gps)} events in {out[gpu + '_secs']:.6f} s = "
          f"{len(gps) / out[gpu + '_secs']:.1f} events/s; int64 sums equal "
          f"to the CPU run ({out['cpu_secs']:.3f} s) [{card}]")

    ts, key = arrays["ts"], arrays["oid"].astype(np.int64)
    ims = (ts % 1000).astype(np.float64)
    t0 = time.perf_counter()
    win = sliding_aggregate(
        ts, key, n_dev, AGG_SIZE_MS, AGG_SLIDE_MS,
        sum_fields={"x": arrays["x"], "ms": ims},
        minmax_fields={"x": arrays["x"], "y": arrays["y"]})
    agg_secs = time.perf_counter() - t0
    worst = 0.0
    for w in range(AGG_BRUTE_WINDOWS):
        start = win.starts[w]
        in_w = (ts >= start) & (ts < start + AGG_SIZE_MS)
        for k in range(n_dev):
            m = in_w & (key == k)
            ok = win.count[w, k] == m.sum()
            if m.any():
                ok &= win.sums["ms"][w, k] == ims[m].sum()
                ok &= win.mins["x"][w, k] == arrays["x"][m].min()
                ok &= win.maxs["y"][w, k] == arrays["y"][m].max()
                want_x = arrays["x"][m].sum()
                err = abs(win.sums["x"][w, k] - want_x) / abs(want_x)
                worst = max(worst, err)
                ok &= err <= 1e-12
            if not ok:
                raise AssertionError(f"sliding_aggregate window {w} key {k}")
    print(f"sliding_aggregate ({AGG_SIZE_MS // 1000} s by {AGG_SLIDE_MS} ms, "
          f"host numpy): {len(win.starts)} windows x {n_dev} keys from "
          f"{len(ts)} events in {agg_secs:.3f} s; the first "
          f"{AGG_BRUTE_WINDOWS} equal to a brute-force loop (counts, minima, "
          f"maxima and integer-valued sums exact; coordinate sums within "
          f"rel {worst:.3g} <= 1e-12) [{card}]")
    print(f"phase 28 wall: {time.perf_counter() - t_phase:.3f} s [{card}]")


def sncb_streams():
    """Phase 29's streams: the benchmark runner's 600,000 events
    (FA = FF = 5.0), and a copy with FA ~ U(0, 1), FF ~ U(0, 0.4)."""
    from spatialflink_tpu_torch.sncb.common import GpsEvent
    from spatialflink_tpu_torch.sncb.runners import BRUSSELS_BBOX
    from spatialflink_tpu_torch.streams.sources import SyntheticGpsSource

    src = SyntheticGpsSource(
        *BRUSSELS_BBOX, target_eps=SNCB_EPS, duration_ms=SNCB_DURATION_MS,
        num_devices=SNCB_DEVICES, seed=42, start_ts=SNCB_T0,
        make_event=lambda device_id, x, y, timestamp, speed: GpsEvent(
            device_id, x, y, timestamp, speed, 5.0, 5.0))
    events = list(src)
    rng = np.random.default_rng(29)
    fa = rng.uniform(0.0, 1.0, len(events)).tolist()
    ff = rng.uniform(0.0, 0.4, len(events)).tolist()
    brakes = [GpsEvent(e.device_id, e.lon, e.lat, e.ts, e.gps_speed, a, b)
              for e, a, b in zip(events, fa, ff)]
    return events, brakes


def traced(fn, gpu):
    """(fn's result, wall s, device busy s, kernels) of one call; on the
    card under a profiler trace (``trace_busy``; a trace can lose
    activities, so ``idle`` reads an empty one as not measured), on the
    CPU timed alone."""
    box = []
    if gpu == "cpu":
        t0 = time.perf_counter()
        box.append(fn())
        return box[0], time.perf_counter() - t0, 0.0, 0
    wall, busy, kernels = trace_busy(lambda: box.append(fn()))
    return box[0], wall, busy, kernels


def idle(wall, busy):
    if not busy:
        return "device idle not measured (empty trace)"
    return f"device idle {100 - 100 * busy / wall:.2f}%"


class tee_query:
    """Within the block, the runner module's query ``name`` also appends
    every record it yields to ``records``: the runner's own run, read
    record for record."""

    def __init__(self, module, name):
        self.module, self.name, self.records = module, name, []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def teed(*args, **kwargs):
            for r in self.orig(*args, **kwargs):
                self.records.append(r)
                yield r

        setattr(self.module, self.name, teed)
        return self.records

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def check_sncb(card, gpu="cuda"):
    """Phase 29: the SNCB layer. The zone test on the card over 600,000
    metric points for each zone set against the numpy twin and the CPU;
    benchmark_runner q1 and q5 at 600,000 events, record for record equal
    to their CPU runs; Q2's batch replay over the FA/FF stream against
    its CPU run and a brute-force q2_window loop; benchmark_runner q2 and
    q3 and local_test_runner (cuts). Returns the FA/FF stream."""
    import torch

    from spatialflink_tpu_torch.sncb import mobility, runners
    from spatialflink_tpu_torch.sncb.common import (
        BufferedZone,
        CRSUtils,
        PolygonLoader,
        _pack_zones,
        _zone_hit_kernel,
        contains_any_zone,
        contains_any_zone_np,
    )
    from spatialflink_tpu_torch.sncb.queries import (
        buffer_q1_zones,
        q2_brake_monitor_batch,
        q2_window,
    )

    t0 = time.perf_counter()
    events, brakes = sncb_streams()
    n = len(events)
    print(f"data: {n} SNCB events (+ an FA/FF copy) in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    risk = PolygonLoader.load_geojson_buffered("high_risk_zones.geojson",
                                               20.0)
    maint = PolygonLoader.load_geojson_buffered("maintenance_areas.geojson",
                                                0.0)
    fence = PolygonLoader.load_wkt_buffered("q5_fence.wkt", 20.0)
    t0 = time.perf_counter()
    xy = CRSUtils.enrich_batch(events)
    lonlat = np.array([[e.lon, e.lat] for e in events])
    print(f"enrich_batch (host numpy UTM): {n} points in "
          f"{time.perf_counter() - t0:.3f} s")
    sets = {
        "q1 (20 + 20 m)": (buffer_q1_zones(risk, 20.0), xy),
        "maintenance (0 m)": (maint, xy),
        "q5 fence (20 m)": (fence, xy),
        "mn_q5 fence (0.001 deg)": ([BufferedZone(
            [np.asarray(mobility.Q5_FENCE, float)], 0.001)], lonlat),
    }
    for label, (zones, pts) in sets.items():
        got = contains_any_zone(zones, pts, device=gpu)
        t0 = time.perf_counter()
        cpu = contains_any_zone(zones, pts, device="cpu")
        cpu_secs = time.perf_counter() - t0
        twin = contains_any_zone_np(zones, pts)
        if not (np.array_equal(got, cpu) and np.array_equal(got, twin)):
            raise AssertionError(f"zone mask {label} differs")
        if not 0 < got.sum() < n:
            raise AssertionError(f"zone mask {label}: {got.sum()} hits")
        timing = "not timed on the CPU"
        if gpu != "cpu":
            # The device part alone on resident inputs (time_ms), and the
            # whole call with its copies.
            verts, evs, bufs = _pack_zones(zones)
            args = (torch.from_numpy(pts).to(gpu),
                    torch.from_numpy(verts).to(gpu),
                    torch.from_numpy(evs).to(gpu), bufs)
            dev_ms, call_ms = time_ms(lambda: _zone_hit_kernel(*args))
            kern, _ = launches_per_call(lambda: _zone_hit_kernel(*args))
            t0 = time.perf_counter()
            contains_any_zone(zones, pts, device=gpu)
            wall_ms = (time.perf_counter() - t0) * 1e3
            timing = (f"device {dev_ms:.6f} ms per {n} points ({call_ms:.6f}"
                      f" ms per call with its launches, {kern:g} kernels); "
                      f"the whole call {wall_ms:.3f} ms with the copies")
        print(f"zone test {label}: {n} points, {int(got.sum())} inside, "
              f"equal to the CPU ({cpu_secs * 1e3:.3f} ms) and the numpy "
              f"twin; {timing} [{card}]")

    rates = {}
    for q, name in (("q1", "q1_high_risk"), ("q5", "q5_traj_speed_fence")):
        out = {}
        for d in (gpu, "cpu"):
            with tee_query(runners, name) as recs:
                rep, wall, busy, kernels = traced(
                    lambda: runners.benchmark_runner(
                        q, SNCB_EPS, SNCB_DURATION_MS, SNCB_DEVICES,
                        device=d), d)
            out[d] = (rep, list(recs), wall, busy, kernels)
        (rep, recs, wall, busy, kernels), (crep, crecs, *_) = \
            out[gpu], out["cpu"]
        if recs != crecs or rep.results != len(recs) or not recs \
                or rep.events != n:
            raise AssertionError(f"benchmark_runner {q}: {rep.results} vs "
                                 f"{crep.results} records")
        rates[q] = rep.eps
        print(f"e2e benchmark_runner {q}: {rep.events} events -> "
              f"{rep.results} records in {rep.duration_s:.6f} s = "
              f"{rep.eps:.1f} events/s, equal record for record to the CPU "
              f"run ({crep.duration_s:.3f} s); traced: {kernels} kernels, "
              f"busy {busy * 1e3:.3f} ms of {wall:.3f} s, "
              f"{idle(wall, busy)} [{card}]")

    out = {}
    for d in (gpu, "cpu"):
        out[d], out[d + "_secs"], busy, kernels = traced(
            lambda: q2_brake_monitor_batch(brakes, maint, device=d), d)
        if d == gpu:
            q2_trace = (busy, kernels)
    got = out[gpu]
    if got != out["cpu"] or not got:
        raise AssertionError(f"q2 batch: {len(got)} vs {len(out['cpu'])}")
    # The first windows of the 10 ms grid, the partial ones over the
    # stream's start included.
    ts = np.array([e.ts for e in brakes])
    first = int(ts[0]) // 10 * 10 - 10_000 + 10
    starts = [first + 10 * k for k in range(Q2_BRUTE_WINDOWS)]
    brute = []
    for s in starts:
        lo, hi = np.searchsorted(ts, [s, s + 10_000])
        brute += q2_window(brakes[lo:hi], maint, s, s + 10_000, device=gpu)
    head = [o for o in got if o.win_start < starts[-1] + 10]
    if brute != head or not head:
        raise AssertionError("q2 batch differs from the q2_window loop")
    print(f"e2e q2_brake_monitor_batch (10 s by 10 ms): {n} FA/FF events -> "
          f"{len(got)} alerts in {out[gpu + '_secs']:.6f} s = "
          f"{n / out[gpu + '_secs']:.1f} events/s, equal to the CPU run "
          f"({out['cpu_secs']:.3f} s); its first {len(starts)} windows "
          f"({len(head)} alerts) equal to a q2_window loop; traced: "
          f"{q2_trace[1]} kernels, busy {q2_trace[0] * 1e3:.3f} ms, "
          f"{idle(out[gpu + '_secs'], q2_trace[0])} [{card}]")

    for q in ("q2", "q3"):
        rep = runners.benchmark_runner(q, SNCB_EPS, SNCB_HOST_DURATION_MS,
                                       SNCB_DEVICES, device=gpu)
        print(f"e2e benchmark_runner {q} (cut to {rep.events} events): "
              f"{rep.results} records in {rep.duration_s:.6f} s = "
              f"{rep.eps:.1f} events/s [{card}]")
    local = runners.local_test_runner(device=gpu)
    if {r.raw.device_id for r in local["q1"]} != {"A"} \
            or {o.device_id for o in local["q5"]} != {"E"} \
            or local != runners.local_test_runner(device="cpu"):
        raise AssertionError("local_test_runner")
    print(f"local_test_runner: "
          + ", ".join(f"{q} {len(v)}" for q, v in local.items())
          + f" records, the reference's expectations and equal to the CPU "
          f"[{card}]")
    return brakes, rates


def mn_csv_lines(brakes):
    """MN_LINES 14-column CSV lines of the FA/FF stream."""
    return [f"{e.ts},{e.device_id},z,{e.fa},{e.ff},a,b,c,d,e,f,"
            f"{e.gps_speed},{e.lat},{e.lon}" for e in brakes[:MN_LINES]]


def check_mn_and_counters(card, brakes, gpu="cuda"):
    """Phase 30: mobility_runner q1-q5 and the instrumented MN queries
    over MN_LINES lines (q5 on the card equal to the CPU), their
    ingest→emit latency percentiles; then the op counters over config 3's
    first COUNTER_WINDOWS range windows through B4, card and CPU
    snapshots equal, a disabled run recording 0. Returns B4's launches."""
    import os
    import tempfile

    import torch

    from spatialflink_tpu_torch.mn.queries import INSTRUMENTED
    from spatialflink_tpu_torch.operators import PointPolygonRangeQuery
    from spatialflink_tpu_torch.ops import counters as oc
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.sncb.mobility import mobility_runner

    t0 = time.perf_counter()
    lines = mn_csv_lines(brakes)
    print(f"data: {len(lines)} MN CSV lines in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    for q in ("q1", "q2", "q3", "q4", "q5"):
        rows, secs, busy, kernels = traced(
            lambda: mobility_runner(q, iter(lines), device=gpu),
            gpu if q == "q5" else "cpu")
        note = ""
        if q == "q5":
            t1 = time.perf_counter()
            if rows != mobility_runner(q, iter(lines), device="cpu"):
                raise AssertionError("mobility_runner q5 differs")
            note = (f", equal to the CPU run "
                    f"({time.perf_counter() - t1:.3f} s); traced: {kernels} "
                    f"kernels, busy {busy * 1e3:.3f} ms, {idle(secs, busy)}")
        if not rows:
            raise AssertionError(f"mobility_runner {q}: no rows")
        print(f"e2e mobility_runner {q}: {len(lines)} lines -> {len(rows)} "
              f"rows in {secs:.6f} s = {len(lines) / secs:.1f} lines/s{note} "
              f"[{card}]")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_mn_") as tmp:
        for q, fn in INSTRUMENTED.items():
            reps = {}
            for d in ((gpu, "cpu") if q == "q5" else (gpu,)):
                props = {"output.file": os.path.join(tmp, f"{q}_{d}.txt"),
                         "stats.dir": os.path.join(tmp, d)}
                if q == "q1":
                    # The default query point (4.3658, 50.6456) lies south
                    # of the Brussels bbox: one inside it, 1 km.
                    props.update({"query.lon": "4.375", "query.lat": "50.85",
                                  "tolerance.meters": "1000.0"})
                kw = {"device": d} if q == "q5" else {}
                rep, secs, busy, kernels = traced(
                    lambda: fn(iter(lines), props, **kw),
                    d if q == "q5" else "cpu")
                reps[d] = (rep, secs, props["output.file"], busy, kernels)
            rep, secs, path, busy, kernels = reps[gpu]
            text = open(path).read()
            if q == "q5" and text != open(reps["cpu"][2]).read():
                raise AssertionError("instrumented q5 differs from the CPU")
            m = rep.metrics
            if rep.results <= 0 or m["source_in_total"] != len(lines) \
                    or m["sink_out_total"] != rep.results \
                    or text.count("\n") != rep.results:
                raise AssertionError(f"instrumented {q}: {rep.results}")
            print(f"e2e instrumented_mn_{q}: {len(lines)} lines -> "
                  f"{rep.results} results in {secs:.6f} s = "
                  f"{len(lines) / secs:.1f} lines/s; host-pipeline latency "
                  f"(ingest stamp to sink, NES buckets) p50 {rep.p50_ms:g} / "
                  f"p95 {rep.p95_ms:g} / p99 {rep.p99_ms:g} ms"
                  + (f", result file equal to the CPU run; traced: "
                     f"{kernels} kernels, busy {busy * 1e3:.3f} ms, "
                     f"{idle(secs, busy)}" if q == "q5" else "")
                  + f" [{card}]")

    polys = range_polygons()
    chunks = range_chunks(COUNTER_WINDOWS, RANGE_WIN, 7)
    snaps = {}
    try:
        for d in (gpu, "cpu"):
            oc.enable()
            polyline_min_dist.launches = 0
            got, secs, _ = run_range(d, PointPolygonRangeQuery, chunks, polys,
                                     RANGE_R)
            if d == gpu:
                launches, card_windows = polyline_min_dist.launches, got
            else:
                check_range_windows(card_windows, got, "counters run_soa",
                                    RANGE_R)
            snaps[d] = oc.counters.snapshot()
            snaps[d].pop("throughput_eps")
        oc.counters.reset()
        oc.disable()
        run_range(gpu, PointPolygonRangeQuery, chunks, polys, RANGE_R)
        off = oc.counters.snapshot()
        off.pop("throughput_eps")
    finally:
        oc.disable()
    if snaps[gpu] != snaps["cpu"] or snaps[gpu]["dist_computations"] <= 0 \
            or snaps[gpu]["windows"] != COUNTER_WINDOWS or any(off.values()):
        raise AssertionError(f"counters: {snaps} disabled {off}")
    if gpu != "cpu" and launches < COUNTER_WINDOWS:
        raise AssertionError(f"counters run: {launches} B4 launches")
    if gpu != "cpu":
        torch.cuda.synchronize()
    print(f"op counters, PointPolygonRangeQuery.run_soa (config 3, "
          f"{COUNTER_WINDOWS} windows, B4 launches {launches}): "
          f"{snaps[gpu]}, equal to the CPU run; disabled: {off} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# Phase 31: the runtime layer (telemetry, faults, ablation) on the card

RT_FAULT_AT = 3          # the hit a fault plan fires at (a pane's worth in)
RT_B1_THIRD_CALL = 5     # device.dispatch hits: (B1 step, merge) a pane
RT_HANG_S = 0.05
RT_PROBES = 8
RT_LINK_BYTES = 1 << 24  # the LinkProbe payload, 16 MiB
RT_DELTA_PANES = 8       # the pipelined delta path's headline panes (of 21)
RT_KNN_PANES = 10        # the kNN path's config 2 panes (of 25)
RT_RANGE_WINDOWS = 4     # the range path's config 3 windows (of 10)


def same_tree(a, b) -> bool:
    """Bit-equality of two run outputs: arrays by their bytes, containers
    element by element, anything else by ``==``."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return isinstance(b, (list, tuple)) and len(a) == len(b) and all(
            same_tree(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and \
            a.tobytes() == b.tobytes()
    return a == b


def counted_syncs(fn, gpu="cuda"):
    """(fn's result, the synchronising calls it made): CUDA's sync debug
    mode warns once per synchronising call; the warnings are counted (0
    with ``gpu="cpu"``, a rehearsal)."""
    import torch

    if gpu == "cpu":
        return fn(), 0
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("synchroniz" in str(w.message) for w in caught)


def raises_fault(fn, kind="raise"):
    """The ``InjectedFault`` of ``fn()``; a run that finishes, or raises
    anything else, fails the phase."""
    from spatialflink_tpu_torch.faults import InjectedFault

    try:
        fn()
    except InjectedFault as e:
        if e.kind != kind:
            raise AssertionError(f"fault kind {e.kind}, want {kind}") from e
        return e
    raise AssertionError("the armed fault did not raise")


def spans_nest(events) -> bool:
    """Complete events of each thread either nest or are disjoint (1 µs of
    slack for the independent floors of ts and dur)."""
    by_tid = {}
    for e in events:
        if e.get("ph") == "X":
            by_tid.setdefault(e["tid"], []).append(e)
    for evs in by_tid.values():
        stack = []
        for e in sorted(evs, key=lambda e: (e["ts"], -e["dur"])):
            while stack and stack[-1] <= e["ts"]:
                stack.pop()
            end = e["ts"] + e["dur"]
            if stack and end > stack[-1] + 1:
                return False
            stack.append(end)
    return True


def headline_bytes(panes, codec: bool):
    """(h2d bytes, wire raw bytes, wire coded bytes) the headline run
    ships, computed here from its panes: 6 B a point at the pane bucket
    raw; with the delta codec the predictor tables once and each pane's
    words at their bucket, the encoder's own counts."""
    from spatialflink_tpu_torch.ops import wire_codec as wc
    from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket

    if not codec:
        return sum(6 * wire_pane_bucket(p.shape[1]) for p in panes), 0, 0
    enc = wc.WirePaneEncoder(NUM_SEGMENTS)
    h2d = enc.pred_x.nbytes + enc.pred_y.nbytes
    raw = coded = 0
    for p in panes:
        e = enc.encode(p)
        wb = wc.wire_word_bucket(len(e.words), wire_pane_bucket(p.shape[1]))
        h2d += 4 * wb
        raw += e.raw_bytes
        coded += 4 * wb + wc.HEADER_BYTES
    return h2d, raw, coded


def runtime_paths(panes, wf, gpu="cuda"):
    """The five paths of phase 31: (label, run() → (windows, seconds),
    points, expected fetches for n windows, window span name or None,
    timed off/on pairs: more for the short runs). The pipelined delta,
    kNN and range paths run depth cuts of their streams (the headline's
    first ``RT_DELTA_PANES`` panes, config 2's first ``RT_KNN_PANES``,
    config 3's first ``RT_RANGE_WINDOWS`` windows): what the phase checks
    holds window by window."""
    from spatialflink_tpu_torch import operators as ops

    delta_panes = panes[:RT_DELTA_PANES]
    chunks2 = pane_chunks()[:RT_KNN_PANES]
    chunks3 = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)[:RT_RANGE_WINDOWS]
    polys = range_polygons()
    chunks4 = (soa_join_chunks(1), soa_join_chunks(2))
    lag = 2
    return [
        ("headline sync (B1)",
         lambda: run_path(gpu, "sync", panes, wf)[:2],
         sum(p.shape[1] for p in panes), lambda n: 2 * n, None, 7),
        ("headline pipelined delta (B1, B2)",
         lambda: run_path(gpu, "pipelined_delta", delta_panes, wf)[:2],
         sum(p.shape[1] for p in delta_panes),
         lambda n: n - min(n, lag) + (1 if n else 0), None, 3),
        ("kNN run_soa config 2",
         lambda: run_point_soa(gpu, "run_soa", chunks2),
         PANE_PTS * RT_KNN_PANES, lambda n: 2 * n, "window.knn_soa", 3),
        ("range run_soa config 3 (B4)",
         lambda: run_range(gpu, ops.PointPolygonRangeQuery, chunks3,
                           polys, RANGE_R)[:2],
         RANGE_WIN * RT_RANGE_WINDOWS, lambda n: n, None, 3),
        ("join run_soa config 4 (B3)",
         lambda: run_soa_path(gpu, chunks4),
         2 * JOIN_WIN * JOIN_WINDOWS, lambda n: n, None, 5),
    ]


def timed_pairs(run, reps, arm, disarm):
    """Median seconds of ``run()`` off and on over ``reps`` alternating
    pairs (off, on, on, off, ...), outside the sync debug mode: host
    clocks on a shared host spread, so one pair says little."""
    off, on = [], []
    for i in range(reps):
        for state in ((False, True) if i % 2 == 0 else (True, False)):
            if state:
                arm()
            try:
                secs = run()[1]
            finally:
                if state:
                    disarm()
            (on if state else off).append(secs)
    return statistics.median(off), statistics.median(on), off, on


def percentiles_line(tel, durs_us):
    """Window latency p50/p95/p99 ms: the FixedBucketLatency histogram
    (NES buckets) and the exact percentiles of the span durations."""
    lat = tel.window_latency
    hist = "/".join(f"{lat.percentile(p):g}" for p in (0.50, 0.95, 0.99))
    exact = "/".join(f"{v:.3f}" for v in
                     np.percentile(np.asarray(durs_us) / 1e3, [50, 95, 99]))
    return (f"histogram p50/p95/p99 {hist} ms, exact from the trace's "
            f"{len(durs_us)} spans {exact} ms")


def check_runtime(card, panes, wf, gpu="cuda"):
    """Phase 31: every path disabled then enabled (trace and ledger stream
    written), faults and ablation on the card, LinkProbe. Returns the
    kernels' launches over the phase. ``gpu="cpu"`` rehearses it on the
    CPU (no sync counting; the launch counts stay 0 unless the plain
    versions are wrapped to count)."""
    import tempfile

    import torch

    from spatialflink_tpu_torch.ablation import ablation
    from spatialflink_tpu_torch.faults import faults
    from spatialflink_tpu_torch.ops import wire_codec as wc
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.ops.wire_knn import WIRE_DIGEST_LABELS
    from spatialflink_tpu_torch.telemetry import (
        LEDGER_VERSION,
        LinkProbe,
        load_trace,
        telemetry,
    )
    from tools.sfprof import ledger as ledger_mod
    from tools.sfprof import stream as stream_mod

    t_phase = time.perf_counter()
    counters = {"wire_digest": wire_digest,
                "wire_codec_decode": wc.decode_wire_pane,
                "join_extract": join_extract,
                "polyline_min_dist": polyline_min_dist}
    for c in counters.values():
        c.launches = 0
    tmp = tempfile.mkdtemp(prefix="chip_smoke_runtime_")
    paths = runtime_paths(panes, wf, gpu)
    kind = "torch" if gpu == "cpu" else "cuda"
    base = {}
    for i, (label, run, points, fetches, wspan, reps) in enumerate(paths):
        # Warm: the allocator, first-use set-up, and the sync debug mode's
        # own first use (one torch.cuda.synchronize warning, once).
        counted_syncs(run, gpu)
        (want, _), d_syncs = counted_syncs(run, gpu)
        trace = f"{tmp}/trace{i}.jsonl"
        stream = f"{tmp}/stream{i}.jsonl"
        telemetry.enable(trace_path=trace, stream_path=stream)
        try:
            (got, _), e_syncs = counted_syncs(run, gpu)
            snap = telemetry.snapshot()
            table = telemetry.kernel_table()
            lat_line = None
            if wspan is not None:
                durs = [e["dur"] for e in telemetry.events
                        if e["name"] == wspan]
                lat_line = percentiles_line(telemetry, durs)
            ledger = telemetry.write_ledger(f"{tmp}/ledger{i}.json",
                                            bench={"path": label})
        finally:
            telemetry.disable()
        if not same_tree(got, want):
            raise AssertionError(f"{label}: windows differ with telemetry on")
        if e_syncs != d_syncs:
            raise AssertionError(f"{label}: {e_syncs} synchronising calls "
                                 f"with telemetry on, {d_syncs} off")
        if snap["d2h_transfers"] != fetches(len(got)):
            raise AssertionError(f"{label}: {snap['d2h_transfers']} fetches, "
                                 f"the operator makes {fetches(len(got))}")
        if i < 2:
            h2d, raw, coded = headline_bytes(
                panes[:RT_DELTA_PANES] if i == 1 else panes, codec=i == 1)
            if snap["bytes_h2d"] != h2d:
                raise AssertionError(f"{label}: h2d {snap['bytes_h2d']} B, "
                                     f"computed {h2d} B")
            wire = snap.get("wire_codec") or {"raw_bytes": 0,
                                              "coded_bytes": 0}
            if (wire["raw_bytes"], wire["coded_bytes"]) != (raw, coded):
                raise AssertionError(f"{label}: wire bytes {wire}, encoder "
                                     f"{raw} / {coded}")
        events = load_trace(trace)["traceEvents"]
        if not spans_nest(events):
            raise AssertionError(f"{label}: trace spans do not nest")
        with open(ledger) as f:
            doc = json.load(f)
        rec, info = stream_mod.recover(stream)
        problems = ledger_mod.validate(doc) + ledger_mod.validate(rec)
        if problems or doc["ledger_version"] != LEDGER_VERSION != 3 \
                or not info["sealed"]:
            raise AssertionError(f"{label}: ledger {problems}, sealed "
                                 f"{info['sealed']}")
        off_s, on_s, offs, ons = timed_pairs(run, reps, telemetry.enable,
                                             telemetry.disable)
        base[label] = (want, off_s, offs)
        print(f"runtime {label}: {len(got)} windows bit-equal with telemetry "
              f"on and off; synchronising calls {d_syncs} off, {e_syncs} on; "
              f"fetches {snap['d2h_transfers']} ({snap['bytes_d2h']} B), "
              f"h2d {snap['bytes_h2d']} B in {snap['h2d_transfers']} ships"
              + (f", wire raw/coded {snap['wire_codec']['raw_bytes']}/"
                 f"{snap['wire_codec']['coded_bytes']} B"
                 if snap.get("wire_codec") else "")
              + f"; trace {len(events)} events, ledger v"
              f"{doc['ledger_version']} and stream valid [{card}]")
        print(f"  telemetry cost: {points / off_s:.1f} points/s off, "
              f"{points / on_s:.1f} on (medians of {reps} alternating "
              f"pairs: off {', '.join(f'{t * 1e3:.3f}' for t in offs)} ms, "
              f"on {', '.join(f'{t * 1e3:.3f}' for t in ons)} ms), rate "
              f"ratio on/off {off_s / on_s:.4f} [{card}]")
        if lat_line is not None:
            print(f"  window latency ({wspan}): {lat_line} [{card}]")
        else:
            print(f"  window latency: no window span on this path (nor in "
                  f"the JAX package); dispatch table (host dispatch ns, "
                  f"not kernel time):")
            for r in table[:6]:
                print(f"    {r['kernel']}: {r['calls']} calls, "
                      f"{r['dispatch_ns']} ns dispatch")
            if snap.get("pipeline"):
                print(f"  pipeline counters {snap['pipeline']}")
        e2e = snap.get("e2e")
        print(f"  e2e stages: {e2e['stages'] if e2e else 'none: no e2e_end on this path (the driver, A11.2, sets it)'}")

    # Faults on the card.
    sync_run, delta_run = paths[0][1], paths[1][1]
    for point, run, at in (
            ("device.dispatch", sync_run, RT_B1_THIRD_CALL),
            ("device.ship", sync_run, RT_FAULT_AT),
            ("device.fetch", sync_run, RT_FAULT_AT),
            ("pipeline.ship", delta_run, RT_FAULT_AT),
            ("pipeline.fetch", delta_run, RT_FAULT_AT)):
        telemetry.enable()
        try:
            faults.arm([{"point": point, "at": at}])
            e = raises_fault(run)
            names = {ev["name"] for ev in telemetry.events}
            snap = telemetry.snapshot()
            b1_calls = sum(r["calls"] for r in telemetry.kernel_table()
                           if r["kernel"] == WIRE_DIGEST_LABELS[kind])
            faults.arm([{"point": point, "at": at, "kind": "hang",
                         "hang_s": RT_HANG_S}])
            t0 = time.perf_counter()
            raises_fault(run, "hang")
            hung = time.perf_counter() - t0
        finally:
            faults.disarm()
            telemetry.disable()
        if e.hit != at or f"fault_fired:{point}" not in names \
                or snap.get("faults", {}).get(point) != 1 \
                or hung < RT_HANG_S:
            raise AssertionError(f"fault {point}: hit {e.hit}, snapshot "
                                 f"{snap.get('faults')}, hang {hung:.3f} s")
        if point == "device.dispatch" and b1_calls != 2:
            raise AssertionError(f"device.dispatch fired after {b1_calls} "
                                 "B1 calls, not at the third")
        label = paths[0][0] if run is sync_run else paths[1][0]
        again, _ = run()
        if not same_tree(again, base[label][0]):
            raise AssertionError(f"fault {point}: rerun after disarm differs")
        print(f"fault {point} at hit {at} on the {label}: InjectedFault "
              f"raised, fault_fired:{point} in the events and snapshot"
              + (f" (after {b1_calls} B1 calls)" if point == "device.dispatch"
                 else "")
              + f"; hang {hung:.3f} s then raised; disarmed rerun bit-equal "
              f"[{card}]")

    # Ablation on the card: B1 on the sync run, B2 on the delta run.
    for name, path_i, label_ in (("B1", 0, WIRE_DIGEST_LABELS[kind]),
                                 ("B2", 1, "wire_pane_decode")):
        label, run, reps = paths[path_i][0], paths[path_i][1], \
            paths[path_i][5]
        want, base_secs, _ = base[label]
        telemetry.enable()
        try:
            ablation.arm([label_])
            got, _ = run()
            taint = telemetry.snapshot().get("tainted")
            telemetry.disable()
            # Timed with telemetry off, as the baseline is.
            times = [run()[1] for _ in range(reps)]
            secs = statistics.median(times)
        finally:
            ablation.disarm()
            telemetry.disable()
        tail = got[2:]
        zeroed = all(not np.any(w[3]) for w in tail) if name == "B1" \
            else all(w[4] == 0 for w in tail)
        if not taint or not taint["substituted_calls"].get(label_) \
                or not zeroed or not tail:
            raise AssertionError(f"ablation {name}: taint {taint}, windows "
                                 f"after the learning pane zeroed {zeroed}")
        again, _ = run()
        if not same_tree(again, want):
            raise AssertionError(f"ablation {name}: disarmed rerun differs")
        points = paths[path_i][2]
        print(f"ablation {name} ({label_}) on the {label}: TAINTED rates "
              f"{points / secs:.1f} points/s ablated (median of "
              f"{len(times)}: {', '.join(f'{t * 1e3:.3f}' for t in times)} "
              f"ms, telemetry off) against {points / base_secs:.1f} "
              f"baseline (the off median above); marginal cost "
              f"{(base_secs - secs) * 1e3:.3f} ms of {base_secs * 1e3:.3f} ms "
              f"a run (first run: {taint['learning_calls'][label_]} learning, "
              f"{taint['substituted_calls'][label_]} substituted calls); "
              f"windows zeroed after the learning pane; disarmed rerun "
              f"bit-equal [{card}]")

    telemetry.enable()
    try:
        probe = LinkProbe(device=gpu, payload_bytes=RT_LINK_BYTES)
        for _ in range(RT_PROBES):
            probe.sample()
        link = telemetry.snapshot()["link_probe"]
    finally:
        telemetry.disable()
    print(f"LinkProbe: {link['samples']} samples, latency p50 "
          f"{link['latency_ms_p50']:.4f} ms, round trip "
          f"{link['roundtrip_mbps_p50']:.1f} MB/s p50 over "
          f"{link['payload_bytes']} B [{card}]")
    launches = {k: c.launches for k, c in counters.items()}
    if not all(launches.values()):
        raise AssertionError(f"phase 31: a kernel did not launch {launches}")
    print(f"phase wall: 31 {time.perf_counter() - t_phase:.3f} s; launches "
          f"{launches} [{card}]")
    return launches


# ---------------------------------------------------------------------------
# Phase 32: checkpoints, exactly-once sinks and the dataflow driver.

DRV_WINDOWS = 2          # range kill → resume: config 3's 10 windows, cut
DRV_KILL_AT = 2          # the sink.write commit the kill child aborts at
DRV_IDS = 16_384         # the suite stream's objIDs (bench_suite.py:52)
DRV_JOIN_RETRIES = 2     # the join's retry budget, and the armed failures
DRV_KNN_FAIL_AT = 2      # the device.dispatch hit the kNN device path dies at
DRV_KNN_WINDOWS = 2      # 32c's windows of phase 15's stream (a cut of 3)
DRV_WIRE_CUT = 10        # headline panes before the carry's checkpoint


def driver_range_arrays(n_win=None):
    """Config 3's stream as arrays (xy, oid, ts): bench_suite.py:47-54's
    positions and objIDs from seed 7, one-second tumbling windows of
    ``RANGE_WIN`` points."""
    n = (DRV_WINDOWS if n_win is None else n_win) * RANGE_WIN
    rng = np.random.default_rng(7)
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1).astype(np.float32)
    oid = rng.integers(0, DRV_IDS, n)
    ts = (np.arange(n, dtype=np.int64) * 1000) // RANGE_WIN
    return xy, oid, ts


def driver_range_stream(n_win=None):
    """``driver_range_arrays`` as ``Point`` objects."""
    from spatialflink_tpu_torch.models.objects import Point

    xy, oid, ts = driver_range_arrays(n_win)
    return [Point(obj_id=f"o{o}", timestamp=int(t), x=float(x), y=float(y))
            for o, t, (x, y) in zip(oid.tolist(), ts.tolist(),
                                    xy.astype(np.float64).tolist())]


def driver_range_leg(device, workdir, stream, queries):
    """``PointPolygonRangeQuery.run(driver=)`` at config 3 into a
    transactional sink of ``render_range_result`` lines, checkpointed
    every window under ``workdir`` (resumed when a checkpoint is there).
    Returns (egress bytes, {commits: [(ms, checkpoint bytes)], first
    result ms, run s, windows, resumed})."""
    import os

    import torch

    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
        render_range_result,
    )
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink

    commits = []

    class TimedDriver(WindowedDataflowDriver):
        def _commit(self, final=False):
            t0 = time.perf_counter()
            super()._commit(final)
            commits.append(((time.perf_counter() - t0) * 1e3,
                            os.path.getsize(self.checkpoint_path)))

    path = os.path.join(workdir, "egress.csv")
    sink = TransactionalFileSink(path)
    drv = TimedDriver(
        checkpoint_path=os.path.join(workdir, "ckpt.bin"),
        checkpoint_every=1, sink=sink,
        retry=RetryPolicy(max_retries=0, backoff_s=0.0), failover=False)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    op = PointPolygonRangeQuery(conf, UniformGrid(**BEIJING), device=device)
    first = None
    t0 = time.perf_counter()
    for res in op.run(iter(stream), queries, RANGE_R, driver=drv):
        if first is None:
            first = (time.perf_counter() - t0) * 1e3
        for line in render_range_result(res):
            sink.stage(line)
    if op.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with open(path, "rb") as f:
        egress = f.read()
    return egress, {"commits": commits, "first_result_ms": first,
                    "run_s": secs, "windows": drv.stats["windows"],
                    "resumed": drv.stats["resumed"]}


def driver_child(workdir) -> int:
    """One child of phase 32a on the card (``--driver-child DIR``): the
    range leg, killed by an armed ``SFT_FAULT_PLAN`` or resumed from the
    checkpoint under ``workdir``. Prints one JSON line of its numbers."""
    import torch

    from spatialflink_tpu_torch import kernels
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    t_start = time.perf_counter()
    kernels.build()  # loads the built libraries; never a first-window build
    stream = driver_range_stream()
    polyline_min_dist.launches = 0
    _, info = driver_range_leg(torch.device("cuda", 0), workdir, stream,
                               range_polygons())
    info["from_start_s"] = time.perf_counter() - t_start
    info["launches"] = polyline_min_dist.launches
    print(json.dumps(info))
    return 0


def driver_children(workdir, card):
    """Phase 32a (ii): a child armed to abort at the sink's commit
    ``DRV_KILL_AT``, then a child that resumes; returns the egress bytes
    and the resume child's numbers."""
    import os

    env = {k: v for k, v in os.environ.items()
           if k not in ("SFT_FAULT_PLAN", "SFT_PIPELINE",
                        "SFT_LEDGER_STREAM")}
    cmd = [sys.executable, __file__, "--driver-child", workdir]
    kill = subprocess.run(cmd, env={**env, "SFT_FAULT_PLAN": json.dumps(
        [{"point": "sink.write", "kind": "abort", "at": DRV_KILL_AT}])},
        capture_output=True, text=True, timeout=300)
    if kill.returncode != 137:
        raise AssertionError(f"32a: the kill child exited {kill.returncode},"
                             f" not 137\n{kill.stderr[-2000:]}")
    with open(os.path.join(workdir, "egress.csv"), "rb") as f:
        torn = f.read()
    resume = subprocess.run(cmd, env=env, capture_output=True, text=True,
                            timeout=300)
    if resume.returncode != 0:
        raise AssertionError(f"32a: the resume child failed\n"
                             f"{resume.stderr[-2000:]}")
    info = json.loads(resume.stdout.strip().splitlines()[-1])
    with open(os.path.join(workdir, "egress.csv"), "rb") as f:
        return torn, f.read(), info


#: Phase 32e's chaos smoke: stopped if the run ends before the phase
#: collects it.
DRIVER_CHILDREN = []


def start_chaos_smoke():
    """Phase 32e: ``python -m spatialflink_tpu_torch.driver
    --chaos-smoke`` (three child processes on the card), started in the
    background from the checkout's root; ``communicate()`` collects it."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("SFT_FAULT_PLAN", "SFT_PIPELINE")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "spatialflink_tpu_torch.driver",
         "--chaos-smoke"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    DRIVER_CHILDREN.append(proc)
    return proc


def check_driver(card, panes, wf, gpu="cuda"):
    """Phase 32: the dataflow driver, checkpoints and exactly-once egress
    on the card. Returns each kernel's launches over the phase's main
    runs. ``gpu="cpu"`` rehearses it on the CPU (the launch checks then
    need the plain versions wrapped to count)."""
    import os
    import tempfile

    import torch

    from spatialflink_tpu_torch.checkpoint import (
        load_checkpoint,
        operator_state,
        restore_operator,
        save_checkpoint,
    )
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )
    from spatialflink_tpu_torch.faults import InjectedFault, faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        PointPointKNNQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.telemetry import telemetry

    dev = torch.device(gpu)
    cpu = torch.device("cpu")
    launches = {}
    walls = {}
    tmp = tempfile.mkdtemp(prefix="sft_driver_")

    # 32e runs beside the whole phase from its start: three processes
    # that wait mostly on their start.
    t_phase = t0 = time.perf_counter()
    smoke = start_chaos_smoke() if gpu == "cuda" else None
    t_smoke = time.perf_counter()

    # 32d: the headline carry through B1, checkpointed after pane
    # DRV_WIRE_CUT and resumed on the card and on the CPU.
    whole, _, _ = run_path(gpu, "sync", panes, wf)
    wconf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    q = Point(x=QUERY[0], y=QUERY[1])

    def wire_run(op, part, flush=True):
        return list(op.run_wire_panes(part, q, RADIUS, K, NUM_SEGMENTS, wf,
                                      flush_at_end=flush))

    wire_digest.launches = 0
    first_op = PointPointKNNQuery(wconf, UniformGrid(**BEIJING), device=dev)
    head = wire_run(first_op, panes[:DRV_WIRE_CUT], flush=False)
    path = os.path.join(tmp, "wire.ckpt")
    t_ck = time.perf_counter()
    save_checkpoint(path, op=operator_state(first_op))
    ck_ms = (time.perf_counter() - t_ck) * 1e3
    ck_bytes = os.path.getsize(path)
    conts = {}
    for label, device in (("card", dev), ("CPU", cpu)):
        op = PointPointKNNQuery(wconf, UniformGrid(**BEIJING), device=device)
        t_r = time.perf_counter()
        restore_operator(op, load_checkpoint(path)["op"])
        restore_ms = (time.perf_counter() - t_r) * 1e3
        conts[label] = (wire_run(op, panes[DRV_WIRE_CUT:]), restore_ms)
    launches["wire_digest"] = wire_digest.launches
    for label, (rest, _) in conts.items():
        check_windows(head + rest, whole, f"32d {label} continuation")
    if launches["wire_digest"] < len(panes):
        raise AssertionError(f"32d: {launches['wire_digest']} B1 launches")
    print(f"driver headline carry (run_wire_panes, {len(panes)} panes of "
          f"{SLIDE}): stopped after pane {DRV_WIRE_CUT} ({len(head)} "
          f"windows), checkpoint {ck_bytes} B in {ck_ms:.3f} ms (the digest "
          f"ring pulled from the card, framed, fsync'd), restored in "
          f"{conts['card'][1]:.3f} ms on the card and "
          f"{conts['CPU'][1]:.3f} ms on the CPU; both continuations "
          f"bit-equal to the uninterrupted synchronous windows; launches "
          f"wire_digest={launches['wire_digest']} [{card}]")
    walls["d"] = time.perf_counter() - t0

    # 32a: range through B4, clean → killed and resumed → on the CPU.
    t0 = time.perf_counter()
    stream = driver_range_stream()
    queries = range_polygons()
    print(f"data: {len(stream)} Point objects (config 3, {DRV_WINDOWS} "
          f"windows of {RANGE_WIN}) in {time.perf_counter() - t0:.3f} s "
          f"(host set-up)")
    dirs = {k: os.path.join(tmp, k) for k in ("clean", "chaos")}
    for d in dirs.values():
        os.makedirs(d)
    telemetry.enable()
    polyline_min_dist.launches = 0
    clean, info = driver_range_leg(dev, dirs["clean"], stream, queries)
    launches["polyline_min_dist"] = polyline_min_dist.launches
    stages = {s: telemetry.e2e_stage_percentiles(s)
              for s in ("assemble", "compute", "commit")}
    telemetry.disable()
    if launches["polyline_min_dist"] < DRV_WINDOWS:
        raise AssertionError(f"32a: {launches['polyline_min_dist']} B4 "
                             f"launches over {DRV_WINDOWS} windows")
    lines = clean.count(b"\n")
    if lines < DRV_WINDOWS or info["windows"] != DRV_WINDOWS:
        raise AssertionError(f"32a: {lines} egress lines, "
                             f"{info['windows']} windows")
    if gpu == "cuda":
        torn, resumed, rinfo = driver_children(dirs["chaos"], card)
    else:  # the rehearsal: the kill in process, the resume in process
        faults.arm([{"point": "sink.write", "at": DRV_KILL_AT,
                     "times": 10_000}])
        try:
            driver_range_leg(dev, dirs["chaos"], stream, queries)
            raise AssertionError("32a: the armed leg was not killed")
        except InjectedFault:
            pass
        finally:
            faults.disarm()
        with open(os.path.join(dirs["chaos"], "egress.csv"), "rb") as f:
            torn = f.read()
        resumed, rinfo = driver_range_leg(dev, dirs["chaos"], stream,
                                          queries)
        rinfo["from_start_s"] = rinfo["run_s"]
    try:
        if not (len(torn) < len(clean) and resumed == clean):
            raise AssertionError(
                f"32a: egress differs: clean {len(clean)} B, killed "
                f"{len(torn)} B, resumed {len(resumed)} B")

        def held(clean=clean):
            on_cpu, cpu_secs = twin("driver_range",
                                    driver_range_arrays())
            if on_cpu != clean:
                raise AssertionError(f"32a: the CPU run's egress differs "
                                     f"({len(on_cpu)} B, the card's "
                                     f"{len(clean)} B)")
            print(f"exact driver range: the clean card run's egress "
                  f"byte-identical to the CPU run's ({cpu_secs:.3f} s on "
                  f"the host CPU, the twin driver_range) [{card}]")
        later(held)
        if not rinfo["resumed"]:
            raise AssertionError("32a: the resume child did not resume")
        commit_txt = ", ".join(f"{ms:.3f} ms / {nb} B" for ms, nb in
                               info["commits"])
        resume_txt = ", ".join(f"{ms:.3f} ms / {nb} B" for ms, nb in
                               rinfo["commits"])
        stage_txt = ", ".join(
            f"{s} p50 {p50:g} / p99 {p99:g} ms"
            for s, (p50, p99) in stages.items())
        print(f"driver range (PointPolygonRangeQuery.run, config 3: "
              f"{DRV_WINDOWS}"
              f" x {RANGE_WIN} Points, {RANGE_POLYS} polygons, r={RANGE_R}, "
              f"checkpoint_every=1): {lines} egress lines, {len(clean)} B in "
              f"{info['run_s']:.3f} s; launches polyline_min_dist="
              f"{launches['polyline_min_dist']}; commits (sink append + "
              f"snapshot + framed write): {commit_txt}; killed at commit "
              f"{DRV_KILL_AT} ({len(torn)} B committed), resumed by a second "
              f"process: first result {rinfo['first_result_ms']:.3f} ms after "
              f"run() (checkpoint load, skip, window), "
              f"{rinfo['from_start_s']:.3f} s from the process's start, its "
              f"commits {resume_txt}; "
              f"egress byte-identical to the clean run (and to the CPU run, "
              f"held later) [{card}]")
        print(f"driver e2e stages (clean run, telemetry on; "
              f"telemetry.e2e_stage_percentiles, NES histogram buckets, "
              f"{DRV_WINDOWS} windows): {stage_txt} [{card}]")
        walls["a"] = time.perf_counter() - t0

        # 32b: the join through B3, WindowBased: retry, then no twin.
        t0 = time.perf_counter()
        streams = join_objects()
        conf = QueryConfiguration(window_size=1.0, slide_step=1.0)

        def join_run(driver=None, plan=None):
            op = PointPointJoinQuery(conf, UniformGrid(**BEIJING),
                                     cap=JOIN_CAP,
                                     device=dev)
            if plan:
                faults.arm(plan)
            try:
                return [(r.start, r.end, r.overflow,
                         [(p.obj_id, q.obj_id,
                           int(np.float32(d).view(np.uint32)))
                          for p, q, d in r.pairs])
                        for r in op.run(streams[0], streams[1], JOIN_R,
                                        driver=driver)]
            finally:
                faults.disarm()

        base = join_run()
        join_extract.launches = 0
        drv = WindowedDataflowDriver(retry=RetryPolicy(
            max_retries=DRV_JOIN_RETRIES, backoff_s=0.0))
        retried = join_run(drv, [{"point": "driver.window", "at": 2,
                                  "times": DRV_JOIN_RETRIES}])
        launches["join_extract"] = join_extract.launches
        if retried != base or not base or \
                drv.stats["retries"] != DRV_JOIN_RETRIES or \
                drv.backend != "device":
            raise AssertionError(f"32b: retried join differs or miscounted "
                                 f"({drv.stats})")
        if launches["join_extract"] < JOIN_OBJ_WINDOWS:
            raise AssertionError(
                f"32b: {launches['join_extract']} B3 launches")
        drv2 = WindowedDataflowDriver(retry=RetryPolicy(
            max_retries=DRV_JOIN_RETRIES, backoff_s=0.0), failover=True)
        try:
            join_run(drv2, [{"point": "driver.window", "at": 1,
                             "times": DRV_JOIN_RETRIES + 1}])
            raise AssertionError("32b: the bucketed join degraded")
        except InjectedFault:
            pass
        if drv2.stats["failovers"] != 0:
            raise AssertionError("32b: the bucketed join failed over")
        print(f"driver join retry (PointPointJoinQuery.run, WindowBased, "
              f"{JOIN_OBJ_WINDOWS} x {JOIN_OBJ_POINTS} Points a side): "
              f"driver.window failing {DRV_JOIN_RETRIES} times, "
              f"{drv.stats['retries']} retries, windows equal the unarmed "
              f"run; "
              f"launches join_extract={launches['join_extract']}; failing "
              f"{DRV_JOIN_RETRIES + 1} times with failover on: raised, "
              f"{drv2.stats['failovers']} failovers (no twin) [{card}]")
        walls["b"] = time.perf_counter() - t0

        # 32c: kNN failover at config 2's rate, device.dispatch dead from
        # window 2 on.
        t0 = time.perf_counter()
        kstream = knn_points(DRV_KNN_WINDOWS, KNN_RUN_WIN, 5)  # phase 15's
        query = knn_query("point")

        def knn_run(driver=None):
            op = PointPointKNNQuery(conf, UniformGrid(**BEIJING), device=dev)
            return list(op.run(iter(kstream), query, KNN_RUN_R, KNN_RUN_K,
                               driver=driver))

        want = knn_run()
        telemetry.enable()
        drv3 = WindowedDataflowDriver(retry=RetryPolicy(max_retries=0,
                                                        backoff_s=0.0))
        faults.arm([{"point": "device.dispatch", "at": DRV_KNN_FAIL_AT,
                     "times": 10**9}])
        try:
            got = knn_run(drv3)
        finally:
            faults.disarm()
        instants = [e["name"] for e in telemetry.events if e.get("ph") == "i"]
        fo_start = [e["args"]["window_start"] for e in telemetry.events
                    if e["name"] == "failover"]
        snap = telemetry.snapshot()
        telemetry.disable()
        if drv3.backend != "fallback" or drv3.stats["failovers"] != 1 or \
                "failover" not in instants or \
                snap["driver"]["failovers"] != 1:
            raise AssertionError(f"32c: failover not reported ({drv3.stats})")
        if len(got) != len(want) or len(got) != DRV_KNN_WINDOWS:
            raise AssertionError("32c: windows differ in number")
        exact = 0
        for a, b in zip(want, got):
            if (a.start, a.end) != (b.start, b.end) or \
                    [(o, e.obj_id) for o, _, e in a.neighbors] != \
                    [(o, e.obj_id) for o, _, e in b.neighbors]:
                raise AssertionError(f"32c: winners differ in {a.start}")
            da = np.float64([d for _, d, _ in a.neighbors])
            db = np.float64([d for _, d, _ in b.neighbors])
            if not np.allclose(da, db, rtol=3e-7, atol=0.0) or not len(da):
                raise AssertionError(f"32c: distances differ in {a.start}: "
                                     f"{len(da)} results")
            exact += bool(np.array_equal(da, db))
        print(f"driver kNN failover (PointPointKNNQuery.run, point query, "
              f"{DRV_KNN_WINDOWS} x {KNN_RUN_WIN} Points): device.dispatch "
              f"dead "
              f"from hit {DRV_KNN_FAIL_AT} (failover at the window starting "
              f"{fo_start[0]} ms), backend {drv3.backend}, "
              f"{drv3.stats['failovers']} failover (instant in the trace); "
              f"{len(got)} windows, the same ordered winners as the clean "
              f"card run, distances within rtol 3e-7 ({exact} of {len(got)} "
              f"windows "
              f"bit-equal) [{card}]")
        walls["c"] = time.perf_counter() - t0
    except BaseException:
        if smoke is not None:  # stop the background smoke too
            smoke.kill()
            smoke.communicate()
        raise

    # 32e: the chaos smoke, as a user runs it, on the card (started at the
    # phase's start).
    t0 = time.perf_counter()
    if smoke is not None:
        out, err = smoke.communicate(timeout=600)
        if smoke.returncode != 0:
            raise AssertionError(f"32e: chaos smoke exited "
                                 f"{smoke.returncode}\n{out[-2000:]}"
                                 f"{err[-2000:]}")
        walls["e"] = time.perf_counter() - t_smoke
        print(f"driver chaos smoke (python -m spatialflink_tpu_torch.driver "
              f"--chaos-smoke, three processes on the card, beside 32d, 32a, "
              f"32b and 32c): {out.strip().splitlines()[-1]} "
              f"({walls['e']:.3f} s from its start, "
              f"{time.perf_counter() - t0:.3f} s "
              f"waited for) [{card}]")
    print("phase walls: 32 " + f"{time.perf_counter() - t_phase:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f" s; e overlaps d, a, b and c) [{card}]")
    DRIVER_CHILDREN.clear()
    return launches


# ---------------------------------------------------------------------------
# Phase 33: overload control and SLOs.

OV_BATCH = 4             # the batch_slides rung's width (33a)
OV_PAIRS = 4             # alternating timed pairs, batched vs unbatched
OV_CUT_PANES = 7         # headline panes before the mid-batch checkpoint
OV_ADMIT_AT = 1000       # the overload.admit hit the armed leg raises at
OV_BR_WINDOWS = 8        # the breaker legs' windows (33c)
OV_BR_POINTS = 20_000    # Points a window on the breaker legs
OV_JOIN_WINDOWS = 8      # the B3 leg's windows (phase 9's stream, 250 ms)
OV_TP_PANES = 24         # the clamped pane-carry tJoin's panes a side (33d)


def overload_stream():
    """33c's stream: OV_BR_WINDOWS one-second windows of OV_BR_POINTS
    ``Point``s over the Beijing extent from seed 41, a third of them
    within 0.01 deg of ``QUERY``."""
    from spatialflink_tpu_torch.models.objects import Point

    n = OV_BR_WINDOWS * OV_BR_POINTS
    rng = np.random.default_rng(41)
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1)
    xy[::3] = np.float64(QUERY) + rng.uniform(-0.01, 0.01, (len(xy[::3]), 2))
    ts = (np.arange(n, dtype=np.int64) * 1000) // OV_BR_POINTS
    return [Point(obj_id=f"o{i % DRV_IDS}", timestamp=int(t), x=float(x),
                  y=float(y)) for i, (t, (x, y)) in enumerate(zip(ts, xy))]


def batching_controller(width=OV_BATCH):
    """A controller whose ladder is one batch_slides rung, stepped down by
    one violating SLO evaluation, installed."""
    from spatialflink_tpu_torch import overload

    ctrl = overload.install(overload.OverloadController(
        overload.OverloadPolicy(
            ladder=({"action": "batch_slides", "n": width},),
            degrade_cooldown=1)))
    ctrl.on_slo_evaluation(False)
    if overload.batch_slides() != width:
        raise AssertionError("33a: the batch_slides rung did not engage")
    return ctrl


def start_overload_smoke():
    """33e: ``python -m spatialflink_tpu_torch.overload --smoke`` on the
    card, started in the background from the checkout's root."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if k not in ("SFT_FAULT_PLAN", "SFT_PIPELINE",
                        "SFT_LEDGER_STREAM")}
    return subprocess.Popen(
        [sys.executable, "-m", "spatialflink_tpu_torch.overload",
         "--smoke"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def check_overload(card, panes, wf, gpu="cuda"):
    """Phase 33: overload control and the SLO engine on the card. Returns
    each kernel's launches over the phase's main runs. ``gpu="cpu"``
    rehearses it on the CPU (the launch checks then need the plain
    versions wrapped to count; the smoke child is skipped)."""
    import os
    import tempfile

    import torch

    from spatialflink_tpu_torch import overload, pipeline, slo
    from spatialflink_tpu_torch.checkpoint import (
        load_checkpoint,
        operator_state,
        restore_operator,
        save_checkpoint,
    )
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
        render_range_result,
    )
    from spatialflink_tpu_torch.faults import InjectedFault, faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        PointPointKNNQuery,
        PointPointRangeQuery,
        PointPolygonRangeQuery,
        QueryConfiguration,
        QueryType,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.streams.panes import (
        pane_spatial_bound,
        traj_stats_sliding,
    )
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
    from spatialflink_tpu_torch.telemetry import telemetry

    dev = torch.device(gpu)
    cpu = torch.device("cpu")
    launches = {}
    walls = {}
    tmp = tempfile.mkdtemp(prefix="sft_overload_")
    overload.uninstall()
    smoke = start_overload_smoke() if gpu == "cuda" else None
    t_phase = time.perf_counter()
    try:
        # 33a: batch_slides on the headline through B1, full width.
        t0 = time.perf_counter()
        wconf = QueryConfiguration(window_size=2.0, slide_step=1.0)
        q = Point(x=QUERY[0], y=QUERY[1])

        def wire_run(device, part=panes, op=None):
            op = op or PointPointKNNQuery(wconf, UniformGrid(**BEIJING),
                                          device=device)
            out = list(op.run_wire_panes(part, q, RADIUS, K, NUM_SEGMENTS,
                                         wf))
            if op.device.type == "cuda":
                torch.cuda.synchronize()
            return out

        def fetches_of(run):
            telemetry.enable()
            try:
                out = run()
                return out, sum(1 for e in telemetry.events
                                if e["name"] == "fetch")
            finally:
                telemetry.disable()

        n_points = sum(p.shape[1] for p in panes)
        base, f_plain = fetches_of(lambda: wire_run(dev))
        _, s_plain = counted_syncs(lambda: wire_run(dev), gpu)
        want = wire_run(cpu) if gpu == "cuda" else base
        check_windows(base, want, "33a unbatched")
        batching_controller()
        wire_digest.launches = 0
        got, f_batch = fetches_of(lambda: wire_run(dev))
        launches["wire_digest"] = wire_digest.launches
        _, s_batch = counted_syncs(lambda: wire_run(dev), gpu)
        check_windows(got, base, "33a batched")
        n_win = len(base)
        if f_plain != 2 * n_win or f_batch != -(-n_win // OV_BATCH):
            raise AssertionError(f"33a: {f_plain} / {f_batch} fetches over "
                                 f"{n_win} windows")
        if launches["wire_digest"] < len(panes):
            raise AssertionError(f"33a: {launches['wire_digest']} B1 "
                                 "launches")
        # A checkpoint with a batch open, restored into a fresh card op.
        first = PointPointKNNQuery(wconf, UniformGrid(**BEIJING), device=dev)
        gen = first.run_wire_panes(panes, q, RADIUS, K, NUM_SEGMENTS, wf)
        head = []
        for w in gen:
            head.append(w)
            if len(head) == OV_BATCH + 2:  # two windows of a batch out
                break
        gen.close()
        state = operator_state(first)
        cut = int(state["knn_wire_pane_carry"]["next_pane"])
        path = os.path.join(tmp, "wire.ckpt")
        save_checkpoint(path, op=state)
        resumed = PointPointKNNQuery(wconf, UniformGrid(**BEIJING),
                                     device=dev)
        restore_operator(resumed, load_checkpoint(path)["op"])
        rest = wire_run(dev, panes[cut:], resumed)
        check_windows(head + rest, base, "33a mid-batch resume")
        # Timed pairs, alternating, then each traced once.
        rates = {"unbatched": [], "batched": []}
        for _ in range(OV_PAIRS):
            for label in ("unbatched", "batched"):
                overload.uninstall()
                if label == "batched":
                    batching_controller()
                t1 = time.perf_counter()
                wire_run(dev)
                rates[label].append(n_points / (time.perf_counter() - t1))
        idle = {}
        for label in ("unbatched", "batched"):
            overload.uninstall()
            if label == "batched":
                batching_controller()
            if gpu == "cuda":
                wall, busy, _ = trace_busy(lambda: wire_run(dev))
                idle[label] = f"{100 - 100 * busy / wall:.1f}%"
            else:
                idle[label] = "not measured"
        overload.uninstall()
        med = {k: statistics.median(v) for k, v in rates.items()}
        print(f"overload batch_slides (run_wire_panes, headline: {len(panes)} "
              f"panes of {SLIDE}, k={K}, r={RADIUS}; ladder "
              f"[batch_slides n={OV_BATCH}] stepped down by one violating "
              f"SLO evaluation): {n_win} windows bit-equal batched, "
              f"unbatched and on the CPU; telemetry.fetch calls a window "
              f"{f_plain / n_win:g} unbatched, {f_batch / n_win:g} batched; "
              f"synchronising calls a window {s_plain / n_win:g} / "
              f"{s_batch / n_win:g}; checkpoint with a batch open after "
              f"{len(head)} windows (carry at pane {cut}), restored on the "
              f"card: no window lost; launches wire_digest="
              f"{launches['wire_digest']} [{card}]")
        print(f"overload batch_slides e2e ({OV_PAIRS} alternating pairs, "
              f"{n_points} points a run): unbatched "
              + ", ".join(f"{r:.1f}" for r in rates["unbatched"])
              + " points/s (median {:.1f}), batched ".format(med["unbatched"])
              + ", ".join(f"{r:.1f}" for r in rates["batched"])
              + f" points/s (median {med['batched']:.1f}), ratio "
              f"{med['batched'] / med['unbatched']:.4f}; device idle "
              f"(one traced run each) {idle['unbatched']} / "
              f"{idle['batched']} [{card}]")
        walls["a"] = time.perf_counter() - t0

        # 33b: admission shedding through B4 at config 3's width, with the
        # SLO engine installed over 33b and 33c (33e reads its verdict).
        t0 = time.perf_counter()
        stream = driver_range_stream()
        queries = range_polygons()
        rconf = QueryConfiguration(window_size=1.0, slide_step=1.0)
        spec = slo.SloSpec(
            name="phase-33", shed_budget=RANGE_WIN // 2,
            degraded_window_budget=4, retry_budget=0, failover_budget=0,
            watermark_lag_p99_ms=1000.0, e2e_p99_ms=60_000.0,
            eval_interval_s=0.0, warmup_windows=1)

        def shed_leg(device, workdir, plan=None):
            """Returns (egress, overload snapshot, driver stats, commit
            ms list, run s)."""
            commits = []

            class TimedDriver(WindowedDataflowDriver):
                def _commit(self, final=False):
                    t = time.perf_counter()
                    super()._commit(final)
                    commits.append((time.perf_counter() - t) * 1e3)

            os.makedirs(workdir, exist_ok=True)
            sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
            ctrl = overload.OverloadController(overload.OverloadPolicy(
                max_buffered_events=RANGE_WIN // 2))
            drv = TimedDriver(
                checkpoint_path=os.path.join(workdir, "ckpt.bin"),
                checkpoint_every=1, sink=sink,
                retry=RetryPolicy(max_retries=0, backoff_s=0.0),
                failover=False, overload=ctrl, source_pausable=False)
            op = PointPolygonRangeQuery(rconf, UniformGrid(**BEIJING),
                                        device=device)
            if plan:
                faults.arm(plan)
            t1 = time.perf_counter()
            try:
                for res in op.run(iter(stream), queries, RANGE_R,
                                  driver=drv):
                    for line in render_range_result(res):
                        sink.stage(line)
            finally:
                faults.disarm()
            if op.device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t1
            with open(os.path.join(workdir, "egress.csv"), "rb") as f:
                egress = f.read()
            return egress, ctrl.snapshot(), drv.stats, commits, secs, drv

        def slo_session(label, device, run):
            """``run()`` under a fresh SLO engine and a ledger stream;
            returns (run's result, the sealed verdict)."""
            stream_path = os.path.join(tmp, f"{label}.stream.jsonl")
            telemetry.enable(stream_path=stream_path,
                             stream_flush_interval_s=0.0)
            eng = slo.install(slo.SloEngine(spec))
            try:
                out = run()
            finally:
                telemetry.disable()  # seals: the verdict in the epilogue
                slo.uninstall()
                overload.uninstall()
            with open(stream_path) as f:
                last = json.loads(f.read().splitlines()[-1])
            if last.get("t") != "epilogue" or "slo" not in last:
                raise AssertionError(f"33e: {label}: no verdict sealed")
            return out, last["slo"], eng

        def breaker_policy():
            return overload.OverloadPolicy(breaker_failures=2,
                                           breaker_probe_every=3)

        bstream = overload_stream()
        bq = [Point(x=QUERY[0], y=QUERY[1])]

        def breaker_leg(device, pol=None, plan=None, driver=True, ckpt=None):
            """PointPointRangeQuery.run over 33c's stream: (windows with the
            breaker_collapsed() reading at each yield, controller, driver).
            ``ckpt``: a checkpoint path, committed every window."""
            ctrl = overload.OverloadController(breaker_policy()) \
                if driver else None
            drv = WindowedDataflowDriver(
                retry=RetryPolicy(max_retries=0, backoff_s=0.0),
                overload=ctrl, pipeline=pol,
                checkpoint_path=ckpt) if driver else None
            op = PointPointRangeQuery(rconf, UniformGrid(**BEIJING),
                                      device=device)
            if plan:
                faults.arm(plan)
            try:
                out = [((r.start, [p.obj_id for p in r.objects],
                         np.asarray(r.dists, np.float32).view(
                             np.uint32).tolist()),
                        pipeline.breaker_collapsed())
                       for r in op.run(iter(bstream), bq, PP_R,
                                       driver=drv)]
            finally:
                faults.disarm()
            return out, ctrl, drv

        sync_plan = [{"point": "driver.window", "at": 1, "times": 2}]

        def slo_runs(device, workdir):
            # 33c's sync breaker leg first (a checkpoint a window, so the
            # commit stage is stamped), then 33b's clean run, whose
            # controller stays installed: the live evaluations read each
            # run's controller, the verdict's last evaluation 33b's.
            os.makedirs(workdir, exist_ok=True)
            br = breaker_leg(device, plan=sync_plan,
                             ckpt=os.path.join(workdir, "breaker.ckpt"))
            overload.uninstall()
            return shed_leg(device, workdir), br

        sub = {"data": time.perf_counter() - t0}
        t1 = time.perf_counter()
        polyline_min_dist.launches = 0
        (shed_card, br_card), v_card, _ = slo_session(
            "card", dev, lambda: slo_runs(dev, os.path.join(tmp, "clean")))
        sub["card"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        clean, cl_snap, cl_stats, cl_commits, cl_secs, _ = shed_card
        br_sync, br_ctrl, br_drv = br_card
        launches["polyline_min_dist"] = polyline_min_dist.launches
        (shed_cpu, br_cpu), v_cpu, _ = slo_session(
            "cpu", cpu, lambda: slo_runs(cpu, os.path.join(tmp, "cpu")))
        on_cpu, cpu_snap = shed_cpu[0], shed_cpu[1]
        sub["CPU"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        lines = clean.count(b"\n")
        shed = cl_snap["shed"].get("admission", {}).get("events", 0)
        if not clean or shed <= 0 or cl_stats["shed"] != cl_snap["shed_total"]:
            raise AssertionError(f"33b: nothing shed ({cl_snap})")
        if clean != on_cpu or cl_snap != cpu_snap:
            raise AssertionError("33b: egress or overload block differ from "
                                 f"the CPU run: {cl_snap} vs {cpu_snap}")
        if launches["polyline_min_dist"] < DRV_WINDOWS:
            raise AssertionError(f"33b: {launches['polyline_min_dist']} B4 "
                                 "launches")
        # Stopped right after window 1's commit, resumed by a fresh driver.
        try:
            shed_leg(dev, os.path.join(tmp, "chaos"), plan=[
                {"point": "driver.window", "at": 2, "times": 10_000}])
            raise AssertionError("33b: the armed run was not stopped")
        except InjectedFault:
            pass
        with open(os.path.join(tmp, "chaos", "egress.csv"), "rb") as f:
            torn = f.read()
        resumed, rs_snap, rs_stats, rs_commits, rs_secs, _ = shed_leg(
            dev, os.path.join(tmp, "chaos"))
        overload.uninstall()
        if not (0 < len(torn) < len(clean)) or resumed != clean or \
                rs_snap["shed"] != cl_snap["shed"] or not rs_stats["resumed"]:
            raise AssertionError(f"33b: the resumed run differs: {rs_snap}")
        sub["stop and resume"] = time.perf_counter() - t1
        # overload.admit raises where the JAX controller raises: on the
        # armed hit's item, before its admission decision.
        ctrl_a = overload.OverloadController(overload.OverloadPolicy(
            max_buffered_events=RANGE_WIN // 2))
        drv_a = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0), failover=False,
            overload=ctrl_a, source_pausable=False)
        faults.arm([{"point": "overload.admit", "at": OV_ADMIT_AT}])
        try:
            list(PointPolygonRangeQuery(
                rconf, UniformGrid(**BEIJING), device=dev).run(
                    iter(stream), queries, RANGE_R, driver=drv_a))
            raise AssertionError("33b: the armed admit did not raise")
        except InjectedFault:
            pass
        finally:
            faults.disarm()
            overload.uninstall()
        admitted = ctrl_a.state()["backlog_events"]
        if drv_a._consumed != OV_ADMIT_AT or admitted != OV_ADMIT_AT - 1:
            raise AssertionError(f"33b: admit raised at item "
                                 f"{drv_a._consumed}, {admitted} admitted")
        print(f"overload shedding (PointPolygonRangeQuery.run, config 3: "
              f"{DRV_WINDOWS} x {RANGE_WIN} Points, {RANGE_POLYS} polygons, "
              f"r={RANGE_R}; non-pausable source, max_buffered_events "
              f"{RANGE_WIN // 2}, checkpoint_every=1): shed "
              f"{json.dumps(cl_snap['shed'])} (shed_total "
              f"{cl_snap['shed_total']}, rung {cl_snap['rung']}, "
              f"backpressure {cl_snap['backpressure_engaged']}), "
              f"{lines} egress lines, {len(clean)} B in "
              f"{cl_secs:.3f} s; commits "
              + ", ".join(f"{ms:.3f}" for ms in cl_commits)
              + f" ms; launches polyline_min_dist="
              f"{launches['polyline_min_dist']}; the CPU run's egress and "
              f"overload block equal; stopped by driver.window at window 2 "
              f"({len(torn)} B committed), resumed by a fresh driver in "
              f"{rs_secs:.3f} s (commits "
              + ", ".join(f"{ms:.3f}" for ms in rs_commits)
              + f" ms): egress and sheds byte-identical; overload.admit "
              f"armed at hit {OV_ADMIT_AT} raised on item {drv_a._consumed} "
              f"with {admitted} admitted before it; walls "
              + ", ".join(f"{k} {v:.3f} s" for k, v in sub.items())
              + f" (card and CPU: 33c's breaker leg, then 33b's run) "
              f"[{card}]")
        walls["b"] = time.perf_counter() - t0

        # 33c: the circuit breaker; the twin routes on the point range,
        # B4 and B3 under a breaker policy where no twin exists.
        t0 = time.perf_counter()
        base_c, _, _ = breaker_leg(dev, driver=False)
        base_w = [w for w, _ in base_c]

        def check_breaker(label, got, ctrl, drv):
            if [w for w, _ in got] != base_w or len(base_w) < 6:
                raise AssertionError(f"33c {label}: windows differ")
            if ctrl.breaker.snapshot() != {
                    "state": "closed", "opens": 1, "probes": 1,
                    "consecutive_failures": 0} or drv.backend != "device" \
                    or drv.stats["failovers"] != 0 \
                    or ctrl.degraded_windows != 4:
                raise AssertionError(f"33c {label}: breaker "
                                     f"{ctrl.snapshot()}, {drv.stats}")
            seen = [c for _, c in got][:5]
            if seen != [False, True, True, True, False]:
                raise AssertionError(f"33c {label}: breaker_collapsed() at "
                                     f"the yields {seen}")

        check_breaker("sync", br_sync, br_ctrl, br_drv)
        telemetry.enable()
        got_p, ctrl_p, drv_p = breaker_leg(
            dev, pol=pipeline.PipelinePolicy(depth=2, fetch_lag=1),
            plan=[{"point": "pipeline.ship", "at": 1, "times": 2}]
            + sync_plan)
        pipe = dict(telemetry.snapshot().get("pipeline", {}))
        telemetry.disable()
        overload.uninstall()
        check_breaker("pipelined", got_p, ctrl_p, drv_p)
        if pipe.get("collapses") != 1 or pipe.get("resumes") != 1 \
                or not pipe.get("overlapped"):
            raise AssertionError(f"33c: pipeline counters {pipe}")
        # The naive join (its twin) through the same round trip.
        jstreams = join_objects()
        nconf = QueryConfiguration(QueryType.RealTimeNaive, window_size=1.0,
                                   slide_step=1.0, realtime_batch_ms=100)

        def naive_run(driver=None, plan=None):
            op = PointPointJoinQuery(nconf, UniformGrid(**BEIJING),
                                     cap=JOIN_CAP, device=dev)
            if plan:
                faults.arm(plan)
            try:
                return [((r.start, sorted(
                    (p.obj_id, b.obj_id, int(np.float32(d).view(np.uint32)))
                    for p, b, d in r.pairs)), pipeline.breaker_collapsed())
                    for r in op.run(jstreams[0], jstreams[1], JOIN_R,
                                    driver=driver)]
            finally:
                faults.disarm()

        base_j = [w for w, _ in naive_run()]
        ctrl_j = overload.OverloadController(breaker_policy())
        drv_j = WindowedDataflowDriver(
            retry=RetryPolicy(max_retries=0, backoff_s=0.0), overload=ctrl_j,
            pipeline=pipeline.PipelinePolicy(depth=2, fetch_lag=1))
        got_j = naive_run(drv_j, sync_plan)
        overload.uninstall()
        if [w for w, _ in got_j] != base_j or len(base_j) < 6 or \
                ctrl_j.degraded_windows != 4 or drv_j.backend != "device" \
                or [c for _, c in got_j][:5] != [False, True, True, True,
                                                 False]:
            raise AssertionError(f"33c join: {ctrl_j.snapshot()}")
        # B4 and B3 with a breaker configured: no twin, so the breaker
        # never routes (the reference's semantics) and each window is
        # answered on the device.
        polyline_min_dist.launches = 0
        b4_base = [(r.start, [p.obj_id for p in r.objects])
                   for r in PointPolygonRangeQuery(
                       rconf, UniformGrid(**BEIJING), device=dev).run(
                           iter(bstream), queries, RANGE_R)]
        b4_plain = polyline_min_dist.launches
        polyline_min_dist.launches = 0
        ctrl_4 = overload.OverloadController(breaker_policy())
        b4_got = [(r.start, [p.obj_id for p in r.objects])
                  for r in PointPolygonRangeQuery(
                      rconf, UniformGrid(**BEIJING), device=dev).run(
                          iter(bstream), queries, RANGE_R,
                          driver=WindowedDataflowDriver(overload=ctrl_4))]
        b4_launches = polyline_min_dist.launches
        overload.uninstall()
        launches["polyline_min_dist"] += b4_launches
        jconf = QueryConfiguration(window_size=2.0 / OV_JOIN_WINDOWS,
                                   slide_step=2.0 / OV_JOIN_WINDOWS)

        def b3_run(driver=None):
            return [(r.start, r.overflow, sorted(
                (p.obj_id, b.obj_id, int(np.float32(d).view(np.uint32)))
                for p, b, d in r.pairs))
                for r in PointPointJoinQuery(
                    jconf, UniformGrid(**BEIJING), cap=JOIN_CAP,
                    device=dev).run(jstreams[0], jstreams[1], JOIN_R,
                                    driver=driver)]

        b3_base = b3_run()
        join_extract.launches = 0
        ctrl_3 = overload.OverloadController(breaker_policy())
        b3_got = b3_run(WindowedDataflowDriver(
            overload=ctrl_3,
            pipeline=pipeline.PipelinePolicy(depth=2, fetch_lag=1)))
        launches["join_extract"] = join_extract.launches
        overload.uninstall()
        if b4_got != b4_base or b4_launches != len(b4_got) or \
                b4_plain != b4_launches or b3_got != b3_base or \
                launches["join_extract"] != len(b3_got) or \
                len(b3_got) < 6 or ctrl_4.breaker.opens or ctrl_3.breaker.opens:
            raise AssertionError(
                f"33c: B4 {b4_launches} launches / {len(b4_got)} windows, "
                f"B3 {launches['join_extract']} / {len(b3_got)}")
        print(f"overload circuit breaker (breaker_failures=2, "
              f"breaker_probe_every=3; driver.window failing the first 2 "
              f"device windows): PointPointRangeQuery.run over "
              f"{OV_BR_WINDOWS} x {OV_BR_POINTS} Points (r={PP_R}): opened "
              f"at window 2, windows 3-4 on the numpy twin with no device "
              f"attempt, the probe at window 5 closed it; backend device, 0 "
              f"failovers, degraded_windows 4; windows equal the clean card "
              f"run, sync and pipelined (pipeline.ship failing too: "
              f"breaker_collapsed() true at the yields of windows 2-4, "
              f"pipeline counters {json.dumps(pipe)}); the naive join "
              f"(PointPointJoinQuery.run, RealTimeNaive, 100 ms batches of "
              f"phase 9's 2 x {JOIN_OBJ_POINTS} Points: {len(base_j)} "
              f"windows) the same round trip, equal; with a breaker "
              f"configured and no twin, PointPolygonRangeQuery.run "
              f"({len(b4_got)} windows) launched polyline_min_dist="
              f"{b4_launches} and PointPointJoinQuery.run (WindowBased, "
              f"{len(b3_got)} windows of {2000 // OV_JOIN_WINDOWS} ms) "
              f"join_extract={launches['join_extract']}, one a window, "
              f"windows equal the runs without a controller [{card}]")
        walls["c"] = time.perf_counter() - t0

        # 33d: the ladder's other rungs.
        t0 = time.perf_counter()
        ts, xy, oid = tstats_stream()
        # Both engines on the float32 coordinates the device engine reads.
        xy32 = xy.astype(np.float32).astype(np.float64)
        args = (ts, xy32, oid, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS)
        t1 = time.perf_counter()
        dev_eng = traj_stats_sliding(*args, backend="device", device=dev)
        dev_s = time.perf_counter() - t1
        ctrl_d = overload.install(overload.OverloadController(
            overload.OverloadPolicy(
                ladder=({"action": "pane_backend", "to": "numpy"},),
                degrade_cooldown=1)))
        ctrl_d.on_slo_evaluation(False)
        t1 = time.perf_counter()
        host_eng = traj_stats_sliding(*args, backend="auto", device=dev)
        host_s = time.perf_counter() - t1
        overload.uninstall()
        err, rel = check_pane_windows(dev_eng, host_eng,
                                      pane_spatial_bound(*args), "33d")
        chunks = tpanes_stream()
        cut_tp = [[{k: v[:OV_TP_PANES * TP_PANE_PTS]
                    for k, v in side[0].items()}] for side in chunks]
        plain_tp, plain_s, plain_op = run_tjoin_panes(gpu, cut_tp)
        ctrl_t = overload.install(overload.OverloadController(
            overload.OverloadPolicy(
                ladder=({"action": "clamp_compaction", "cap": 0},),
                degrade_cooldown=1)))
        ctrl_t.on_slo_evaluation(False)
        clamp_tp, clamp_s, clamp_op = run_tjoin_panes(gpu, cut_tp)
        overload.uninstall()
        if len(clamp_tp) != len(plain_tp) or not all(
                same_window(a, b) for a, b in zip(clamp_tp, plain_tp)):
            raise AssertionError("33d: clamped tJoin windows differ")
        if clamp_op.pane_scans[0][2] != TP_CAP_W:
            raise AssertionError(f"33d: clamp took {clamp_op.pane_scans}")
        print(f"overload rungs: pane_backend (to numpy) routes "
              f"traj_stats_sliding(backend='auto') at bench_tstats_pane "
              f"({TS_POINTS} points) to the host engines, the native one "
              f"first as in the JAX package ({host_s:.3f} s; "
              f"the device engine {dev_s:.3f} s): starts, counts and "
              f"temporal sums exact, spatial within pane_spatial_bound (max "
              f"err {err:.3e}, {rel:.3f} of the bound); clamp_compaction "
              f"(cap 0) on run_soa_panes at phase 26's shape cut to "
              f"{OV_TP_PANES} panes a side ({len(plain_tp)} windows): "
              f"capacity rung {plain_op.pane_scans[0][2]} (occupancy "
              f"{plain_op.pane_occupancy}) unclamped in {plain_s:.3f} s, "
              f"{clamp_op.pane_scans[0][2]} clamped in {clamp_s:.3f} s, "
              f"windows equal [{card}]")
        walls["d"] = time.perf_counter() - t0

        # 33e: the SLO verdicts (sealed above) and the smoke.
        t0 = time.perf_counter()
        rows = {r["check"]: r["ok"] for r in v_card["checks"]}
        if rows != {r["check"]: r["ok"] for r in v_cpu["checks"]} or \
                sorted(v["check"] for v in v_card["violations"]) != \
                sorted(v["check"] for v in v_cpu["violations"]) or \
                set(rows) != {"shed_budget", "degraded_window_budget",
                              "retry_budget", "failover_budget",
                              "watermark_lag_p99_ms", "e2e_p99_ms"}:
            raise AssertionError(f"33e: verdicts differ: {v_card} vs "
                                 f"{v_cpu}")
        print(f"overload SLO verdict (sealed in the ledger stream's "
              f"epilogue over 33c's sync breaker run, checkpointed every "
              f"window, then 33b's clean run): "
              f"ok {v_card['ok']}, {v_card['windows']} windows, checks "
              + ", ".join(f"{r['check']} {r['value']!r} {r['bound']} "
                          f"{'pass' if r['ok'] else 'FAIL'}"
                          for r in v_card["checks"])
              + "; violations " + ", ".join(
                  f"{v['check']} at window {v['window_seq']}"
                  for v in v_card["violations"])
              + f"; every check as the CPU run's [{card}]")
        if smoke is not None:
            out, err_s = smoke.communicate(timeout=300)
            if smoke.returncode != 0:
                raise AssertionError(f"33e: overload smoke exited "
                                     f"{smoke.returncode}\n{out[-2000:]}"
                                     f"{err_s[-2000:]}")
            print(f"overload smoke (python -m spatialflink_tpu_torch.overload"
                  f" --smoke, on the card, beside 33a-33d): "
                  f"{out.strip().splitlines()[-1]} ({time.perf_counter() - t0:.3f}"
                  f" s waited for) [{card}]")
            smoke = None
        walls["e"] = time.perf_counter() - t0
    finally:
        overload.uninstall()
        slo.uninstall()
        if smoke is not None:  # stop the background smoke too
            smoke.kill()
            smoke.communicate()
    print("phase walls: 33 " + f"{time.perf_counter() - t_phase:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f" s; the smoke runs beside a-d) [{card}]")
    return launches


QS_QUERIES = 1024        # standing queries (bench_suite.py:560-700)
QS_QUERY_SEED = 37       # the suite's query seed
QS_STREAM_SEED = 41      # the suite's _stream seed (bench_suite.py:47-54)
QS_WIN = 131_072         # points a window
QS_WINDOWS = 8           # 34a's windows
QS_CHURN = 16            # queries swapped in each bucket every window
QS_IDS = 16_384          # the stream's objIDs, the program's num_segments
QS_CAP = 1024            # the bucket-capacity ceiling (qserve.QUERY_CAP_MAX)
QS_CPU_WINDOWS = (0, 7)  # 34a's windows held against the CPU run (a cut)
QS_OP_WINDOWS = 2        # 34b's windows of Point objects (a cut of 8)
QS_FIRE_MAX = 100        # 34b: the "firehose" class's standing-query budget
QS_BULK_ROWS = 200       # 34b: the "bulk" class's result rows a window


def qserve_query(rng, i):
    """The JAX suite's qserve_1024q_mixed query ``i`` (its ``mk_query``):
    half range and half kNN, k = (32, 5, 10, 30)[i % 4], radius = (0.002,
    0.02, 0.05)[i % 3] deg, tenant t{i % 97}."""
    from spatialflink_tpu_torch.qserve import StandingQuery

    return StandingQuery(
        qid=f"q{i}", tenant=f"t{i % 97}",
        kind="range" if i % 2 == 0 else "knn",
        x=float(rng.uniform(115.6, 117.5)), y=float(rng.uniform(39.7, 41.0)),
        radius=float((0.002, 0.02, 0.05)[i % 3]), k=(32, 5, 10, 30)[i % 4])


class QServeSuite:
    """34a's standing-query set and its churn, made anew from the query
    seed for each run: the 1,024 queries bucketed by ``bucket_key``; each
    ``churn()`` swaps the oldest QS_CHURN queries of every bucket for
    fresh positions at the same kind, k and radius (the suite's
    ``churn_buckets``), so the occupancy and the rungs stay put."""

    def __init__(self, grid):
        from spatialflink_tpu_torch.qserve import bucket_key

        self.grid = grid
        self.rng = np.random.default_rng(QS_QUERY_SEED)
        self.buckets = {}
        for i in range(QS_QUERIES):
            q = qserve_query(self.rng, i)
            self.buckets.setdefault(bucket_key(q), []).append(q)
        self.next_id = QS_QUERIES
        self._flags = {}

    def flags_of(self, q):
        key = (q.x, q.y, q.radius)
        if key not in self._flags:
            self._flags[key] = self.grid.neighbor_flags(
                q.radius, [self.grid.flat_cell(q.x, q.y)])
        return self._flags[key]

    def churn(self):
        from spatialflink_tpu_torch.qserve import StandingQuery

        for key in sorted(self.buckets):
            qs = self.buckets[key]
            for _ in range(min(QS_CHURN, len(qs))):
                old = qs.pop(0)
                fresh = qserve_query(self.rng, self.next_id)
                self.next_id += 1
                qs.append(StandingQuery(
                    qid=f"q{self.next_id}", tenant=fresh.tenant,
                    kind=old.kind, x=fresh.x, y=fresh.y, radius=old.radius,
                    k=old.k))


def qserve_points():
    """The suite's ``_stream(8 x 131,072, seed=41)``: float64 positions
    over the Beijing extent and 16,384 objIDs (the suite casts the
    positions to float32 uncentred; the port centres in float64 first,
    ``center_coords``)."""
    n = QS_WINDOWS * QS_WIN
    rng = np.random.default_rng(QS_STREAM_SEED)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1)
    oid = rng.integers(0, QS_IDS, n).astype(np.int32)
    return xy, oid


def qserve_registry_setup(device, grid):
    """34a's set-up on ``device``, as the suite stages before it times:
    the query set and its flag tables, and every bucket staged
    (pick_capacity, bucket_host_arrays, ``ship``). The radius ships as
    float32, as the suite's ``stage_bucket`` casts it. Returns (suite,
    stage, staged)."""
    from spatialflink_tpu_torch.operators.base import center_coords, ship
    from spatialflink_tpu_torch.ops.compaction import pick_capacity
    from spatialflink_tpu_torch.qserve import bucket_host_arrays

    suite = QServeSuite(grid)

    def stage(qs):
        cap = pick_capacity(len(qs), QS_CAP, minimum=8)
        qxy, radius, qvalid, tables = bucket_host_arrays(
            grid, qs, cap, flags_of=suite.flags_of)
        t, r, v, q = ship(tables, radius.astype(np.float32), qvalid,
                          center_coords(grid, qxy), device=device).arrive()
        return {"cap": cap, "tables": t, "radius": r, "qvalid": v, "qxy": q}

    staged = {key: stage(qs) for key, qs in suite.buckets.items()}
    return suite, stage, staged


def qserve_registry_run(device, setup, win_args, dispatch=None, keep=()):
    """34a's windows on ``device`` from ``setup`` (``qserve_registry_
    setup``), as the suite times them: per window churn (windows 1-7,
    the restaging of every churned bucket timed on the host), ship the
    window's points and launch every bucket's ``registry_bucket_kernel``
    (through ``jitted``); one ``telemetry.fetch`` after the last window.
    ``dispatch``: the windows whose buckets run (default all). Returns
    (per window: [(key, queries, staged arrays, fetched)] for windows in
    ``keep``, else None; churn ms a window; window point tensors kept)."""
    from spatialflink_tpu_torch.operators.base import jitted, ship
    from spatialflink_tpu_torch.ops.query_registry import (
        registry_bucket_kernel,
    )
    from spatialflink_tpu_torch.telemetry import telemetry

    suite, stage, staged = setup
    kernel = jitted(registry_bucket_kernel)
    pending, kept, churn_ms, points = [], {}, [], {}
    for w in range(QS_WINDOWS):
        if w:
            t0 = time.perf_counter()
            suite.churn()
            staged = {key: stage(qs) for key, qs in suite.buckets.items()}
            churn_ms.append((time.perf_counter() - t0) * 1e3)
        if dispatch is not None and w not in dispatch:
            continue
        xy_d, valid_d, cell_d, oid_d = ship(*win_args[w],
                                            device=device).arrive()
        for key in sorted(staged):
            b = staged[key]
            r = kernel(xy_d, valid_d, cell_d, b["tables"], oid_d, b["qxy"],
                       b["radius"], b["qvalid"], k=int(key[1]),
                       num_segments=QS_IDS, query_block=min(b["cap"], 32))
            pending.append((r.num_valid, r.within, r.segment, r.index,
                            r.dist))
        if w in keep:
            points[w] = (xy_d, valid_d, cell_d, oid_d)
            kept[w] = [(key, list(suite.buckets[key]), staged[key])
                       for key in sorted(staged)]
    fetched = iter(telemetry.fetch(pending))
    out = []
    for w in range(QS_WINDOWS):
        if dispatch is not None and w not in dispatch:
            out.append(None)
            continue
        window = [next(fetched) for _ in range(len(staged))]
        out.append([(*kb, f) for kb, f in zip(kept[w], window)]
                   if w in kept else None)
    return out, churn_ms, points


def qserve_command_stream(points_xy, oid):
    """34b's stream: the 1,024 queries' boot registrations (one class in
    eight is "firehose", over its standing-query budget; another "bulk",
    over its result budget), QS_OP_WINDOWS one-second windows of QS_WIN
    ``Point``s at 34a's first positions, and churn inside each window:
    16 unregistrations and 16 registrations at fresh positions halfway
    through it."""
    import dataclasses

    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.qserve import QServeCommand, boot_commands

    rng = np.random.default_rng(QS_QUERY_SEED)
    classes = {0: "firehose", 1: "bulk"}
    queries = [dataclasses.replace(qserve_query(rng, i),
                                   tenant_class=classes.get(i % 8, "default"))
               for i in range(QS_QUERIES)]
    out = list(boot_commands(queries))
    n = QS_OP_WINDOWS * QS_WIN
    for w in range(QS_OP_WINDOWS):
        mid = w * 1000 + 500
        for j in range(QS_CHURN):
            old = queries[w * QS_CHURN + j]
            out.append(QServeCommand(timestamp=mid, action="unregister",
                                     uid=f"u{w}:{old.qid}", qid=old.qid))
            fresh = dataclasses.replace(
                qserve_query(rng, QS_QUERIES + w * QS_CHURN + j),
                tenant_class=old.tenant_class)
            out.append(QServeCommand(timestamp=mid, action="register",
                                     uid=f"r{w}:{fresh.qid}", query=fresh))
    cmds = sorted(out[QS_QUERIES:], key=lambda c: c.timestamp)
    events = out[:QS_QUERIES]
    ts = (np.arange(n, dtype=np.int64) * 1000) // QS_WIN
    for i in range(n):
        t = int(ts[i])
        while cmds and cmds[0].timestamp <= t:
            events.append(cmds.pop(0))
        events.append(Point(obj_id=f"o{int(oid[i])}", timestamp=t,
                            x=float(points_xy[i, 0]),
                            y=float(points_xy[i, 1])))
    return events + cmds


def check_qserve(card, gpu="cuda"):
    """Phase 34: standing-query serving (``qserve.py``,
    ``ops/query_registry.py``) on the card. (a) The registry bucket
    program at the JAX suite's qserve_1024q_mixed; (b) ``QServeOperator``
    through the driver with tenant budgets, an SLO verdict and a stop and
    resume. ``gpu="cpu"`` rehearses it on the CPU (the trace is skipped).
    Returns the phase's walls."""
    import os
    import tempfile

    import torch

    from spatialflink_tpu_torch import overload, qserve, slo
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )
    from spatialflink_tpu_torch.faults import InjectedFault, faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration
    from spatialflink_tpu_torch.operators.base import center_coords
    from spatialflink_tpu_torch.ops.compaction import capacity_ladder
    from spatialflink_tpu_torch.ops.knn import F32_BIG, knn_points_fused
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink
    from spatialflink_tpu_torch.telemetry import telemetry

    dev = torch.device(gpu)
    cpu = torch.device("cpu")
    grid = UniformGrid(**BEIJING)
    walls = {}
    t_phase = t0 = time.perf_counter()
    # 34a: the registry program.
    xy, oid = qserve_points()
    cell = grid.assign_cells_np(xy).astype(np.int32)
    win_args = []
    for w in range(QS_WINDOWS):
        sl = slice(w * QS_WIN, (w + 1) * QS_WIN)
        win_args.append((center_coords(grid, xy[sl]), np.ones(QS_WIN, bool),
                         cell[sl], oid[sl]))
    walls["data"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    telemetry.enable()
    try:
        got, churn_ms, pts = qserve_registry_run(
            dev, qserve_registry_setup(dev, grid), win_args,
            keep=range(QS_WINDOWS))
        sigs = telemetry.distinct_shapes("registry_bucket_kernel")
    finally:
        telemetry.disable()
    buckets = got[0]
    k_rungs = {key[1] for key, *_ in buckets}
    caps = {key: b["cap"] for key, _, b, _ in buckets}
    if len(buckets) != 12 or sigs > len(capacity_ladder(QS_CAP, 8)) * \
            len(k_rungs):
        raise AssertionError(f"34a: {len(buckets)} buckets, {sigs} "
                             "signatures")
    # Padded lanes empty, and every live lane equal to the query run
    # alone through knn_points_fused on the card (its radius the float32
    # one the bucket compares, its k the bucket's rung).
    n_live = n_lanes = 0
    for w, window in enumerate(got):
        xy_d, valid_d, cell_d, oid_d = pts[w]
        singles = []
        for key, qs, b, (nv, within, seg, idx, dist) in window:
            live = len(qs)
            n_live += live
            n_lanes += b["cap"]
            if (nv[live:] != 0).any() or (within[live:] != 0).any() or \
                    (seg[live:] != -1).any() or (idx[live:] != -1).any() \
                    or (dist[live:] != F32_BIG).any():
                raise AssertionError(f"34a: window {w} {key}: a padded lane "
                                     "is not empty")
            for lane in range(live):
                r = knn_points_fused(
                    xy_d, valid_d, cell_d, b["tables"][lane], oid_d,
                    b["qxy"][lane], b["radius"][lane:lane + 1],
                    int(key[1]), QS_IDS)
                singles.append((r.dist, r.segment, r.index, r.num_valid))
        host = telemetry.fetch(singles)
        i = 0
        for key, qs, b, (nv, within, seg, idx, dist) in window:
            for lane in range(len(qs)):
                sd, ss, si, snv = host[i]
                i += 1
                if not (np.array_equal(sd.view(np.uint32),
                                       dist[lane].view(np.uint32))
                        and np.array_equal(ss, seg[lane])
                        and np.array_equal(si, idx[lane])
                        and int(snv) == int(nv[lane])):
                    raise AssertionError(
                        f"34a: window {w} {key} lane {lane} ({qs[lane].qid}) "
                        "differs from knn_points_fused alone")
    walls["a card + singles"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    want, _, _ = qserve_registry_run(cpu, qserve_registry_setup(cpu, grid),
                                     win_args, dispatch=QS_CPU_WINDOWS,
                                     keep=QS_CPU_WINDOWS)
    for w in QS_CPU_WINDOWS:
        for (key, qs, _, fa), (key_c, qs_c, _, fb) in zip(got[w], want[w]):
            if key != key_c or [q.qid for q in qs] != [q.qid for q in qs_c] \
                    or not all(np.array_equal(a.view(np.uint8),
                                              b.view(np.uint8))
                               for a, b in zip(fa, fb)):
                raise AssertionError(f"34a: window {w} {key} differs from "
                                     "the CPU run")
    walls["a CPU"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # Timed as the suite times it: the set-up before the clock, then
    # the 8 windows, churn included, and the one fetch.
    t1 = time.perf_counter()
    setup = qserve_registry_setup(dev, grid)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    _, churn_timed, _ = qserve_registry_run(dev, setup, win_args)
    secs = time.perf_counter() - t1
    n_points = QS_WINDOWS * QS_WIN
    if gpu == "cuda":
        names = {}
        setup = qserve_registry_setup(dev, grid)
        wall, busy, kernels = trace_busy(
            lambda: qserve_registry_run(dev, setup, win_args),
            by_name=names)
        top = sorted(names.items(), key=lambda kv: -kv[1])[:5]
        dev_line = (f"device busy {1e3 * busy / QS_WINDOWS:.3f} ms a window "
                    f"({idle(wall, busy)} over the traced run's "
                    f"{wall:.3f} s), {kernels / QS_WINDOWS:.1f} kernel "
                    "launches a window; device ms a window by kernel: "
                    + ", ".join(f"{v / 1e6 / QS_WINDOWS:.3f} {k[:60]}"
                                for k, v in top))
    else:
        dev_line = "device busy not measured (CPU rehearsal)"
    walls["a timed + traced"] = time.perf_counter() - t0
    live_total = sum(len(qs) for _, qs, _, _ in buckets)
    print(f"qserve registry (qserve_1024q_mixed: {QS_QUERIES} standing "
          f"queries, seed {QS_QUERY_SEED}, half range half kNN, k (32, 5, "
          f"10, 30), r (0.002, 0.02, 0.05) deg; {QS_WINDOWS} windows of "
          f"{QS_WIN} points from seed {QS_STREAM_SEED}, {QS_IDS} objIDs, "
          f"Beijing grid n={BEIJING['num_partitions']}; churn {QS_CHURN} "
          f"queries a bucket a window): {len(buckets)} buckets, "
          f"{live_total} live queries on {sum(caps.values())} lanes, rungs "
          + ", ".join(f"{qserve.bucket_key_str(k)} {c}"
                      for k, c in sorted(caps.items()))
          + f"; radius float32 as the suite ships it; {sigs} program "
          "signatures (bound "
          f"{len(capacity_ladder(QS_CAP, 8))} x {len(k_rungs)} k-rungs); "
          f"{n_live} live lane-windows of {n_lanes} equal to "
          "knn_points_fused alone on the card (segment, index, num_valid "
          "exact, distance bits), padded lanes empty, windows "
          f"{list(QS_CPU_WINDOWS)} bit-equal to the CPU run; set-up "
          f"(queries, flag tables, {len(buckets)} buckets staged) "
          f"{setup_ms:.3f} ms, before the clock; {n_points} points in "
          f"{secs:.6f} s = {n_points / secs:.1f} points/s (the {QS_WINDOWS}"
          f" windows, churn included, one fetch); {dev_line}; churn "
          "restaging on the host "
          f"{statistics.median(churn_timed):.3f} ms a window (median of "
          f"{len(churn_timed)}; {QS_CHURN * len(buckets)} queries, "
          f"{len(buckets)} buckets re-shipped) [{card}]")

    # 34b: the operator through the driver.
    t0 = time.perf_counter()
    events = qserve_command_stream(xy, oid)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    policy = overload.OverloadPolicy(tenant_budgets={
        "firehose": {"max_queries": QS_FIRE_MAX},
        "bulk": {"max_results_per_window": QS_BULK_ROWS}})
    spec = slo.SloSpec(name="phase-34", eval_interval_s=0.0,
                       tenant_budgets={
                           "firehose": {"shed_budget": 0},
                           "bulk": {"degraded_window_budget": 0},
                           "default": {"shed_budget": 0}})
    tmp = tempfile.mkdtemp(prefix="sft_qserve_")
    walls["b data"] = time.perf_counter() - t0

    def op_leg(device, workdir, plan=None):
        """Returns (egress bytes, registry counters, tenant block, SLO
        tenant rows, commit ms, checkpoint bytes, run s, driver)."""
        commits = []

        class TimedDriver(WindowedDataflowDriver):
            def _commit(self, final=False):
                t = time.perf_counter()
                super()._commit(final)
                commits.append((time.perf_counter() - t) * 1e3)

        os.makedirs(workdir, exist_ok=True)
        sink = TransactionalFileSink(os.path.join(workdir, "egress.csv"))
        ctrl = overload.install(overload.OverloadController(policy))
        eng = slo.install(slo.SloEngine(spec))
        drv = TimedDriver(
            checkpoint_path=os.path.join(workdir, "ckpt.bin"),
            checkpoint_every=1, sink=sink,
            retry=RetryPolicy(max_retries=0, backoff_s=0.0),
            failover=False, overload=ctrl)
        op = qserve.QServeOperator(conf, grid, device=device)
        if plan:
            faults.arm(plan)
        t1 = time.perf_counter()
        try:
            for res in op.run(iter(events), driver=drv):
                for line in res.lines():
                    sink.stage(line)
        finally:
            faults.disarm()
            rows = [r for r in eng.evaluate()
                    if r["check"].startswith("tenant_")]
            qserve.uninstall()
            slo.uninstall()
            overload.uninstall()
        if op.device.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t1
        with open(os.path.join(workdir, "egress.csv"), "rb") as f:
            egress = f.read()
        counters = op.registry.state()["counters"]
        return (egress, counters, ctrl.snapshot()["tenants"], rows, commits,
                os.path.getsize(os.path.join(workdir, "ckpt.bin")), secs,
                drv)

    t0 = time.perf_counter()
    clean = op_leg(dev, os.path.join(tmp, "clean"))
    walls["b card"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = op_leg(cpu, os.path.join(tmp, "cpu"))
    walls["b CPU"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        op_leg(dev, os.path.join(tmp, "chaos"), plan=[
            {"point": "driver.window", "at": 2, "times": 10_000}])
        raise AssertionError("34b: the armed run was not stopped")
    except InjectedFault:
        pass
    with open(os.path.join(tmp, "chaos", "egress.csv"), "rb") as f:
        torn = f.read()
    resumed = op_leg(dev, os.path.join(tmp, "chaos"))
    walls["b stop + resume"] = time.perf_counter() - t0
    egress, counters, tenants, rows = clean[:4]
    if not egress or egress != on_cpu[0] or egress != resumed[0]:
        raise AssertionError("34b: egress differs between the clean card "
                             "run, the CPU run and the resumed run")
    if not 0 < len(torn) < len(egress) or not resumed[7].stats["resumed"]:
        raise AssertionError("34b: the stop and resume did not cut the run")
    for other in (on_cpu, resumed):
        if other[1:3] != (counters, tenants):
            raise AssertionError(f"34b: counters differ: {other[1:3]} vs "
                                 f"{(counters, tenants)}")
    if rows != on_cpu[3]:
        raise AssertionError(f"34b: SLO rows differ: {rows} vs {on_cpu[3]}")
    fire, bulk = tenants["firehose"], tenants["bulk"]
    if counters["evicted_total"] <= 0 or fire["queries_shed"] <= 0 or \
            bulk["results_shed"] <= 0:
        raise AssertionError(f"34b: no eviction or truncation: {tenants}")
    n_events, n_lines = len(events), egress.count(b"\n")
    print(f"qserve operator (QServeOperator.run(driver=) over {n_events} "
          f"events: boot registrations of the {QS_QUERIES} queries, "
          f"{QS_OP_WINDOWS} one-second windows of {QS_WIN} Points at 34a's "
          f"positions, {2 * QS_CHURN} churn commands a window; tenant "
          f"budgets firehose max_queries {QS_FIRE_MAX}, bulk "
          f"max_results_per_window {QS_BULK_ROWS}; checkpoint every "
          f"window): {n_lines} egress lines byte-identical on "
          f"the card, on the CPU and stopped after window 1 then resumed "
          f"in a fresh operator; registered {counters['registered_total']}"
          f", unregistered {counters['unregistered_total']}, evicted "
          f"{counters['evicted_total']}, range_result_overflow "
          f"{counters['range_result_overflow']}; truncated rows "
          f"{bulk['results_shed']} (bulk, {bulk['degraded_windows']} "
          f"windows), firehose queries shed {fire['queries_shed']}; the "
          "same in all three runs; SLO tenant checks "
          + ", ".join(f"{r['check']} {r['value']!r} "
                      f"{'pass' if r['ok'] else 'FAIL'}" for r in rows)
          + f" (as on the CPU); {QS_OP_WINDOWS * QS_WIN / clean[6]:.1f} "
          f"points/s ({clean[6]:.3f} s, the per-event feed included); "
          f"commit {statistics.median(clean[4]):.3f} ms (median of "
          f"{len(clean[4])}), checkpoint {clean[5]} B [{card}]")
    print("phase walls: 34 " + f"{time.perf_counter() - t_phase:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f" s) [{card}]")
    return walls


# ---------------------------------------------------------------------------
# Phase 35: the job surface's leaf modules (envvars, config, the native C++
# engines, the Kafka wire source).

JS_PANE_PTS = 65_536     # points a pane of the Kafka leg (a cut of 500,000)
JS_PANES = 4             # panes of the Kafka leg: a window a pane, the
                         # first of one pane, 3 of two (a cut of 4)
JS_COMMITTED = 2         # windows emitted before the leg's checkpoint
JS_KILL_FETCH = 6        # the kafka.fetch hit after the checkpoint that kills
JS_FEED = 8_192          # records a WirePaneAssembler.feed (< a pane)
JS_TOPIC = "gps"
JS_TJ_PANES = 100        # 35a tJoin: panes a side of phase 26's stream


class MiniBroker:
    """A minimal single-node Kafka broker in this process: Metadata v0,
    Produce v2, Fetch v2 and ListOffsets v0 over a real TCP socket on
    127.0.0.1, one partition a topic (auto-created), the client's message
    sets kept as produced with their absolute offsets, a fetch cut at its
    ``max_bytes`` on a message boundary. It speaks the requests the port's
    built-in client (``streams/kafka_wire.py``) sends; ``close()`` stops
    its threads."""

    def __init__(self):
        import socket
        import threading

        from spatialflink_tpu_torch.streams import kafka_wire as kw

        self._kw = kw
        self.logs = {}  # topic -> [entry bytes], entry = offset|size|msg
        self._ends = {}  # topic -> [cumulative entry bytes]
        self._lock = threading.Lock()
        self.sock = socket.socket()
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.listen(8)
        self.port = self.sock.getsockname()[1]
        self._conns = []
        self._stop = False
        self._threads = [threading.Thread(target=self._serve, daemon=True)]
        self._threads[0].start()

    def close(self):
        import socket

        self._stop = True
        for s in [self.sock] + self._conns:
            try:  # shutdown wakes a thread blocked in accept or recv
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            s.close()
        for t in list(self._threads):
            t.join(timeout=5)

    def total(self, topic):
        return len(self.logs.get(topic, []))

    def _serve(self):
        import threading

        while not self._stop:
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return
            self._conns.append(conn)
            t = threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True)
            self._threads.append(t)
            t.start()

    def _recv(self, conn, n):
        chunks = []
        while n:
            try:
                c = conn.recv(n)
            except OSError:
                return None
            if not c:
                return None
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def _handle(self, conn):
        import struct

        kw = self._kw
        try:
            while not self._stop:
                hdr = self._recv(conn, 4)
                if hdr is None:
                    return
                payload = self._recv(conn, struct.unpack(">i", hdr)[0])
                if payload is None:
                    return
                r = kw.Reader(payload)
                api, _ver, corr = r.int16(), r.int16(), r.int32()
                r.string()  # client_id
                body = self._dispatch(api, r)
                if body is None:  # a produce with acks=0: no response
                    continue
                resp = struct.pack(">i", corr) + body
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            pass
        finally:
            conn.close()

    def _log(self, topic):
        with self._lock:
            return (self.logs.setdefault(topic, []),
                    self._ends.setdefault(topic, []))

    def _dispatch(self, api, r):
        import bisect
        import struct

        kw = self._kw
        if api == kw.API_METADATA:
            topics = [r.string() for _ in range(r.int32())]
            part = (struct.pack(">hii", 0, 0, 0) + struct.pack(">ii", 1, 0)
                    + struct.pack(">ii", 1, 0))
            return (kw.enc_array([struct.pack(">i", 0)
                                  + kw.enc_string("127.0.0.1")
                                  + struct.pack(">i", self.port)])
                    + kw.enc_array([struct.pack(">h", 0) + kw.enc_string(t)
                                    + kw.enc_array([part]) for t in topics]))
        if api == kw.API_PRODUCE:
            acks = r.int16()
            r.int32()  # timeout
            out = []
            for _ in range(r.int32()):
                topic = r.string()
                for _ in range(r.int32()):
                    pid = r.int32()
                    mset = r.bytes_() or b""
                    log, ends = self._log(topic)
                    base = len(log)
                    pos = 0
                    while pos + 12 <= len(mset):
                        size = struct.unpack_from(">i", mset, pos + 8)[0]
                        msg = mset[pos + 12:pos + 12 + size]
                        entry = struct.pack(">qi", len(log), size) + msg
                        ends.append((ends[-1] if ends else 0) + len(entry))
                        log.append(entry)
                        pos += 12 + size
                    out.append(kw.enc_string(topic) + kw.enc_array(
                        [struct.pack(">ihqq", pid, 0, base, -1)]))
            if acks == 0:
                return None
            return kw.enc_array(out) + struct.pack(">i", 0)
        if api == kw.API_FETCH:
            r.int32(), r.int32(), r.int32()  # replica, max_wait, min_bytes
            out = []
            for _ in range(r.int32()):
                topic = r.string()
                parts = []
                for _ in range(r.int32()):
                    pid, off, max_bytes = r.int32(), r.int64(), r.int32()
                    log, ends = self._log(topic)
                    n = len(log)
                    off = min(max(off, 0), n)
                    start = ends[off - 1] if off else 0
                    # Whole messages up to max_bytes (at least one).
                    hi = max(bisect.bisect_right(ends, start + max_bytes),
                             min(off + 1, n))
                    parts.append(struct.pack(">ihq", pid, 0, n)
                                 + kw.enc_bytes(b"".join(log[off:hi])))
                out.append(kw.enc_string(topic) + kw.enc_array(parts))
            return struct.pack(">i", 0) + kw.enc_array(out)
        if api == kw.API_LIST_OFFSETS:
            r.int32()  # replica
            out = []
            for _ in range(r.int32()):
                topic = r.string()
                parts = []
                for _ in range(r.int32()):
                    pid, ts = r.int32(), r.int64()
                    r.int32()  # max_offsets
                    n = len(self._log(topic)[0])
                    parts.append(struct.pack(">ih", pid, 0) + kw.enc_array(
                        [struct.pack(">q", 0 if ts == kw.EARLIEST else n)]))
                out.append(kw.enc_string(topic) + kw.enc_array(parts))
            return kw.enc_array(out)
        raise AssertionError(f"MiniBroker: unexpected api_key {api}")


def jobsurface_yaml(port: int, backend: str) -> str:
    """The Kafka leg's job in the reference's YAML schema
    (geoflink-conf.yml): the headline's grid, window, k and radius, the
    records' CSV columns, the broker, and the backend."""
    return f"""\
!!GeoFlink.utils.ConfigType
clusterMode: False
kafkaBootStrapServers: "127.0.0.1:{port}"
inputStream1:
  topicName: "{JS_TOPIC}"
  format: "CSV"
  dateFormat: "null"
  geoJSONSchemaAttr: ["oID", "timestamp"]
  csvTsvSchemaAttr: [3, 0, 1, 2]
  gridBBox: [{BEIJING["min_x"]}, {BEIJING["min_y"]}, {BEIJING["max_x"]}, {BEIJING["max_y"]}]
  numGridCells: {BEIJING["num_partitions"]}
  cellLength: 0
  delimiter: ","
  charset: "UTF-8"
outputStream:
  topicName: "knn_out"
  delimiter: ","
query:
  option: 1
  parallelism: 1
  approximate: False
  radius: {RADIUS}
  aggregateFunction: "SUM"
  k: {K}
  omegaDuration: 1
  queryPoints:
    - [{QUERY[0]}, {QUERY[1]}]
window:
  type: "TIME"
  interval: {WINDOW // SLIDE}
  step: 1
backend: {backend}
"""


def jobsurface_records(panes, wf):
    """The Kafka leg's ``ts,x,y,oid`` records: the first JS_PANE_PTS
    points of each of the headline's first JS_PANES panes, coordinates
    from the wire (dequantize of the quantized points), pane p's points
    at ts spread over [1000 p, 1000 p + 1000) ms."""
    lines = []
    for p in range(JS_PANES):
        q = panes[p][:, :JS_PANE_PTS]
        xy = wf.dequantize_np(q[:2].T)
        oid = q[2].view(np.int16).astype(np.int64)
        ts = 1000 * p + (np.arange(JS_PANE_PTS) * 1000) // JS_PANE_PTS
        lines += [f"{t},{x!r},{y!r},{o}" for t, x, y, o in zip(
            ts.tolist(), xy[:, 0].astype(np.float64).tolist(),
            xy[:, 1].astype(np.float64).tolist(), oid.tolist())]
    return lines


def jobsurface_operator(params):
    """The headline operator and wire format a ``Params`` describes: the
    grid from ``make_grid()``, the window from its ``window`` section, the
    device its ``backend`` names."""
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.streams.wire import WireFormat

    grid = params.input_stream1.make_grid()
    conf = QueryConfiguration(window_size=params.window.interval,
                              slide_step=params.window.step)
    return (PointPointKNNQuery(conf, grid, device=params.backend),
            WireFormat.for_grid(grid))


def jobsurface_query(params):
    from spatialflink_tpu_torch.models.objects import Point

    x, y = params.query.query_points[0]
    return Point(x=x, y=y)


class KafkaKnnLeg:
    """One run of the Kafka leg: ``WireKafkaSource`` → ``WirePaneAssembler``
    (JS_FEED records a feed, so a feed completes at most one pane and a
    snapshot after a window holds no pending pane) →
    ``PointPointKNNQuery.run_wire_panes`` (B1 on the card), built from a
    ``Params``; from the topic's start or from a checkpoint. Keeps the
    host seconds spent pulling records (fetch, decode, parse), in the
    parser and in the feeds, and the panes it fed."""

    def __init__(self, params, n_records, start=None):
        from spatialflink_tpu_torch.checkpoint import (
            restore_kafka_source_offsets,
            restore_operator,
            restore_wire_pane_assembler,
        )
        from spatialflink_tpu_torch.streams.kafka import WireKafkaSource
        from spatialflink_tpu_torch.streams.wire import WirePaneAssembler

        s = params.input_stream1
        self.params, self.n_records = params, n_records
        self.op, self.wf = jobsurface_operator(params)
        self.asm = WirePaneAssembler(self.wf, self.op.conf.slide_step_ms,
                                     start_ms=0)
        offsets = None
        if start is not None:
            offsets = restore_kafka_source_offsets(start["source"],
                                                   s.topic_name)
            restore_wire_pane_assembler(self.asm, start["panes"])
            restore_operator(self.op, start["op"])
        self.first = (offsets or {}).get(0, 0)
        i_oid, i_ts, i_x, i_y = s.csv_tsv_schema_attr
        delim = s.delimiter
        self.parse_s = self.pull_s = self.feed_s = 0.0
        self.fed = []

        def parse(line):
            t0 = time.perf_counter()
            c = line.split(delim)
            rec = (int(c[i_ts]), float(c[i_x]), float(c[i_y]),
                   int(c[i_oid]))
            self.parse_s += time.perf_counter() - t0
            return rec

        self.src = WireKafkaSource(s.topic_name,
                                   params.kafka_bootstrap_servers, parse,
                                   start_offsets=offsets)

    def panes(self):
        import itertools

        it = iter(self.src)
        left = self.n_records - self.first
        while left > 0:
            t0 = time.perf_counter()
            batch = list(itertools.islice(it, min(JS_FEED, left)))
            t1 = time.perf_counter()
            self.pull_s += t1 - t0
            left -= len(batch)
            a = np.array(batch)
            out = self.asm.feed({"ts": a[:, 0].astype(np.int64),
                                 "x": a[:, 1], "y": a[:, 2],
                                 "oid": a[:, 3].astype(np.int64)})
            if left == 0:  # the end of the topic: the open pane goes out
                out += self.asm.flush()
            self.feed_s += time.perf_counter() - t1
            self.fed += out
            yield from out

    def windows(self):
        q = self.params.query
        return self.op.run_wire_panes(
            self.panes(), jobsurface_query(self.params), q.radius, q.k,
            NUM_SEGMENTS, self.wf, start_ms=0, flush_at_end=False)

    def snapshot(self):
        from spatialflink_tpu_torch.checkpoint import (
            kafka_source_state,
            operator_state,
            wire_pane_assembler_state,
        )

        return dict(source=kafka_source_state(self.src),
                    panes=wire_pane_assembler_state(self.asm),
                    op=operator_state(self.op))


def jobsurface_tstats(card, gpu):
    """35a, tStats: the native engine against the numpy and device
    engines at bench_tstats_pane, and the pane_backend rung's "auto"."""
    import torch

    from spatialflink_tpu_torch import native, overload
    from spatialflink_tpu_torch.streams.panes import (
        pane_spatial_bound,
        traj_stats_sliding,
    )

    ts, xy, oid = tstats_stream()
    # The host engines read the float32 coordinates the device engine does.
    xy32 = xy.astype(np.float32).astype(np.float64)
    args32 = (ts, xy32, oid, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS)
    secs = {}
    out = {}
    traj_stats_sliding(ts[:1000], xy[:1000], oid[:1000], TS_BUCKET,
                       TS_WINDOW_MS, TS_SLIDE_MS, backend="device",
                       device=gpu)
    for name in ("native", "numpy", "device"):
        t0 = time.perf_counter()
        if name == "device":
            out[name] = traj_stats_sliding(ts, xy, oid, TS_BUCKET,
                                           TS_WINDOW_MS, TS_SLIDE_MS,
                                           backend="device", device=gpu)
            if gpu != "cpu":
                torch.cuda.synchronize()
        else:
            out[name] = traj_stats_sliding(*args32, backend=name,
                                           device=gpu)
        secs[name] = time.perf_counter() - t0

    def same(a, b):
        return all(getattr(a, f).dtype == getattr(b, f).dtype
                   and np.array_equal(getattr(a, f), getattr(b, f))
                   for f in ("starts", "temporal", "count")) and \
            np.array_equal(a.spatial.view(np.int64), b.spatial.view(np.int64))

    if not same(out["native"], out["numpy"]):
        raise AssertionError("35a: the native tStats engine differs from "
                             "the numpy engine")
    err, rel = check_pane_windows(out["device"], out["native"],
                                  pane_spatial_bound(*args32), "35a native")
    calls = []
    real = native.traj_stats_native

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    overload.install(overload.OverloadController(overload.OverloadPolicy(
        ladder=({"action": "pane_backend", "to": "native"},),
        degrade_cooldown=1))).on_slo_evaluation(False)
    native.traj_stats_native = counted
    try:
        t0 = time.perf_counter()
        auto = traj_stats_sliding(*args32, backend="auto", device=gpu)
        auto_s = time.perf_counter() - t0
    finally:
        native.traj_stats_native = real
        overload.uninstall()
    if len(calls) != 1 or not same(auto, out["native"]):
        raise AssertionError(f"35a: under the native rung 'auto' made "
                             f"{len(calls)} native calls")
    print(f"jobsurface tStats engines (bench_tstats_pane: {TS_POINTS} "
          f"points, {TS_WINDOW_MS} ms windows by {TS_SLIDE_MS} ms, "
          f"{len(out['native'].starts)} windows): native (sf_traj_stats) "
          f"{secs['native']:.6f} s bit-identical to numpy "
          f"{secs['numpy']:.6f} s; the device engine on the card "
          f"{secs['device']:.6f} s: starts, counts and temporal sums equal, "
          f"spatial within pane_spatial_bound (max err {err:.3e}, {rel:.3f} "
          f"of the bound); under an armed pane_backend native rung "
          f"traj_stats_sliding(backend='auto', device card) ran the native "
          f"engine ({len(calls)} call, {auto_s:.6f} s), bit-identical "
          f"[{card}]")
    return secs


def jobsurface_tjoin(card, gpu):
    """35a, tJoin: ``run_soa_panes(backend="native")`` against the device
    engine on the card, phase 26's stream cut to JS_TJ_PANES panes a
    side. The native engine computes in float64 from the float32 centred
    coordinates, the device engine in float32 (a relative error of at
    most 3u, u = 2^-24): the pair sets are equal outside the band
    [r (1 - 3u), r (1 + 3u)], whose pairs are counted, and the minima of
    the common pairs agree within 3u."""
    rtol = 3 * 2.0 ** -24 * (1 + 2.0 ** -20)
    chunks = tpanes_stream()
    cut = tpanes_cut(chunks, JS_TJ_PANES)
    nat, nat_s, _ = run_tjoin_panes(gpu, cut, backend="native")
    dev, dev_s, dev_op = run_tjoin_panes(gpu, cut, backend="device")
    if len(nat) != len(dev) or not dev_op.pane_scans:
        raise AssertionError(f"35a tJoin: {len(nat)} native windows, "
                             f"{len(dev)} device windows")
    band = common = pairs = 0
    worst = 0.0
    lo_band = TP_R * (1 - rtol)
    for a, b in zip(nat, dev):
        if a[:2] != b[:2]:
            raise AssertionError(f"35a tJoin: window {a[:2]} vs {b[:2]}")
        if np.array_equal(a[2], b[2]) and np.array_equal(a[3], b[3]):
            # The same pairs in the same order: compare the minima whole.
            pairs += len(a[2])
            common += len(a[2])
            band += int(np.count_nonzero(a[4] >= lo_band))
            err = np.abs(a[4] - b[4])
            if np.any(err > rtol * a[4]):
                raise AssertionError(f"35a tJoin: minima differ past 3u in "
                                     f"window {a[:2]}")
            if len(err):
                worst = max(worst, float((err / np.maximum(a[4], 1e-300))
                                         .max()))
            continue
        ka = dict(zip(zip(a[2].tolist(), a[3].tolist()), a[4].tolist()))
        kb = dict(zip(zip(b[2].tolist(), b[3].tolist()), b[4].tolist()))
        pairs += len(ka)
        for key in ka.keys() ^ kb.keys():
            d = ka.get(key, kb.get(key))
            if d < lo_band:
                raise AssertionError(f"35a tJoin: pair {key} at {d!r} in one "
                                     f"engine only, outside the band")
            band += 1
        for key in ka.keys() & kb.keys():
            common += 1
            band += ka[key] >= lo_band
            err = abs(ka[key] - kb[key])
            if err > rtol * ka[key]:
                raise AssertionError(f"35a tJoin: pair {key} minima "
                                     f"{ka[key]!r} vs {kb[key]!r}")
            worst = max(worst, err / max(ka[key], 1e-300))
    if pairs == 0:
        raise AssertionError("35a tJoin: no pair")
    print(f"jobsurface tJoin engines (tjoin_panes_10s_10ms cut to "
          f"{JS_TJ_PANES} panes a side, {len(nat)} windows, {pairs} "
          f"native pairs): run_soa_panes(backend='native') "
          f"(sf_tjoin_panes, host) {nat_s:.6f} s, the device engine on the "
          f"card {dev_s:.6f} s; pair sets equal outside the band "
          f"r(1 +- 3u), {band} pairs in the band; minima of the {common} "
          f"common pairs within {worst:.3e} relative (bound {rtol:.3e}) "
          f"[{card}]")
    return nat_s, dev_s


def check_jobsurface(card, panes, wf, gpu="cuda"):
    """Phase 35: the job surface's leaf modules on the card. 35a the
    native engines beside the device engines; 35b Kafka → the headline
    program through B1, from a ``Params`` read from the reference schema,
    killed by ``kafka.fetch`` after a checkpoint and resumed. Returns
    ``{"wire_digest": B1 launches of the card runs}``."""
    import os
    import tempfile

    from spatialflink_tpu_torch import checkpoint as ck
    from spatialflink_tpu_torch import native
    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.faults import InjectedFault, faults
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.streams.kafka import KafkaSink

    t_phase = time.perf_counter()
    if not native.available():
        raise AssertionError("35: the native library did not build or "
                             "failed its ABI check")
    tstats_s = jobsurface_tstats(card, gpu)
    jobsurface_tjoin(card, gpu)
    t_a = time.perf_counter() - t_phase

    # 35b. Produce the records, then the job from its YAML.
    t0 = time.perf_counter()
    lines = jobsurface_records(panes, wf)
    n = len(lines)
    data_s = time.perf_counter() - t0
    broker = MiniBroker()
    try:
        params = Params.loads(jobsurface_yaml(broker.port, gpu))
        if params.backend != gpu or params.query.k != K:
            raise AssertionError(f"35b: the YAML read as {params}")
        t0 = time.perf_counter()
        sink = KafkaSink(JS_TOPIC, params.kafka_bootstrap_servers,
                         batch=JS_FEED)
        for line in lines:
            sink(line)
        sink.close()
        produce_s = time.perf_counter() - t0
        if broker.total(JS_TOPIC) != n:
            raise AssertionError(f"35b: the broker holds "
                                 f"{broker.total(JS_TOPIC)} of {n} records")

        def card_windows(gen, count=None):
            import itertools

            return [(s, e, oo.copy(), dd.copy(), nv) for s, e, oo, dd, nv
                    in itertools.islice(gen, count)]

        # The uninterrupted card run, traced.
        wire_digest.launches = 0
        clean = KafkaKnnLeg(params, n)
        want, wall, busy, _ = traced(lambda: card_windows(clean.windows()),
                                     gpu)
        clean.src.close()
        clean_launches = wire_digest.launches
        # The killed run: a checkpoint after JS_COMMITTED windows, then
        # kafka.fetch raising at a later fetch; the windows after the
        # checkpoint are discarded, as a committing sink discards them.
        wire_digest.launches = 0
        leg = KafkaKnnLeg(params, n)
        gen = leg.windows()
        committed = card_windows(gen, JS_COMMITTED)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "kafka_knn.ckpt")
            t0 = time.perf_counter()
            ck.save_checkpoint(path, **leg.snapshot())
            commit_ms = (time.perf_counter() - t0) * 1e3
            ckpt_bytes = os.path.getsize(path)
            faults.arm([{"point": "kafka.fetch", "at": JS_KILL_FETCH}])
            lost = []
            try:
                for w in gen:
                    lost.append(w)
                raise AssertionError("35b: kafka.fetch never fired")
            except InjectedFault:
                pass
            finally:
                fired = list(faults.fired)
                faults.disarm()
                leg.src.close()
            # The resume: fresh source, assembler and operator.
            t0 = time.perf_counter()
            resumed_leg = KafkaKnnLeg(params, n, start=ck.load_checkpoint(
                path))
            gen = resumed_leg.windows()
            first = card_windows(gen, 1)
            resume_ms = (time.perf_counter() - t0) * 1e3
            resumed = first + card_windows(gen)
            resumed_leg.src.close()
        kill_launches = wire_digest.launches
    finally:
        broker.close()
    got = committed + resumed
    check_windows(got, want, "35b kill and resume")
    if len(want) != JS_PANES or len(committed) != JS_COMMITTED:
        raise AssertionError(f"35b: {len(want)} windows")
    if [f["point"] for f in fired] != ["kafka.fetch"]:
        raise AssertionError(f"35b: fired {fired}")
    # The CPU run over the panes the card run was fed, through B1's plain
    # version.
    t0 = time.perf_counter()
    cpu_params = Params.loads(jobsurface_yaml(0, "cpu"))
    cpu_op, cpu_wf = jobsurface_operator(cpu_params)
    cpu = card_windows(cpu_op.run_wire_panes(
        clean.fed, jobsurface_query(cpu_params), RADIUS, K, NUM_SEGMENTS,
        cpu_wf, start_ms=0, flush_at_end=False))
    cpu_s = time.perf_counter() - t0
    check_windows(want, cpu, "35b card vs CPU")
    if clean_launches < JS_PANES or kill_launches < JS_PANES:
        raise AssertionError(f"35b: B1 launched {clean_launches} and "
                             f"{kill_launches} times")
    pull = clean.pull_s
    print(f"e2e jobsurface Kafka -> run_wire_panes (B1): {n} ts,x,y,oid "
          f"records ({JS_PANES} panes of {JS_PANE_PTS}, 16,384 objIDs, k={K}, "
          f"r={RADIUS}, windows of 2 panes; a YAML job, backend "
          f"{params.backend}) produced through KafkaSink in {produce_s:.3f} "
          f"s = {n / produce_s:.1f} records/s; consumed by WireKafkaSource "
          f"at {n / pull:.1f} records/s ({pull:.3f} s pulling, "
          f"{clean.parse_s:.3f} s of it in the parser; {clean.feed_s:.3f} s "
          f"in WirePaneAssembler.feed); {len(want)} windows of {K} (the "
          f"first over pane 0 alone) in "
          f"{wall:.3f} s, {idle(wall, busy)}; launches wire_digest="
          f"{clean_launches} (clean run), {kill_launches} (killed and "
          f"resumed runs); record set-up {data_s:.3f} s [{card}]")
    print(f"jobsurface kill and resume: checkpoint after window "
          f"{JS_COMMITTED - 1} (the source's offsets, the assembler's open "
          f"pane, the digest ring) {ckpt_bytes} B committed in "
          f"{commit_ms:.3f} ms; kafka.fetch raised at fetch "
          f"{JS_KILL_FETCH} after it, {len(lost)} window(s) emitted since "
          f"the checkpoint discarded; the "
          f"resume's first window {resume_ms:.3f} ms after its start; the "
          f"committed + resumed windows equal the uninterrupted card run, "
          f"and every window the CPU run through B1's plain version "
          f"({cpu_s:.3f} s on the host CPU); ids in order, distance bits "
          f"[{card}]")
    print(f"phase 35 wall: {time.perf_counter() - t_phase:.3f} s (35a "
          f"{t_a:.3f} s, tStats native {tstats_s['native']:.3f} s) [{card}]")
    return {"wire_digest": clean_launches + kill_launches}


# Phase 36: the composed SNCB DAG and the StreamingJob entry point. 36a's
# stream is phase 29's FA/FF stream (BenchmarkRunner.java:22-105: the
# Brussels bbox, 10 devices, seed 42; FA ~ U(0, 1), FF ~ U(0, 0.4) from
# seed 29) with its rate cut from SNCB_EPS to DAG_EPS over the same 30 s
# (a tenth: every node but the zone test and the registry program walks
# its events in Python). 36c's CSV is phase 9's Point streams.
DAG_EPS = 2_000
DAG_CKPT_EVERY = 2       # windows between the unit checkpoints
DAG_KILL_AT = 16         # the dag.commit sub-append the kill children abort
                         # at: the third unit commit's second (7 sinks a
                         # commit), so a unit checkpoint exists to resume
SJ_POINTS = JOIN_OBJ_POINTS // 2  # 36c's Points a side: phase 9's first
                                  # half second (a depth cut of its second)
DAG_NODES = ("q1", "q2", "q3", "q4", "q5", "staytime", "qserve")
SJ_OPTIONS = (1, 3, 5, 6, 8, 9)


def dag_stream():
    """36a's events: phase 29's FA/FF stream at DAG_EPS."""
    from spatialflink_tpu_torch.sncb.common import GpsEvent
    from spatialflink_tpu_torch.sncb.runners import BRUSSELS_BBOX
    from spatialflink_tpu_torch.streams.sources import SyntheticGpsSource

    src = SyntheticGpsSource(
        *BRUSSELS_BBOX, target_eps=DAG_EPS, duration_ms=SNCB_DURATION_MS,
        num_devices=SNCB_DEVICES, seed=42, start_ts=SNCB_T0,
        make_event=lambda device_id, x, y, timestamp, speed: GpsEvent(
            device_id, x, y, timestamp, speed, 5.0, 5.0))
    events = list(src)
    rng = np.random.default_rng(29)
    fa = rng.uniform(0.0, 1.0, len(events)).tolist()
    ff = rng.uniform(0.0, 0.4, len(events)).tolist()
    return [GpsEvent(e.device_id, e.lon, e.lat, e.ts, e.gps_speed, a, b)
            for e, a, b in zip(events, fa, ff)]


def dag_leg(device, workdir, events):
    """One run of 36a's DAG under ``workdir`` (resumed when its unit
    checkpoint exists). Returns (the DAG, the driver, {"commits": [(ms,
    bytes)], "first_window_ms", "windows", "s"})."""
    import itertools
    import os

    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )

    t0 = time.perf_counter()
    dag = dag_mod.build_sncb_dag(
        os.path.join(workdir, "egress"),
        qserve_queries=dag_mod.default_sncb_queries(),
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), device=device)
    ck_path = os.path.join(workdir, "ckpt.bin")
    drv = WindowedDataflowDriver(
        checkpoint_path=ck_path, checkpoint_every=DAG_CKPT_EVERY, sink=None,
        retry=RetryPolicy(max_retries=1, backoff_s=0.0), failover=False)
    info = {"commits": [], "first_window_ms": None, "windows": 0}
    commit = drv._commit

    def timed_commit(final=False):
        c0 = time.perf_counter()
        commit(final)
        info["commits"].append(((time.perf_counter() - c0) * 1e3,
                                os.path.getsize(ck_path)))

    drv._commit = timed_commit
    for _ in dag.run(itertools.chain(dag.qserve_boot, events), driver=drv):
        if info["first_window_ms"] is None:
            info["first_window_ms"] = (time.perf_counter() - t0) * 1e3
        info["windows"] += 1
    if device != "cpu":
        import torch

        torch.cuda.synchronize()
    info["s"] = time.perf_counter() - t0
    return dag, drv, info


def dag_sinks(workdir):
    import os

    out = {}
    for name in DAG_NODES:
        with open(os.path.join(workdir, "egress", f"{name}.csv"), "rb") as f:
            out[name] = f.read()
    return out


def dag_child(workdir, device="cuda") -> int:
    """One child of phase 36b (``--dag-child DIR``, on the card unless
    ``--child-device cpu``): 36a's DAG, killed by an armed
    ``SFT_FAULT_PLAN`` or resumed from the unit checkpoint under
    ``workdir``. Prints one JSON line of its numbers."""
    import os

    from spatialflink_tpu_torch import dag as dag_mod

    ck_path = os.path.join(workdir, "ckpt.bin")
    ck_bytes = os.path.getsize(ck_path) if os.path.exists(ck_path) else 0
    events = dag_stream()
    _dag, drv, info = dag_leg(device, workdir, events)
    dag_mod.uninstall()
    print(json.dumps({"resumed": drv.stats["resumed"],
                      "resume_ckpt_bytes": ck_bytes,
                      "first_window_ms": info["first_window_ms"],
                      "windows": info["windows"]}))
    return 0


#: Phase 36's child processes, killed if the phase fails before it
#: collects them.
DAG_CHILDREN = []


def start_background(cmd, env=None, owner=None):
    """``cmd`` from the checkout's root with the armed ``SFT_*`` plans
    scrubbed (``env`` adds its own), its output piped, in this process's
    group (a signal to the group reaches it); listed in ``owner`` (by
    default ``DAG_CHILDREN``), whose owner stops it (``stop_children``)
    if it outlives its phase."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    base = {k: v for k, v in os.environ.items()
            if k not in ("SFT_FAULT_PLAN", "SFT_PIPELINE",
                         "SFT_LEDGER_STREAM", "SFT_OVERLOAD_POLICY")}
    proc = subprocess.Popen(cmd, cwd=root, env={**base, **(env or {})},
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    (DAG_CHILDREN if owner is None else owner).append(proc)
    return proc


def stop_children(procs):
    """Stop each process of ``procs`` still running and empty the list:
    SIGTERM first, so that a child with children of its own (the dry
    run's ranks) stops them, then SIGKILL after 10 s."""
    for proc in procs:
        if proc.poll() is None:
            proc.terminate()
    for proc in procs:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    procs.clear()


def kill_then_resume(cmd, plan, label, timeout=300):
    """A child armed with ``plan`` that must die with the abort code, then
    the same command resuming; returns the resume's stdout."""
    kill = start_background(cmd, {"SFT_FAULT_PLAN": json.dumps(plan)})
    _, err = kill.communicate(timeout=timeout)
    if kill.returncode != 137:
        raise AssertionError(f"{label}: the kill child exited "
                             f"{kill.returncode}, not 137\n{err[-2000:]}")
    resume = start_background(cmd)
    out, err = resume.communicate(timeout=timeout)
    if resume.returncode != 0:
        raise AssertionError(f"{label}: the resume child failed\n"
                             f"{err[-2000:]}")
    return out


def sj_yaml(option, backend, bbox, cells, radius, k, interval, step,
            points, incremental=False):
    """A job in the reference's YAML schema (geoflink-conf.yml)."""
    pts = "\n".join(f"    - [{x}, {y}]" for x, y in points)
    return f"""\
!!GeoFlink.utils.ConfigType
clusterMode: False
inputStream1:
  topicName: "points"
  format: "CSV"
  dateFormat: "null"
  csvTsvSchemaAttr: [0, 1, 2, 3]
  gridBBox: [{bbox[0]}, {bbox[1]}, {bbox[2]}, {bbox[3]}]
  numGridCells: {cells}
  cellLength: 0
  delimiter: ","
outputStream:
  topicName: "results"
  delimiter: ","
query:
  option: {option}
  approximate: False
  radius: {radius}
  aggregateFunction: "SUM"
  k: {k}
  incremental: {str(incremental).lower()}
  queryPoints:
{pts}
window:
  type: "TIME"
  interval: {interval}
  step: {step}
backend: {backend}
"""


def check_dag(card, gpu="cuda"):
    """Phase 36: the composed SNCB DAG and the StreamingJob entry point.
    Returns {"join_extract": B3 launches of 36c's option 5}. A failure
    kills the phase's child processes before it propagates."""
    try:
        return run_dag_phase(card, gpu)
    finally:
        stop_children(DAG_CHILDREN)


def run_dag_phase(card, gpu):
    import os
    import tempfile

    import torch

    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch import qserve, slo, streaming_job
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.sncb import common as sncb_common
    from spatialflink_tpu_torch.telemetry import telemetry

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase36_")
    # The smoke's four processes run one after another on the card beside
    # the whole phase (36a's DAG shares the host with one of them at a
    # time); 36b's and option 10's child chains start after 36a.
    smoke = start_background([sys.executable, "-m",
                              "spatialflink_tpu_torch.dag", "--smoke",
                              "--device", gpu])
    t0 = time.perf_counter()
    events = dag_stream()
    print(f"data: {len(events)} SNCB events ({DAG_EPS} events/s for "
          f"{SNCB_DURATION_MS // 1000} s) in {time.perf_counter() - t0:.3f} "
          f"s (host set-up)")

    # 36a. The card run, traced, with telemetry on; the zone test counted.
    zone = {"n": 0}
    zone_kernel = sncb_common._zone_hit_kernel

    def counted_zone(*a, **kw):
        zone["n"] += 1
        return zone_kernel(*a, **kw)

    sncb_common._zone_hit_kernel = counted_zone
    telemetry.enable()
    try:
        (dag, drv, info), wall, busy, kernels = traced(
            lambda: dag_leg(gpu, os.path.join(tmp, "card"), events), gpu)
        rollup = telemetry.node_rollup()
        table = telemetry.kernel_table()
        snap = telemetry.snapshot()
        budgets = {name: {"retry_budget": 0, "failover_budget": 0,
                          "degraded_window_budget": 0,
                          "watermark_lag_p99_ms": 60_000}
                   for name in DAG_NODES}
        rows = slo.SloEngine(slo.SloSpec(
            eval_interval_s=0.0, node_budgets=budgets)).evaluate()
    finally:
        sncb_common._zone_hit_kernel = zone_kernel
        telemetry.disable()
        dag_mod.uninstall()
        qserve.uninstall()
    zone_launches = zone["n"]
    calls = {}
    for r in table:
        calls[r["kernel"]] = calls.get(r["kernel"], 0) + r["calls"]
    want = dag_sinks(os.path.join(tmp, "card"))
    if set(snap.get("dag", {}).get("nodes", {})) != set(DAG_NODES):
        raise AssertionError(f"36a: snapshot()['dag'] holds "
                             f"{sorted(snap.get('dag', {}).get('nodes', {}))}")
    for name, rec in snap["dag"]["nodes"].items():
        if rec["backend"] != "device" or rec["retries"] or rec["failovers"] \
                or rec["degraded_windows"]:
            raise AssertionError(f"36a: node {name} on the card: {rec}")
    if len(rows) != 4 * len(DAG_NODES) or not all(r["ok"] for r in rows):
        raise AssertionError(f"36a: node budgets "
                             f"{[r for r in rows if not r['ok']]}")
    if not all(want[n] for n in DAG_NODES if n != "q4"):
        raise AssertionError(f"36a: empty sinks "
                             f"{[n for n in DAG_NODES if not want[n]]}")
    if zone_launches < 3 or calls.get("registry_bucket_kernel", 0) < 1:
        raise AssertionError(f"36a: zone test {zone_launches}, registry "
                             f"program {calls.get('registry_bucket_kernel')}"
                             " launches")
    t0 = time.perf_counter()
    dag_leg("cpu", os.path.join(tmp, "cpu"), events)
    cpu_s = time.perf_counter() - t0
    dag_mod.uninstall()
    qserve.uninstall()
    cpu = dag_sinks(os.path.join(tmp, "cpu"))
    for name in DAG_NODES:
        if want[name] != cpu[name]:
            raise AssertionError(f"36a: sink {name} differs from the CPU "
                                 f"run ({len(want[name])} B vs "
                                 f"{len(cpu[name])} B)")
    n = len(events)
    per_node = ", ".join(f"{name} {rollup[name]['span_us'] / 1e6:.3f} s"
                         for name in DAG_NODES)
    commits = "; ".join(f"{ms:.3f} ms {b} B" for ms, b in info["commits"])
    sink_bytes = ", ".join(f"{k} {len(v)}" for k, v in want.items())
    print(f"e2e dag (36a): {n} events -> {info['windows']} windows of 7 "
          f"nodes in {info['s']:.6f} s = {n / info['s']:.1f} events/s; "
          f"per node (node.<name> spans): {per_node}; {idle(wall, busy)} "
          f"({kernels} kernels traced); launches zone test={zone_launches} "
          f"registry_bucket_kernel={calls.get('registry_bucket_kernel', 0)} "
          f"stay_time_cells_kernel={calls.get('stay_time_cells_kernel', 0)};"
          f" 0 retries, failovers and degraded windows on every node; "
          f"node budgets {len(rows)} checks passed; sinks (B) {sink_bytes}, "
          f"each equal to the CPU run ({cpu_s:.3f} s) [{card}]")
    print(f"dag commits (36a, every {DAG_CKPT_EVERY} windows and the final "
          f"one; the unit checkpoint's size after each): {commits} [{card}]")
    t_a = time.perf_counter() - t_phase

    # 36b and 36c's option 10 kill and resume in child processes, in the
    # background beside 36c's in-process runs.
    import concurrent.futures

    pool = concurrent.futures.ThreadPoolExecutor(2)
    chaos_dir = os.path.join(tmp, "chaos")
    dag_chain = pool.submit(
        kill_then_resume, [sys.executable, __file__, "--dag-child",
                           chaos_dir, "--child-device", gpu],
        [{"point": "dag.commit", "kind": "abort", "at": DAG_KILL_AT}], "36b")

    # 36c. The job CSVs: phase 9's two streams merged in event time (so
    # no record arrives late), the same records side after side for
    # option 5 (its halves are its two streams), and 36a's stream.
    left, right = (side[:SJ_POINTS] for side in join_objects())
    points_csv = os.path.join(tmp, "points.csv")
    join_csv = os.path.join(tmp, "join.csv")
    for path, rows in ((points_csv, sorted(left + right,
                                           key=lambda p: p.timestamp)),
                       (join_csv, left + right)):
        with open(path, "w") as f:
            for p in rows:
                f.write(f"{p.obj_id},{p.timestamp},{float(p.x)!r},"
                        f"{float(p.y)!r}\n")
    gps_csv = os.path.join(tmp, "gps.csv")
    with open(gps_csv, "w") as f:
        for e in events:
            f.write(f"{e.device_id},{e.ts},{e.lon!r},{e.lat!r}\n")
    from spatialflink_tpu_torch.sncb.runners import BRUSSELS_BBOX

    bx0, bx1, by0, by1 = BRUSSELS_BBOX
    gps_yaml = os.path.join(tmp, "dag.yml")
    with open(gps_yaml, "w") as f:
        f.write(sj_yaml(10, gpu, (bx0, by0, bx1, by1), 32, 0.05, 5, 10, 5,
                        [((bx0 + bx1) / 2, (by0 + by1) / 2)]))
    job10 = [sys.executable, "-m", "spatialflink_tpu_torch.streaming_job",
             "--config", gps_yaml, "--source", f"csv:{gps_csv}",
             "--output", os.path.join(tmp, "job10_chaos"), "--checkpoint",
             os.path.join(tmp, "job10.ckpt"), "--checkpoint-every",
             str(DAG_CKPT_EVERY)]
    job10_chain = pool.submit(
        kill_then_resume, job10,
        [{"point": "dag.commit", "kind": "abort", "at": DAG_KILL_AT}],
        "36c option 10")

    bj = BEIJING
    bbox = (bj["min_x"], bj["min_y"], bj["max_x"], bj["max_y"])
    q2 = (QUERY[0] + 0.3, QUERY[1] - 0.2)
    sj_secs, sj_lines = {}, {}
    b3_launches = 0
    for option in SJ_OPTIONS:
        outs = {}
        for side, backend in (("card", gpu), ("cpu", "cpu")):
            yml = os.path.join(tmp, f"job{option}_{side}.yml")
            with open(yml, "w") as f:
                if option == 5:
                    f.write(sj_yaml(5, backend, bbox, bj["num_partitions"],
                                    JOIN_R, K, 2, 1, [QUERY],
                                    incremental=True))
                else:
                    f.write(sj_yaml(option, backend, bbox,
                                    bj["num_partitions"], RADIUS, K, 1, 1,
                                    [QUERY, q2]))
            out = os.path.join(tmp, f"job{option}_{side}.csv")
            join_extract.launches = 0
            t0 = time.perf_counter()
            src = join_csv if option == 5 else points_csv
            if streaming_job.main(["--config", yml, "--source",
                                   f"csv:{src}", "--output", out]) != 0:
                raise AssertionError(f"36c: option {option} on {backend}")
            if side == "card":
                if gpu != "cpu":
                    torch.cuda.synchronize()
                sj_secs[option] = time.perf_counter() - t0
                if option == 5:
                    b3_launches = join_extract.launches
            qserve.uninstall()
            with open(out, "rb") as f:
                outs[side] = f.read()
        if outs["card"] != outs["cpu"] or not outs["card"]:
            raise AssertionError(f"36c: option {option}: card "
                                 f"{len(outs['card'])} B, CPU "
                                 f"{len(outs['cpu'])} B")
        sj_lines[option] = outs["card"].count(b"\n")
    if b3_launches < 1:
        raise AssertionError(f"36c: option 5 launched B3 {b3_launches} "
                             "times")
    # Option 3 to Kafka: the records read back equal the CSV output.
    from spatialflink_tpu_torch.streams import kafka_wire as kw

    broker = MiniBroker()
    try:
        bs = f"127.0.0.1:{broker.port}"
        yml = os.path.join(tmp, "job3_card.yml")
        if streaming_job.main(["--config", yml, "--source",
                               f"csv:{points_csv}", "--output",
                               f"kafka:knn_out@{bs}"]) != 0:
            raise AssertionError("36c: option 3 to Kafka")
        client = kw.KafkaWireClient(bs)
        records, offset = [], 0
        while offset < broker.total("knn_out"):
            msgs, _ = client.fetch("knn_out", 0, offset)
            records += [m[3] for m in msgs]
            offset = msgs[-1][0] + 1
        client.close()
    finally:
        broker.close()
    with open(os.path.join(tmp, "job3_card.csv"), "rb") as f:
        if b"".join(r + b"\n" for r in records) != f.read():
            raise AssertionError(f"36c: option 3's {len(records)} Kafka "
                                 "records differ from its CSV output")
    # Option 10, uninterrupted, in process; the children's chain beside.
    t0 = time.perf_counter()
    if streaming_job.main(["--config", gps_yaml, "--source",
                           f"csv:{gps_csv}", "--output",
                           os.path.join(tmp, "job10")]) != 0:
        raise AssertionError("36c: option 10")
    job10_s = time.perf_counter() - t0
    dag_mod.uninstall()
    qserve.uninstall()
    job10_chain.result(timeout=600)
    for name in DAG_NODES:
        with open(os.path.join(tmp, "job10", f"{name}.csv"), "rb") as f:
            clean = f.read()
        with open(os.path.join(tmp, "job10_chaos", f"{name}.csv"),
                  "rb") as f:
            if f.read() != clean:
                raise AssertionError(f"36c: option 10 node {name} differs "
                                     "after kill and resume")
    rates = ", ".join(f"option {o} {sj_lines[o]} lines in {sj_secs[o]:.3f} s"
                      for o in SJ_OPTIONS)
    print(f"e2e streaming_job (36c): {rates} over 2 x "
          f"{SJ_POINTS} Points (YAML backend "
          f"{gpu}), each output byte-identical to backend cpu; option 5 "
          f"incremental launches join_extract={b3_launches}; option 3 -> "
          f"Kafka {len(records)} records equal to its CSV; option 10 "
          f"{job10_s:.3f} s in process, killed at dag.commit "
          f"{DAG_KILL_AT} and resumed in children, every node file equal "
          f"[{card}]")

    # 36b's chain and the smoke.
    resume = json.loads(dag_chain.result(timeout=600).strip()
                        .splitlines()[-1])
    pool.shutdown()
    got = dag_sinks(chaos_dir)
    for name in DAG_NODES:
        if got[name] != want[name]:
            raise AssertionError(f"36b: sink {name} differs after kill and "
                                 f"resume ({len(got[name])} B vs "
                                 f"{len(want[name])} B)")
    if not resume["resumed"]:
        raise AssertionError("36b: the second child did not resume")
    out, err = smoke.communicate(timeout=600)
    mesh_line = mesh_child_line(out)
    if smoke.returncode != 0 or mesh_line is None:
        raise AssertionError(f"36b: dag --smoke exited {smoke.returncode}\n"
                             f"{out[-1000:]}{err[-2000:]}")
    print(f"dag kill and resume (36b): a child killed at dag.commit "
          f"{DAG_KILL_AT} (between two sinks' appends), a child resumed "
          f"from the {resume['resume_ckpt_bytes']} B unit checkpoint, its "
          f"first window {resume['first_window_ms']:.3f} ms after its "
          f"start; all 7 sinks byte-identical to 36a's card run; "
          f"{out.strip().splitlines()[-1]} [{card}]")
    print(f"phase 36 wall: {time.perf_counter() - t_phase:.3f} s (36a "
          f"{t_a:.3f} s) [{card}]")
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return {"join_extract": b3_launches, "mesh_line": mesh_line}


# Phase 37: the mesh layer, four shards on the one card. The legs' sizes
# (PERF.md §4): 37a/37b config 3's stream (bench_suite.py:357-420, seed
# 7) cut to 1 window of 65,536 Points; 37c phase 9's first second and
# phase 20's 2 x 8,192 cut; 37d qserve_1024q_mixed's first of 8 windows
# (34b's stream); 37e bench_tstats_pane cut to 262,144 points and phase
# 26's pane-carry tJoin on the stream's first chunk, 100 panes a side
# (``tpanes_stream`` chunks by 100 panes). The phase took 23.0-28.5 s of
# wall with 2 windows in 37a, 37b and 37d on two whole runs (PERF.md §6),
# over its 25 s, so those legs take one window.
MESH_SHARDS = 4
MESH_WIN = 65_536
MESH_WINDOWS = 1
MESH_QS_WINDOWS = 1
MESH_TS_POINTS = 262_144
MESH_TP_PANES = 100


def mesh_of(gpu, shape=(MESH_SHARDS,), names=("data",)):
    """``shape`` over the card listed once a shard (``cpu`` to rehearse);
    on the card every device must be a CUDA device."""
    import torch

    from spatialflink_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", 0) if gpu == "cuda" else torch.device(gpu)
    mesh = make_mesh(shape, names, devices=[dev] * int(np.prod(shape)))
    if gpu == "cuda" and {d.type for d in mesh.devices.flat} != {"cuda"}:
        raise AssertionError(f"phase 37: mesh {mesh} is not on the card")
    return mesh


def mesh_leg(label, run, card, gpu, mesh=None, windows=len):
    """``run(mesh)`` unsharded, then on ``mesh`` (by default the four-shard
    data mesh), each with telemetry on and the device synchronised;
    returns (unsharded result, mesh result, {"join_extract",
    "polyline_min_dist": the mesh run's launches}) and prints both runs'
    ms a window (``windows(result)`` windows), the collective gauges and
    the launches."""
    import torch

    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.telemetry import telemetry

    def timed(mesh):
        telemetry.enable()
        try:
            join_extract.launches = polyline_min_dist.launches = 0
            t0 = time.perf_counter()
            out = run(mesh)
            if gpu == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            gauges = telemetry.collective_gauges()
        finally:
            telemetry.disable()
        return out, secs, gauges, {
            "join_extract": join_extract.launches,
            "polyline_min_dist": polyline_min_dist.launches}

    one, one_s, _, one_l = timed(None)
    got, mesh_s, gauges, launches = timed(mesh or mesh_of(gpu))
    n_windows = windows(one)
    kinds = ", ".join(f"{k} {v['calls']} calls {v['bytes']} B"
                      for k, v in sorted((gauges or {}).get(
                          "by_kind", {}).items())) or "none"
    print(f"mesh {label}: {n_windows} windows, mesh "
          f"{1e3 * mesh_s / n_windows:.3f} ms a window, unsharded "
          f"{1e3 * one_s / n_windows:.3f} ms a window (4 shards on one "
          f"{card} — not a scaling figure); collectives: {kinds}; launches "
          f"on the mesh run join_extract={launches['join_extract']} "
          f"polyline_min_dist={launches['polyline_min_dist']} (unsharded "
          f"join_extract={one_l['join_extract']} polyline_min_dist="
          f"{one_l['polyline_min_dist']}) [{card}]")
    return one, got, launches


def check_mesh(card, gpu="cuda", smoke_line=None):
    """Phase 37: the mesh layer. Returns {"join_extract",
    "polyline_min_dist": the launches of the legs' mesh runs}.
    ``smoke_line``: the mesh child's line from phase 36's DAG smoke;
    without one (``--mesh-only``) the DAG's mesh child runs in the
    background from the phase's start, and a failure kills it."""
    import os
    import tempfile

    tmp = tempfile.mkdtemp(prefix="phase37_")
    child = None
    if smoke_line is None:
        child = start_background(
            [sys.executable, "-m", "spatialflink_tpu_torch.dag",
             "--mesh-child", "--device", gpu],
            env=dict(os.environ,
                     SFT_LEDGER_STREAM=os.path.join(tmp, "mesh.jsonl")))
    try:
        return run_mesh_phase(card, gpu, child, smoke_line)
    finally:
        if child is not None and child.poll() is None:
            child.kill()
            child.wait()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)


def mesh_child_line(out):
    """The DAG mesh child's "collective bytes" line in ``out``, or None."""
    lines = [ln for ln in out.splitlines()
             if ln.startswith("dag-mesh-child: collective bytes")]
    return lines[0] if lines else None


def run_mesh_phase(card, gpu, child, smoke_line):
    import torch

    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch import qserve, streaming_job
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import QueryConfiguration
    from spatialflink_tpu_torch.operators.join_query import (
        grid_hash_join_batches,
    )
    from spatialflink_tpu_torch.streams.panes import (
        pane_spatial_bound,
        traj_stats_sliding,
    )

    t_phase = time.perf_counter()
    grid = UniformGrid(**BEIJING)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    total = {"join_extract": 0, "polyline_min_dist": 0}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def legs_wall(label, t0):
        print(f"phase 37 {label}: {time.perf_counter() - t0:.3f} s [{card}]")

    # 37a. The point range run through B4, one launch a shard a window.
    t0 = time.perf_counter()
    stream = range_objects(MESH_WINDOWS, MESH_WIN, 7)
    polys = range_polygons()

    def range_run(mesh):
        op = ops.PointPolygonRangeQuery(conf, grid, device=gpu)
        return [(r.start, r.end, r.window_count,
                 [o.obj_id for o in r.objects],
                 np.asarray(r.dists, np.float32).tobytes())
                for r in op.run(iter(stream), polys, RANGE_R, mesh=mesh)]

    one, got, launches = mesh_leg("37a range", range_run, card, gpu)
    if got != one or len(got) != MESH_WINDOWS or not all(w[3] for w in one):
        raise AssertionError("37a: the mesh range run differs from the "
                             "unsharded run")
    if gpu == "cuda" and launches["polyline_min_dist"] != \
            MESH_SHARDS * MESH_WINDOWS:
        raise AssertionError(f"37a: {launches['polyline_min_dist']} B4 "
                             "launches")
    add(launches)
    print(f"mesh 37a range: {sum(len(w[3]) for w in got)} kept Points, keep "
          f"sets and distance bits equal to the unsharded run [{card}]")
    legs_wall("a", t0)

    # 37b. kNN run (k = 50) and run_multi on the (2, 2) mesh.
    t0 = time.perf_counter()
    q = Point(x=QUERY[0], y=QUERY[1])

    def knn_run(mesh):
        op = ops.PointPointKNNQuery(conf, grid, device=gpu)
        return [(r.start, r.end, [(o, np.float32(d).tobytes(), p.obj_id)
                                  for o, d, p in r.neighbors])
                for r in op.run(iter(stream), q, RADIUS, K, mesh=mesh)]

    one, got, launches = mesh_leg("37b run", knn_run, card, gpu)
    if got != one or not all(len(w[2]) == K for w in got):
        raise AssertionError("37b: the mesh kNN run differs from the "
                             "unsharded run")
    rng = np.random.default_rng(23)
    queries = [Point(x=float(x), y=float(y)) for x, y in zip(
        rng.uniform(115.5, 117.6, MULTI_Q), rng.uniform(39.6, 41.1, MULTI_Q))]

    def multi_run(mesh):
        op = ops.PointPointKNNQuery(conf, grid, device=gpu)
        return [(r.start, r.end, [[(o, np.float32(d).tobytes())
                                   for o, d, _ in one.neighbors]
                                  for one in r.results])
                for r in op.run_multi(iter(stream), queries, MULTI_R,
                                      MULTI_K, mesh=mesh)]

    one, got, launches = mesh_leg(
        "37b run_multi", multi_run, card, gpu,
        mesh=mesh_of(gpu, (2, 2), ("data", "query")))
    if got != one or not sum(len(x) for w in got for x in w[2]):
        raise AssertionError("37b: the mesh run_multi differs from the "
                             "unsharded run")
    print(f"mesh 37b kNN: run's top-{K} and run_multi's {MULTI_Q} queries' "
          f"top-{MULTI_K} equal to the unsharded runs, distance bits "
          f"included [{card}]")
    legs_wall("b", t0)

    # 37c. The point join through B3 a shard, the budget retry, and
    # point ⋈ polygon through B4 gathered a shard.
    t0 = time.perf_counter()
    left, right = (side[:JOIN_OBJ_POINTS] for side in join_objects())

    def pairs_of(results):
        return [(r.start, r.end, r.overflow, sorted(
            (a.obj_id, b.obj_id, np.float32(d).tobytes())
            for a, b, d in r.pairs)) for r in results]

    def join_run(mesh):
        op = ops.PointPointJoinQuery(conf, grid, cap=JOIN_CAP, device=gpu)
        return pairs_of(op.run(iter(left), iter(right), JOIN_R, mesh=mesh))

    one, got, launches = mesh_leg("37c join", join_run, card, gpu)
    if got != one or not got[0][3] or got[0][2]:
        raise AssertionError("37c: the mesh join differs from the unsharded "
                             "run")
    if gpu == "cuda" and launches["join_extract"] < MESH_SHARDS:
        raise AssertionError(f"37c: {launches['join_extract']} B3 launches")
    add(launches)
    # The retry: the window again with a budget of half its pairs, grown
    # as the operator grows it until the mesh's count fits.
    jop = ops.PointPointJoinQuery(conf, grid, cap=JOIN_CAP, device=gpu)
    lb, rb = jop.point_batch(left), jop.point_batch(right)
    n_pairs = len(one[0][3])
    budget, tries, counts = n_pairs // 2, 0, []
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    join_extract.launches = 0
    while True:
        res = grid_hash_join_batches(grid, lb, rb, JOIN_R, JOIN_CAP, budget,
                                     jop.device, mesh=mesh_of(gpu))
        tries += 1
        count = int(res.count)
        counts.append(count)
        if count <= budget:
            break
        budget = int(2 ** np.ceil(np.log2(count)))
    retry_launches = join_extract.launches
    total["join_extract"] += retry_launches
    li, ri, dd = (t.cpu().numpy() for t in (res.left_index[:count],
                                            res.right_index[:count],
                                            res.dist[:count]))
    keep = li >= 0
    retried = sorted((left[a].obj_id, right[b].obj_id, d.tobytes())
                     for a, b, d in zip(li[keep], ri[keep], dd[keep]))
    if tries < 2 or retried != one[0][3]:
        raise AssertionError(f"37c: the budget retry took {tries} tries "
                             f"(counts {counts}) or its pairs differ")
    print(f"mesh 37c join retry: budget {n_pairs // 2} for {n_pairs} "
          f"pairs, mesh counts {counts} over {tries} tries (a shard past "
          f"its share inflates the count), final budget {budget}, pairs "
          f"equal to the unsharded run; join_extract={retry_launches} "
          f"[{card}]")
    xy, ts = pg_points()
    cut_n = JOIN_CUT_WINDOWS * JOIN_CUT_WIN
    cut_ts = (np.arange(cut_n, dtype=np.int64) * 1000) // JOIN_CUT_WIN
    pts = [Point(obj_id=f"p{i}", timestamp=int(t), x=float(x), y=float(y))
           for i, (t, (x, y)) in enumerate(zip(
               cut_ts.tolist(), xy[:cut_n].astype(np.float64).tolist()))]
    pobjs = polygon_objects(pg_polygons(), JOIN_CUT_WINDOWS)

    def pg_run(mesh):
        op = ops.PointPolygonJoinQuery(conf, grid, device=gpu)
        return pairs_of(op.run(iter(pts), iter(pobjs), PG_R, mesh=mesh))

    one, got, launches = mesh_leg("37c point-polygon join", pg_run, card,
                                  gpu)
    if got != one or not all(w[3] for w in got):
        raise AssertionError("37c: the mesh point-polygon join differs from "
                             "the unsharded run")
    if gpu == "cuda" and launches["polyline_min_dist"] < \
            MESH_SHARDS * JOIN_CUT_WINDOWS:
        raise AssertionError(f"37c: {launches['polyline_min_dist']} B4 "
                             "launches")
    add(launches)
    print(f"mesh 37c joins: {sum(len(w[3]) for w in got)} point-polygon "
          f"pairs, every pair set with its distance bits equal to the "
          f"unsharded run [{card}]")
    legs_wall("c", t0)

    # 37d. qserve_1024q_mixed's first window (34b's stream, cut).
    t0 = time.perf_counter()
    qxy, qoid = qserve_points()
    events = [e for e in qserve_command_stream(qxy, qoid)
              if e.timestamp < 1000 * MESH_QS_WINDOWS]

    def qserve_run(mesh):
        op = qserve.QServeOperator(conf, grid, device=gpu)
        try:
            return [(r.start, r.end, list(r.lines()))
                    for r in op.run(iter(events), mesh=mesh)]
        finally:
            qserve.uninstall()

    one, got, launches = mesh_leg("37d qserve", qserve_run, card, gpu)
    if got != one or not all(w[2] for w in got):
        raise AssertionError("37d: the mesh qserve run differs from the "
                             "unsharded run")
    print(f"mesh 37d qserve: {sum(len(w[2]) for w in got)} egress lines "
          f"equal to the unsharded run [{card}]")
    legs_wall("d", t0)

    # 37e. The tStats pane engine and the pane-carry tJoin.
    t0 = time.perf_counter()
    ts_, xy_, oid_ = (a[:MESH_TS_POINTS] for a in tstats_stream())
    args = (ts_, xy_, oid_, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS)

    def tstats_run(mesh):
        return traj_stats_sliding(*args, backend="device", device=gpu,
                                  mesh=mesh)

    one, got, _ = mesh_leg("37e traj_stats_sliding", tstats_run, card, gpu,
                           windows=lambda r: len(r.starts))
    err = check_pane_windows(got, one, pane_spatial_bound(*args),
                             "37e traj_stats_sliding")
    chunks = tpanes_stream()
    cut = [[{k: v[:MESH_TP_PANES * TP_PANE_PTS] for k, v in side[0].items()}]
           for side in chunks]
    tconf = QueryConfiguration(window_size=TP_PPW * TP_SLIDE_MS / 1000,
                               slide_step=TP_SLIDE_MS / 1000)

    def tjoin_run(mesh):
        op = ops.PointPointTJoinQuery(tconf, grid, device=gpu)
        return list(op.run_soa_panes(cut[0], cut[1], TP_R, TP_IDS,
                                     cap_w=TP_CAP_W, pair_sel=TP_PAIR_SEL,
                                     backend="device", mesh=mesh))

    one_t, got_t, _ = mesh_leg("37e run_soa_panes", tjoin_run, card, gpu)
    if len(got_t) != len(one_t) or not all(
            same_window(a, b) for a, b in zip(got_t, one_t)) \
            or not sum(w[5] for w in got_t):
        raise AssertionError("37e: the mesh pane-carry tJoin differs from "
                             "the unsharded run")
    print(f"mesh 37e trajectories: {len(got.starts)} tStats windows, counts "
          f"and temporal sums equal, spatial within pane_spatial_bound (max "
          f"|err| {err[0]:.6g}, {err[1]:.3g} of the bound); "
          f"{len(got_t)} tJoin windows equal to the unsharded run [{card}]")
    legs_wall("e", t0)

    # 37f. The entry points: deviceMesh above the visible cards, and the
    # DAG smoke's mesh child (started at the phase's start).
    t0 = time.perf_counter()
    import os
    import tempfile

    if gpu == "cuda":
        with tempfile.TemporaryDirectory(prefix="phase37f_") as tmp:
            yml = os.path.join(tmp, "job.yml")
            csv = os.path.join(tmp, "in.csv")
            with open(csv, "w") as f:
                f.write(f"d0,0,{QUERY[0]},{QUERY[1]}\n")
            with open(yml, "w") as f:
                f.write(sj_yaml(1, "cuda", (BEIJING["min_x"], BEIJING["min_y"],
                                            BEIJING["max_x"], BEIJING["max_y"]),
                                BEIJING["num_partitions"], RADIUS, K, 1, 1,
                                [QUERY]) + "deviceMesh: [4]\n")
            want = f"need 4 devices, have {torch.cuda.device_count()}"
            try:
                streaming_job.main(["--config", yml, "--source",
                                    f"csv:{csv}", "--output",
                                    os.path.join(tmp, "out.csv")])
            except ValueError as e:
                if str(e) != want:
                    raise AssertionError(f"37f: deviceMesh [4] raised {e!r}")
            else:
                raise AssertionError("37f: deviceMesh [4] on one card ran")
        print(f"mesh 37f streaming_job: deviceMesh [4] on backend cuda "
              f"raises {want!r} [{card}]")
    if child is not None:
        out, err_ = child.communicate(timeout=600)
        smoke_line = mesh_child_line(out) if child.returncode == 0 else None
        if smoke_line is None:
            raise AssertionError(f"37f: the DAG mesh child exited "
                                 f"{child.returncode}\n{out[-1000:]}"
                                 f"{err_[-2000:]}")
    if int(smoke_line.split()[3]) <= 0:
        raise AssertionError(f"37f: {smoke_line}")
    who = "phase 36b's smoke" if child is None else "this phase's"
    print(f"mesh 37f dag: {smoke_line} ({who} --mesh-child on the card) "
          f"[{card}]")
    legs_wall("f", t0)
    print(f"phase 37 wall: {time.perf_counter() - t_phase:.3f} s; mesh runs "
          f"added join_extract={total['join_extract']} polyline_min_dist="
          f"{total['polyline_min_dist']} launches [{card}]")
    return total


# Phase 38: the grid-partitioned halo layer and multi-process runs. 38a is
# the JAX suite's range_8shard_halo (bench_suite.py:1443-1523: Beijing
# grid n = 1,024, r = 0.002, one-layer halo; 4 windows of 16,384 points
# and 4,096 query points from seed 47; 8 shards), uncut, in float64; 38c
# its tjoin_8shard_halo (bench_suite.py:1525-1642: grid n = 256, r =
# 0.005, ppw 4, 8 slides of 2,048 points a side from seeds 53 and 54),
# uncut; 38d the halo registry bucket on qserve_1024q_mixed's first
# window (131,072 points, the 1,024 queries, the plan built for the
# largest radius class, k = 32 over 16,384 objIDs).
HALO_SHARDS = 8
HALO_N = 1024
HALO_R = 0.002
HALO_WIN = 16_384
HALO_WINDOWS = 4
HALO_QUERIES = 4096
HALO_SEED = 47
HT_N = 256
HT_R = 0.005
HT_PPW = 4
HT_SLIDE_PTS = 2048
HT_SLIDES = 8
HT_BUDGET = 65_536
HT_CUT_SLIDE = 5        # the slide run again at a budget below its pairs
HR_K = 32
HR_R_MAX = 0.05         # the qserve set's largest radius class


def halo_grid(n):
    from spatialflink_tpu_torch.grid import UniformGrid

    return UniformGrid(n, BEIJING["min_x"], BEIJING["max_x"],
                       BEIJING["min_y"], BEIJING["max_y"])


def halo_mesh(gpu):
    """The eight-shard data mesh of 38a-38d: ``gpu`` listed once a shard
    (``cuda:0`` on the card)."""
    from spatialflink_tpu_torch.parallel.mesh import data_mesh

    dev = "cuda:0" if gpu == "cuda" else gpu
    mesh = data_mesh(HALO_SHARDS, devices=[dev] * HALO_SHARDS)
    if gpu == "cuda" and {d.type for d in mesh.devices.flat} != {"cuda"}:
        raise AssertionError(f"phase 38: mesh {mesh} is not on the card")
    return mesh


def halo_range_inputs():
    """38a's stream, as the suite makes it: (grid, plan, xy, cell, qxy,
    qcell), float64 positions."""
    from spatialflink_tpu_torch.parallel.partition import plan_partition

    grid = halo_grid(HALO_N)
    rng = np.random.default_rng(HALO_SEED)
    total = HALO_WIN * HALO_WINDOWS
    xy = np.stack([rng.uniform(115.5, 117.6, total),
                   rng.uniform(39.6, 41.1, total)], axis=1)
    qxy = np.stack([rng.uniform(115.6, 117.5, HALO_QUERIES),
                    rng.uniform(39.7, 41.0, HALO_QUERIES)], axis=1)
    return (grid, plan_partition(grid, HALO_SHARDS, HALO_R), xy,
            grid.assign_cells_np(xy), qxy, grid.assign_cells_np(qxy))


def halo_range_run(gpu, inputs):
    """38a's windows through ``sharded_range_halo`` on the eight-shard
    mesh of ``gpu``: ([(keep, dist)] a window, seconds)."""
    grid, plan, xy, cell, qxy, qcell = inputs
    mesh = halo_mesh(gpu)
    ok, qok = np.ones(HALO_WIN, bool), np.ones(HALO_QUERIES, bool)
    from spatialflink_tpu_torch.parallel.halo import sharded_range_halo

    t0 = time.perf_counter()
    out = []
    for w in range(HALO_WINDOWS):
        sl = slice(w * HALO_WIN, (w + 1) * HALO_WIN)
        out.append(sharded_range_halo(mesh, plan, xy[sl], ok, cell[sl], qxy,
                                      qcell, qok, HALO_R))
    return out, time.perf_counter() - t0


def halo_tjoin_inputs():
    """38c's panes, as the suite makes them: (plan, left, right, ts),
    each side a list of (xy, valid, cell) slides."""
    from spatialflink_tpu_torch.parallel.partition import plan_partition

    grid = halo_grid(HT_N)
    total = HT_SLIDE_PTS * HT_SLIDES
    ok = np.ones(HT_SLIDE_PTS, bool)

    def side(seed):
        r = np.random.default_rng(seed)
        sxy = np.stack([r.uniform(115.5, 117.6, total),
                        r.uniform(39.6, 41.1, total)], axis=1)
        scell = grid.assign_cells_np(sxy)
        return [(sxy[i * HT_SLIDE_PTS:(i + 1) * HT_SLIDE_PTS], ok,
                 scell[i * HT_SLIDE_PTS:(i + 1) * HT_SLIDE_PTS])
                for i in range(HT_SLIDES)]

    return (plan_partition(grid, HALO_SHARDS, HT_R), side(53), side(54),
            np.arange(HT_SLIDES, dtype=np.int64) * 1000)


def halo_slide(panes, i):
    lo = max(0, i - HT_PPW + 1)
    return tuple(np.concatenate([p[j] for p in panes[lo:i + 1]])
                 for j in range(3))


def halo_tjoin_cut(gpu, inputs, budget):
    """38c's slide ``HT_CUT_SLIDE`` through ``sharded_join_halo`` at
    ``budget`` pairs a shard."""
    from spatialflink_tpu_torch.parallel.halo import sharded_join_halo

    plan, left, right, _ = inputs
    return sharded_join_halo(halo_mesh(gpu), plan,
                             *halo_slide(left, HT_CUT_SLIDE),
                             *halo_slide(right, HT_CUT_SLIDE), HT_R, budget)


def halo_registry_inputs():
    """38d's window and queries: qserve_1024q_mixed's first window of
    131,072 float64 points and its 1,024 queries, k = 32 for all; the
    plan for the largest radius class."""
    from spatialflink_tpu_torch.parallel.partition import plan_partition

    grid = halo_grid(BEIJING["num_partitions"])
    xy, oid = qserve_points()
    xy, oid = xy[:QS_WIN], oid[:QS_WIN]
    rng = np.random.default_rng(QS_QUERY_SEED)
    qs = [qserve_query(rng, i) for i in range(QS_QUERIES)]
    qxy = np.array([[q.x, q.y] for q in qs])
    radius = np.array([q.radius for q in qs])
    return (grid, plan_partition(grid, HALO_SHARDS, HR_R_MAX), xy,
            grid.assign_cells_np(xy), oid, qxy, grid.assign_cells_np(qxy),
            radius)


def halo_registry_run(gpu, inputs):
    """38d through ``sharded_registry_bucket_halo`` on the mesh of
    ``gpu``: (dist, segment, num_valid, within), seconds."""
    from spatialflink_tpu_torch.parallel.halo import (
        sharded_registry_bucket_halo,
    )

    grid, plan, xy, cell, oid, qxy, qcell, radius = inputs
    t0 = time.perf_counter()
    out = sharded_registry_bucket_halo(
        halo_mesh(gpu), plan, xy, np.ones(len(xy), bool), cell, oid, qxy,
        qcell, radius, np.ones(len(qxy), bool), k=HR_K, num_segments=QS_IDS)
    return out, time.perf_counter() - t0


def same_bytes(a, b) -> bool:
    """Two host results equal bit for bit: dtype, shape and bytes."""
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


#: Phase 38's child processes: stopped if the run ends before the phase
#: collects them.
PARTITION_CHILDREN = []


def start_partition_children(gpu):
    """38b's and 38e's processes, started before phase 38 so that they
    overlap other work: the sharded chaos child clean on ``gpu`` and on
    the CPU, the armed child killed mid-exchange then its resume (a
    thread waits on the pair), and the two-process dry run
    (``multihost_dryrun``'s ``run_dryrun(num_processes=2,
    local_devices=2, device=gpu)``). Returns the handles
    ``check_partition`` joins."""
    import tempfile
    import threading

    tmp = tempfile.mkdtemp(prefix="phase38_")
    h = {"tmp": tmp, "errors": [], "t0": time.perf_counter()}

    def child(name, device, plan=None):
        d = os.path.join(tmp, name)
        os.makedirs(d, exist_ok=True)
        env = {"SFT_FAULT_PLAN": json.dumps(plan)} if plan else None
        return d, start_background(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--chaos-sharded-child", d, "--device", device], env,
            owner=PARTITION_CHILDREN)

    h["clean"] = child("clean", gpu)
    h["cpu"] = child("cpu", "cpu")
    h["dryrun"] = start_background(
        [sys.executable, "-m", "spatialflink_tpu_torch.parallel."
         "multihost_dryrun", "--device", gpu], owner=PARTITION_CHILDREN)
    plan = [{"point": "shard.exchange", "kind": "abort", "at": 5}]
    kill_dir, kill = child("chaos", gpu, plan)

    def chain():
        try:
            _, err = kill.communicate(timeout=300)
            if kill.returncode != 137:
                raise AssertionError(f"38b: the kill child exited "
                                     f"{kill.returncode}, not 137\n"
                                     f"{err[-2000:]}")
            h["killed_s"] = time.perf_counter() - h["t0"]
            h["resume"] = child("chaos", gpu)
            out, err = h["resume"][1].communicate(timeout=300)
            if h["resume"][1].returncode != 0:
                raise AssertionError(f"38b: the resume child failed\n"
                                     f"{err[-2000:]}")
            h["resumed_s"] = time.perf_counter() - h["t0"]
        except BaseException as e:  # re-raised by check_partition
            h["errors"].append(e)

    h["thread"] = threading.Thread(target=chain, daemon=True)
    h["thread"].start()
    return h


def check_partition(card, gpu="cuda", children=None):
    """Phase 38: the grid-partitioned halo layer and multi-process runs.
    ``children``: 38b's and 38e's processes (``start_partition_children``)
    when an earlier phase started them, else they start here."""
    import shutil

    t_phase = time.perf_counter()
    h = children or start_partition_children(gpu)
    try:
        run_partition_phase(card, gpu, h)
    finally:
        stop_children(PARTITION_CHILDREN)
        h["thread"].join(timeout=60)
        shutil.rmtree(h["tmp"], ignore_errors=True)
    print(f"phase 38 wall: {time.perf_counter() - t_phase:.3f} s of this "
          f"process (the children started "
          f"{t_phase - h['t0']:.3f} s before it) [{card}]")


def run_partition_phase(card, gpu, h):
    import torch

    from spatialflink_tpu_torch.ops.halo import (
        join_partitioned_kernel,
        range_partitioned_kernel,
        registry_bucket_partitioned_kernel,
    )
    from spatialflink_tpu_torch.parallel.sharded import sharded_range_query
    from spatialflink_tpu_torch.telemetry import telemetry

    dev = torch.device("cuda", 0) if gpu == "cuda" else torch.device(gpu)

    def sync():
        if gpu == "cuda":
            torch.cuda.synchronize()

    def on(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in arrays]

    def gauges(run):
        telemetry.enable()
        try:
            out = run()
            coll = telemetry.snapshot().get("collectives") or {}
        finally:
            telemetry.disable()
        return out, coll

    # 38a. The halo range at range_8shard_halo, against the single-device
    # kernel and the replicated flag-table path on the card.
    t0 = time.perf_counter()
    inputs = halo_range_inputs()
    grid, plan, xy, cell, qxy, qcell = inputs
    halo_range_run(gpu, inputs)  # warm: the first CUDA calls of the phase
    sync()
    (got, secs), coll = gauges(lambda: halo_range_run(gpu, inputs))
    sync()
    ok = np.ones(HALO_WIN, bool)
    q_t = on(qxy, qcell, np.ones(HALO_QUERIES, bool))
    table = grid.neighbor_flags(HALO_R, [int(c) for c in qcell])
    single_s = 0.0
    replicated_bytes = 0
    for w, (keep, dist) in enumerate(got):
        sl = slice(w * HALO_WIN, (w + 1) * HALO_WIN)
        p_t = on(xy[sl], ok, cell[sl])
        sync()
        t1 = time.perf_counter()
        keep1, dist1 = range_partitioned_kernel(
            p_t[0], p_t[1], p_t[2], q_t[0], q_t[1], q_t[2], HALO_R,
            grid_n=plan.grid_n, layers=plan.layers,
            guaranteed=plan.guaranteed)
        keep1, dist1 = keep1.cpu().numpy(), dist1.cpu().numpy()
        single_s += time.perf_counter() - t1
        if not (same_bytes(keep, keep1) and same_bytes(dist, dist1)):
            raise AssertionError(f"38a: window {w} differs from the "
                                 f"single-device kernel on the card")
        (keep_r, _), legacy = gauges(lambda: sharded_range_query(
            halo_mesh(gpu), p_t[0], p_t[1],
            on(table[cell[sl]])[0], q_t[0], HALO_R))
        replicated_bytes += int(legacy.get("bytes") or 0)
        if not np.array_equal(keep, keep_r.cpu().numpy()):
            raise AssertionError(f"38a: window {w}'s keep set differs from "
                                 f"the replicated flag-table path")
    hits = sum(int(k.sum()) for k, _ in got)
    if not hits:
        raise AssertionError("38a: no point kept (a vacuous check)")
    halo_b = int(((coll.get("by_kind") or {}).get("ppermute") or {})
                 .get("bytes") or 0)
    halo_state = int(coll.get("halo_state_bytes") or 0)
    if gpu == "cuda" and halo_b * 4 > replicated_bytes:
        raise AssertionError(f"38a: the halo moved {halo_b} B against the "
                             f"replicated path's {replicated_bytes} B")
    print(f"partition 38a range_halo: {HALO_WINDOWS} windows x {HALO_WIN} "
          f"points x {HALO_QUERIES} queries, {hits} kept, float64; mesh "
          f"{1e3 * secs / HALO_WINDOWS:.3f} ms a window ({HALO_SHARDS} "
          f"shards on one {card} — not a scaling figure), single-device "
          f"kernel {1e3 * single_s / HALO_WINDOWS:.3f} ms a window; keep "
          f"and dist bits equal to it, keep sets equal to the replicated "
          f"sharded_range_query; collectives: halo ppermute {halo_b} B, "
          f"halo state {halo_state} B, replicated broadcast "
          f"{replicated_bytes} B [{card}]")

    def held_range(got=got):
        want, cpu_s = twin("halo_range", xy, qxy)
        for w, ((k, d), (wk, wd)) in enumerate(zip(got, want)):
            if not (same_bytes(k, wk) and same_bytes(d, wd)):
                raise AssertionError(f"38a: window {w} differs from the "
                                     f"CPU run")
        print(f"exact partition 38a: all {len(got)} windows equal the CPU "
              f"run ({cpu_s:.3f} s on the host CPU) [{card}]")
    later(held_range)
    print(f"phase 38 a: {time.perf_counter() - t0:.3f} s [{card}]")

    # 38c. The halo join and the tJoin pane scan at tjoin_8shard_halo.
    t0 = time.perf_counter()
    from spatialflink_tpu_torch.parallel.halo import sharded_tjoin_panes_halo

    tj = halo_tjoin_inputs()
    tplan, left, right, ts = tj
    mesh = halo_mesh(gpu)
    sync()
    t1 = time.perf_counter()
    res = sharded_tjoin_panes_halo(mesh, tplan, ts, left, right, HT_R,
                                   HT_PPW, HT_BUDGET)
    sync()
    mesh_s = time.perf_counter() - t1
    single_s, pairs = 0.0, 0
    for i, (li, ri, dv, count, over) in enumerate(res):
        args = on(*halo_slide(left, i), *halo_slide(right, i))
        sync()
        t1 = time.perf_counter()
        out = join_partitioned_kernel(*args, HT_R, grid_n=tplan.grid_n,
                                      layers=tplan.layers, budget=HT_BUDGET)
        wli, wri, wdv, wcount, wover = (o.cpu().numpy() for o in out)
        single_s += time.perf_counter() - t1
        found = wli >= 0
        order = np.lexsort((wri[found], wli[found]))
        if (count, over) != (int(wcount), int(wover)) or over or not (
                same_bytes(li, wli[found][order])
                and same_bytes(ri, wri[found][order])
                and same_bytes(dv, wdv[found][order])):
            raise AssertionError(f"38c: slide {i} differs from the "
                                 f"single-device kernel on the card")
        pairs += count
    if not pairs:
        raise AssertionError("38c: no pair (a vacuous check)")
    full = res[HT_CUT_SLIDE][3]
    budget = max(1, full // (2 * HALO_SHARDS))
    cut = halo_tjoin_cut(gpu, tj, budget)
    want = halo_tjoin_cut("cpu", tj, budget)
    if cut[3] != full or cut[4] <= 0 or not all(
            same_bytes(a, b) for a, b in zip(cut, want)):
        raise AssertionError(f"38c: the budget-cut slide (count {cut[3]}, "
                             f"overflow {cut[4]}) differs from its CPU run")
    print(f"partition 38c tjoin_halo: {HT_SLIDES} slides x {HT_SLIDE_PTS} "
          f"points a side, ppw {HT_PPW}, {pairs} pairs; mesh "
          f"{1e3 * mesh_s / HT_SLIDES:.3f} ms a slide, single-device kernel "
          f"{1e3 * single_s / HT_SLIDES:.3f} ms a slide, every slide's "
          f"pairs, count and distance bits equal to it; slide "
          f"{HT_CUT_SLIDE} at {budget} pairs a shard: count {cut[3]}, "
          f"overflow {cut[4]}, the kept pairs equal to its CPU run "
          f"[{card}]")
    print(f"phase 38 c: {time.perf_counter() - t0:.3f} s [{card}]")

    # 38d. The halo registry bucket on qserve_1024q_mixed's first window.
    t0 = time.perf_counter()
    rin = halo_registry_inputs()
    rgrid, rplan, rxy, rcell, roid, rqxy, rqcell, rrad = rin
    got_r, reg_s = halo_registry_run(gpu, rin)
    args = on(rxy, np.ones(len(rxy), bool), rcell, roid, rqxy, rqcell, rrad,
              np.ones(len(rqxy), bool))
    sync()
    t1 = time.perf_counter()
    one = [o.cpu().numpy() for o in registry_bucket_partitioned_kernel(
        *args, grid_n=rplan.grid_n, layers=rplan.layers, k=HR_K,
        num_segments=QS_IDS)]
    one_s = time.perf_counter() - t1
    if not all(same_bytes(a, b) for a, b in zip(got_r, one)):
        raise AssertionError("38d: the halo registry bucket differs from "
                             "the single-device kernel on the card")
    if not got_r[3].sum():
        raise AssertionError("38d: no query found an object (vacuous)")
    print(f"partition 38d registry_halo: {QS_WIN} points x {QS_QUERIES} "
          f"queries, k = {HR_K}, plan for r = {HR_R_MAX} ({rplan.layers} "
          f"layers, halo {rplan.halo} cells), {int(got_r[3].sum())} "
          f"in-radius objects over the queries; mesh {1e3 * reg_s:.3f} ms "
          f"(with its first call), single-device kernel {1e3 * one_s:.3f} "
          f"ms; every lane equal to it [{card}]")

    def held_registry(got=got_r):
        want, cpu_s = twin("halo_registry", rxy, rqxy, rrad)
        if not all(same_bytes(a, b) for a, b in zip(got, want)):
            raise AssertionError("38d: differs from the CPU run")
        print(f"exact partition 38d: the bucket equals the CPU run "
              f"({cpu_s:.3f} s on the host CPU) [{card}]")
    later(held_registry)
    print(f"phase 38 d: {time.perf_counter() - t0:.3f} s [{card}]")

    # 38b and 38e: join the children started before the phase.
    t0 = time.perf_counter()
    h["thread"].join(timeout=600)
    if h["errors"]:
        raise h["errors"][0]
    egress = {}
    for name in ("clean", "cpu"):
        d, proc = h[name]
        _, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"38b: the {name} child failed\n"
                                 f"{err[-2000:]}")
        with open(os.path.join(d, "egress.csv"), "rb") as f:
            egress[name] = f.read()
    with open(os.path.join(h["resume"][0], "egress.csv"), "rb") as f:
        egress["resumed"] = f.read()
    if not egress["clean"] or len(set(egress.values())) != 1:
        raise AssertionError(
            "38b: the resumed egress differs from the clean card run or "
            "the CPU run (" + ", ".join(f"{k} {len(v)} B"
                                        for k, v in egress.items()) + ")")
    lines = egress["resumed"].count(b"\n")
    print(f"partition 38b run_partitioned: killed at the 5th shard.exchange "
          f"(exit 137) {h['killed_s']:.3f} s and resumed "
          f"{h['resumed_s']:.3f} s after the children started; the resumed "
          f"egress ({len(egress['resumed'])} B, {lines} lines) "
          f"byte-identical to the clean {gpu} run and the CPU run [{card}]")
    out, err = h["dryrun"].communicate(timeout=300)
    dryrun_s = time.perf_counter() - h["t0"]
    oks = [ln for ln in out.splitlines() if ln.startswith("MULTIHOST")]
    if h["dryrun"].returncode != 0 or len(oks) != 2 or not all(
            "procs=2" in ln and "devices=4" in ln for ln in oks):
        raise AssertionError(f"38e: the dry run exited "
                             f"{h['dryrun'].returncode}, printed {oks}\n"
                             f"{err[-2000:]}")
    mode = "not read (no card)"
    if gpu == "cuda":
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True, timeout=60).stdout.strip()
    print(f"partition 38e multihost dry run: two gloo ranks x 2 shards of "
          f"{gpu}, sharded_knn equal to knn_kernel on each, done "
          f"{dryrun_s:.3f} s after the children started; compute mode "
          f"{mode}; "
          + "; ".join(oks) + f" [{card}]")
    print(f"phase 38 b+e (the wait for the children): "
          f"{time.perf_counter() - t0:.3f} s [{card}]")


# Phase 39: the four programs that gather over a mesh spanning two
# processes, on two gloo ranks of ``cuda:0`` owning two shards each (NCCL
# refuses two ranks on one card), each leg against the same program on a
# mesh of four ``cuda:0`` shards in one process. 39a: config 3's stream
# generator (bench_suite.py:357-420, seed 7), 262,144 points, against
# 1,024 query points uniform in the Beijing box from seed 8 at r = 0.002
# (the JAX docstring's "1k queries sharded across chips",
# spatialflink_tpu/parallel/sharded.py:218-221), on a (2, 2) mesh; 39b:
# knn_multi_64queries_k10 (bench_suite.py:503-515) on its first 262,144-
# point window, 64 queries, k = 10, 16,384 objIDs, on a (2, 2) mesh; 39c:
# 38d's qserve_1024q_mixed window (131,072 points, its 1,024 queries,
# k = 32), 1-D mesh of 4; 39d: tjoin_panes_10s_10ms on the stream's first
# chunk at 100 panes a side (37e's cut, 1,099 slides), 1-D mesh of 4. The
# legs a64, b64 and d64 (40f's across processes) run a, b and d in the
# float64 mode: raw float64 coordinates, float64 minima through the
# gathers and a float64 carry; 39c's inputs (float64 positions and
# radii) are float64 already.
MH_POINTS = 262_144
MH_QUERIES = 1024
MH_QUERY_SEED = 8
MH_TIMEOUT_S = 600
MH_LEGS = ("a", "b", "c", "d", "a64", "b64", "d64")

#: Phase 39's rank processes: stopped if the run ends before the phase
#: collects them.
MULTIHOST_CHILDREN = []


def multihost_inputs(leg):
    """One leg's host inputs: (program name, mesh shape, positional
    arrays, keyword arguments) of the program after its mesh. A leg named
    ``<x>64`` is leg x on the float64 mode's lanes (``center_coords`` of
    float64 inside ``precision.x64(True)``: the raw coordinates)."""
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import base

    grid = UniformGrid(**BEIJING)
    if leg.endswith("64"):
        with precision.x64(True):
            return _multihost_inputs(leg[:-2], grid, functools.partial(
                base.center_coords, dtype=np.float64), np.float64)
    return _multihost_inputs(leg, grid, base.center_coords, np.float32)


def _multihost_inputs(leg, grid, center_coords, dtype):
    if leg == "a":
        xy = join_stream(MH_POINTS, 7)
        rq = np.random.default_rng(MH_QUERY_SEED)
        qxy = np.stack([rq.uniform(BEIJING["min_x"], BEIJING["max_x"],
                                   MH_QUERIES),
                        rq.uniform(BEIJING["min_y"], BEIJING["max_y"],
                                   MH_QUERIES)], axis=1)
        table = grid.neighbor_flags(
            RANGE_R, grid.assign_cells_np(qxy).tolist())
        flags = table[grid.assign_cells_np(xy)]
        return ("sharded_range_query_2d", (2, 2),
                (center_coords(grid, xy), np.ones(MH_POINTS, bool), flags,
                 center_coords(grid, qxy), RANGE_R), {})
    if leg == "b":
        # The first window of phase 18's run_multi stream.
        xy, oid, qxy = multi_arrays(MULTI_WINDOWS * MULTI_WIN)
        xy, oid = xy[:MULTI_WIN], oid[:MULTI_WIN].astype(np.int32)
        tables = np.stack([grid.neighbor_flags(MULTI_R, [grid.flat_cell(*q)])
                           for q in qxy])
        return ("sharded_knn_multi", (2, 2),
                (center_coords(grid, xy), np.ones(MULTI_WIN, bool),
                 grid.assign_cells_np(xy), tables, oid,
                 center_coords(grid, qxy), MULTI_R),
                {"k": MULTI_K, "num_segments": NUM_SEGMENTS})
    if leg == "c":
        rgrid, _, xy, cell, oid, qxy, qcell, radius = halo_registry_inputs()
        tables = np.stack([rgrid.neighbor_flags(float(r), [int(c)])
                           for r, c in zip(radius, qcell)])
        return ("sharded_registry_bucket", (4,),
                (xy, np.ones(len(xy), bool), cell, tables, oid, qxy, radius,
                 np.ones(len(qxy), bool)),
                {"k": HR_K, "num_segments": QS_IDS})
    from spatialflink_tpu_torch.operators.trajectory import tjoin_pane_fields
    from spatialflink_tpu_torch.ops.compaction import (
        max_window_cell_count,
        pick_capacity,
    )

    cut = [{k: v[:MESH_TP_PANES * TP_PANE_PTS] for k, v in side[0].items()}
           for side in tpanes_stream()]
    n_slides = int(max(c["ts"].max() for c in cut) // TP_SLIDE_MS) + TP_PPW
    fields, occ = [], 0
    for c in cut:
        f, _, cells = tjoin_pane_fields(grid, c["ts"], c["x"], c["y"],
                                        c["oid"], TP_SLIDE_MS, 0, n_slides,
                                        dtype=dtype)
        fields.append(f)
        occ = max(occ, max_window_cell_count(*cells, TP_PPW))
    return ("sharded_tjoin_pane_scan", (4,),
            (n_slides, fields[0], fields[1], TP_R),
            {"grid_n": grid.n, "cap_w": TP_CAP_W,
             "layers": grid.candidate_layers(TP_R), "ppw": TP_PPW,
             "num_ids": TP_IDS, "pair_sel": TP_PAIR_SEL,
             "cap_c": pick_capacity(occ, TP_CAP_W)})


def multihost_program(mesh, name, args, kw, dev):
    """The leg's program on ``mesh`` with its arrays on ``dev``: a tuple
    of output tensors (the tJoin scan's window minima, then its carry)."""
    import torch

    from spatialflink_tpu_torch.parallel import sharded

    def on(a):
        if isinstance(a, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        return a

    if name == "sharded_tjoin_pane_scan":
        from spatialflink_tpu_torch.ops.tjoin_panes import tjoin_pane_init
        from spatialflink_tpu_torch.parallel.mesh import home_device

        n_slides, lf, rf, radius = args
        carry = tjoin_pane_init(kw["grid_n"] ** 2, kw["cap_w"], kw["ppw"],
                                kw["num_ids"], lf[0].dtype,
                                device=home_device(mesh))
        carry, wmins = sharded.sharded_tjoin_pane_scan(
            mesh, carry, range(n_slides), tuple(map(on, lf)),
            tuple(map(on, rf)), radius, **kw)
        return (wmins, *carry)
    return tuple(getattr(sharded, name)(mesh, *map(on, args), **kw))


def multihost_child(workdir, device="cuda") -> int:
    """One rank of phase 39: join the group from torch's launcher
    variables, run every leg's program on the mesh spanning both ranks
    (two shards of ``device`` each) and on a mesh of four ``device``
    shards in this process, hold them bit-equal, and write each leg's
    digest, ms and gloo traffic to ``workdir/rank<r>.json``. Rank 0
    also holds legs a and b bit-equal to a mesh of four CPU shards."""
    import contextlib
    import hashlib

    import torch
    import torch.distributed as dist

    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.parallel import make_mesh
    from spatialflink_tpu_torch.parallel import mesh as tmesh
    from spatialflink_tpu_torch.parallel.multihost import (
        global_mesh,
        initialize_distributed,
    )

    if not initialize_distributed():
        raise AssertionError("39: no group joined")
    rank = dist.get_rank()
    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(
        device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, 1e3 * (time.perf_counter() - t0)

    report, cpu_twins = {"rank": rank, "legs": {}}, {}
    torch.zeros(1, device=dev).sum().item()  # the context, before timing
    for leg in MH_LEGS:
        t_leg = time.perf_counter()
        base, f64 = leg[0], leg.endswith("64")
        name, shape, args, kw = multihost_inputs(leg)
        names = ("data", "query")[:len(shape)]
        span = global_mesh([dev] * 2, shape, names)
        one = make_mesh(shape, names, devices=[dev] * 4)
        if base in ("a", "b") and {d.type for d in one.devices.flat} != \
                {dev.type}:
            raise AssertionError(f"39{leg}: {one} is not on {dev}")
        mode = precision.x64(True) if f64 else contextlib.nullcontext()
        # A one-process run first warms the leg's operations; 39d's scans
        # take seconds, so its spanning run goes first, cold.
        runs = []
        with mode:
            if base != "d":
                runs.append(timed(lambda: multihost_program(
                    one, name, args, kw, dev))[0])
            tmesh.reset_gloo_traffic()
            got, span_ms = timed(lambda: multihost_program(
                span, name, args, kw, dev))
            gloo = tmesh.gloo_traffic()
            want, one_ms = timed(lambda: multihost_program(
                one, name, args, kw, dev))
        floats = [g.dtype for g in got if g.is_floating_point()]
        if floats != [torch.float64 if f64 or base == "c"
                      else torch.float32] * len(floats) or not floats:
            raise AssertionError(f"39{leg}: {floats} outputs")
        for ref in runs + [want]:
            if not all(same_bits(g, w) for g, w in zip(got, ref)):
                raise AssertionError(f"39{leg}: {name} on the spanning mesh "
                                     f"differs from the one-process mesh "
                                     f"(rank {rank})")
        h = hashlib.sha256()
        for g in got:
            h.update(g.cpu().numpy().tobytes())
        # What the leg found: points kept (a), the clamped in-radius
        # counts (b) and the unclamped ones (c) summed over the queries,
        # finite window minima (d).
        if base == "d":
            found = int(torch.isfinite(got[0]).sum())
        else:
            found = int((got[0] if base == "a" else got[-1]).sum())
        report["legs"][leg] = {
            "program": name, "shape": list(shape), "span_ms": span_ms,
            "one_ms": one_ms, "gloo_collectives": gloo["collectives"],
            "gloo_bytes": gloo["bytes"], "digest": h.hexdigest(),
            "found": found, "dtype": str(floats[0]).split(".")[-1],
            "counters": ([int(x) for x in got[-3:]] if base == "d" else []),
            "wall_s": time.perf_counter() - t_leg}
        if rank == 0 and base in ("a", "b"):
            cpu_twins[leg] = (name, shape, args, kw, got)
    for leg, (name, shape, args, kw, got) in cpu_twins.items():
        t0 = time.perf_counter()
        names = ("data", "query")[:len(shape)]
        cpu = make_mesh(shape, names, devices=["cpu"] * 4)
        with precision.x64(leg.endswith("64")):
            ref = multihost_program(cpu, name, args, kw, torch.device("cpu"))
        if not all(same_bits(g.cpu(), r) for g, r in zip(got, ref)):
            raise AssertionError(f"39{leg}: the card differs from the CPU "
                                 f"run")
        report["legs"][leg]["cpu_s"] = time.perf_counter() - t0
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    dist.destroy_process_group()
    return 0


def check_multihost(card, gpu="cuda"):
    """Phase 39: start the two ranks, wait for both (killing them after
    ``MH_TIMEOUT_S``), hold their digests equal and print each leg."""
    import shutil
    import socket
    import tempfile
    import threading

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase39_")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [start_background(
        [sys.executable, os.path.abspath(__file__), "--multihost-child", tmp,
         "--child-device", gpu],
        {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
         "WORLD_SIZE": "2", "RANK": str(rank)}, owner=MULTIHOST_CHILDREN)
        for rank in range(2)]
    # A thread a rank drains its pipes, so that neither rank can block on
    # a full pipe inside a collective while the other waits on it.
    outs = [None, None]

    def drain(rank):
        outs[rank] = procs[rank].communicate()

    drains = [threading.Thread(target=drain, args=(rank,), daemon=True)
              for rank in range(2)]
    for t in drains:
        t.start()
    try:
        deadline = time.perf_counter() + MH_TIMEOUT_S
        while any(t.is_alive() for t in drains):
            if any(p.poll() not in (None, 0) for p in procs):
                break  # a rank failed: the other may wait in a collective
            if time.perf_counter() > deadline:
                raise AssertionError(f"39: a rank ran past {MH_TIMEOUT_S} s "
                                     f"and was killed")
            time.sleep(0.05)
        stop_children(MULTIHOST_CHILDREN)
        for t in drains:
            t.join()
        failed = [f"rank {rank} exited {proc.returncode}\n"
                  f"{outs[rank][1][-3000:]}"
                  for rank, proc in enumerate(procs) if proc.returncode != 0]
        if failed:
            raise AssertionError("39: " + "\n".join(failed))
        reports = []
        for rank in range(2):
            with open(os.path.join(tmp, f"rank{rank}.json")) as f:
                reports.append(json.load(f))
    finally:
        stop_children(MULTIHOST_CHILDREN)
        shutil.rmtree(tmp, ignore_errors=True)
    r0, r1 = (r["legs"] for r in reports)
    for leg in MH_LEGS:
        a, b = r0[leg], r1[leg]
        if a["digest"] != b["digest"] or a["found"] != b["found"]:
            raise AssertionError(f"39{leg}: the ranks' outputs differ")
        if a["gloo_collectives"] != b["gloo_collectives"] or \
                not a["gloo_collectives"]:
            raise AssertionError(f"39{leg}: gloo collectives "
                                 f"{a['gloo_collectives']} / "
                                 f"{b['gloo_collectives']}")
        if not a["found"]:
            raise AssertionError(f"39{leg}: an empty result (vacuous)")
        what = {"a": "points kept", "b": "winners over the queries",
                "c": "in-radius objects over the queries",
                "d": "finite window minima"}[leg[0]]
        twin = (f"; equal to the one-process CPU run ({a['cpu_s']:.3f} s)"
                if "cpu_s" in a else "")
        counters = (f"; overflow counters {a['counters']}"
                    if a["counters"] else "")
        print(f"multihost 39{leg} {a['program']} on {tuple(a['shape'])} "
              f"({a['dtype']}): {a['found']} {what}{counters}; spanning "
              f"{a['span_ms']:.3f} / {b['span_ms']:.3f} ms (ranks 0 / 1"
              f"{', run first' if leg[0] == 'd' else ''}), one process "
              f"{a['one_ms']:.3f} / {b['one_ms']:.3f} ms; "
              f"{a['gloo_collectives']} gloo collectives, "
              f"{a['gloo_bytes']} / {b['gloo_bytes']} B delivered; "
              f"bit-equal to the one-process mesh of 4 shards on both ranks, "
              f"digests equal{twin}; leg {a['wall_s']:.3f} s of rank 0 "
              f"[{card}]")
    print(f"phase 39 wall: {time.perf_counter() - t_phase:.3f} s (two gloo "
          f"ranks x 2 shards of {gpu}) [{card}]")


# ---------------------------------------------------------------------------
# Phase 40: the float64 mode (A14.1, A14.2a, A14.2b, A14.2c). With
# ``precision.x64(True)`` and the entry points' default dtype (float64),
# the operators ship raw
# float64 coordinates and run B3's and B4's float64 instantiations: 40a
# holds B3's against its plain version at the join's full shape (config
# 4: two 131,072-point sides, r = 0.002, cap 48, 262,144 pairs), with
# points exactly on the radius and two layers; 40b B4's at config 3's
# gathered shape (262,144 points, 1,000 polygons, 8 candidates) and at
# boundaries with no valid edge; 40c runs every float64 family on the
# card at full width (config 3's polygon set, 32 linestrings, config 1's
# point query, config 2's kNN, config 4's join; phase 14's polygon range
# and phase 17's kNN on it, phases 20's and 21's joins, config 2's pane
# carry, phase 18's polygon query_panes, the 64-query run_multi, phase
# 22's pane join) against the same runs on the CPU through the plain
# versions, counting B3's and B4's float64 launches leg by leg and B4's
# by mode; 40e (below) the trajectory and serving slice; 40f the mesh
# runs; 40d times both kernels, B4 also at the dense, G = 1 and join-tile
# shapes, B3 at tJoin's, both at a shard's shape of 40f's legs. The legs run in depth cuts (one window each, two for
# the kNN, the pane paths' first panes); their CPU runs are background
# twins (``X64_TWINS``).

X64_WINDOWS = 1          # windows of the range and join legs (cuts of 10/16)
X64_KNN_WINDOWS = 2      # config 2's one-second windows of the kNN leg
X64_LAT = 2.0 ** -36     # the lattice of 40a's on-radius points
#: H100 SXM, FP64 outside the tensor cores (NVIDIA's data sheet).
F64_OPS_PER_S = 34e12


def join_stream64(n, seed):
    """bench_suite.py:47-54's positions from ``seed`` in float64, as the
    float64 mode ships them (raw, uncentred)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(115.5, 117.6, n),
                     rng.uniform(39.6, 41.1, n)], axis=1)


def x64_side(grid, xy64, valid=None):
    """Host lanes (raw float64 xy, valid, cell) of one float64 join side."""
    xy64 = np.asarray(xy64, np.float64)
    n = len(xy64)
    return (xy64, np.ones(n, bool) if valid is None else valid,
            grid.assign_cells_np(xy64))


def check_x64_b3(dev, card):
    """40a: B3's float64 instantiation against its plain version at the
    join's full shape. Returns (max_abs_err, the headline planes, the
    sides)."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid

    grid = UniformGrid(**BEIJING)
    a, b = join_stream64(JOIN_WIN, 1), join_stream64(JOIN_WIN, 2)
    left, right = x64_side(grid, a), x64_side(grid, b)
    head, planes, over, err = join_case(dev, grid, left, right, JOIN_R,
                                        JOIN_MAX_PAIRS, card, "f64_headline")
    count = int(head[3])
    if planes[0].dtype != torch.float64 or head[2].dtype != torch.float64 \
            or over != 0 or not (0.8 * expected_pairs(JOIN_WIN, JOIN_R)
                                 < count <= JOIN_MAX_PAIRS):
        raise AssertionError(f"B3 f64 headline: count {count}, overflow "
                             f"{over}, {head[2].dtype}")
    # Points exactly on the radius: left points on the 2^-36 lattice and
    # right points at +(r, 0), r the radius on the lattice, so that the
    # offset is exact and d2 == r2 in float64.
    k = 20_000
    r = round(JOIN_R / X64_LAT) * X64_LAT
    lq = np.round(a / X64_LAT) * X64_LAT
    rq = b.copy()
    rq[:k] = lq[:k] + np.array([r, 0.0])
    ls, rs = x64_side(grid, lq), x64_side(grid, rq)
    got, _, _, e = join_case(dev, grid, ls, rs, r, JOIN_MAX_PAIRS, card,
                             "f64_on_radius")
    err = max(err, e)
    n = int(got[3])
    li, ri, dd = (t[:n].cpu().numpy() for t in got[:3])
    on = (li == ri) & (li < k)
    in_grid = (ls[2][:k] < grid.num_cells) & (rs[2][:k] < grid.num_cells)
    if on.sum() != in_grid.sum() or not np.all(dd[on] == r):
        raise AssertionError("B3 f64 on_radius lost points exactly on the "
                             "radius")
    under = min(1024, count // 2)
    got, _, _, e = join_case(dev, grid, left, right, JOIN_R, count - under,
                             card, f"f64_over_budget_{count - under}")
    err = max(err, e)
    m = len(got[0])
    if int(got[3]) != count or not all(
            same_bits(g[:m], h[:m]) for g, h in zip(got[:3], head[:3])):
        raise AssertionError("B3 f64 over budget: not the first pairs")
    got, _, _, e = join_case(dev, grid, left, right, 0.03, JOIN_MAX_PAIRS,
                             card, "f64_two_layers_over_budget")
    err = max(err, e)
    need = int(2 ** np.ceil(np.log2(int(got[3]))))
    _, _, _, e = join_case(dev, grid, left, right, 0.03, need, card,
                           "f64_two_layers")
    return max(err, e), planes, (left, right)


def check_x64_b4(dev, card):
    """40b: B4's float64 instantiation against its plain version at
    config 3's shapes, and boundaries with no valid edge at DBL_MAX.
    Returns (max_abs_err, the gathered inputs)."""
    import torch

    from spatialflink_tpu_torch.operators.base import pack_query_geometries
    from spatialflink_tpu_torch.ops.range import bbox_candidates

    verts, ev = pack_query_geometries(range_polygons())
    xy64 = join_stream64(RANGE_WIN, 7)
    xy_d, qv_d, qe_d = (torch.from_numpy(x).to(dev) for x in (xy64, verts,
                                                              ev))
    lanes = torch.ones(RANGE_WIN, dtype=torch.bool, device=dev)
    sel, _ = bbox_candidates(xy_d, lanes, qv_d, qe_d, RANGE_R, 8, 8192)
    _, err = b4_case(dev, xy_d, qv_d, qe_d, sel, card,
                     "f64_config3_gathered")
    _, e = b4_case(dev, xy_d[:65_536], qv_d, qe_d, None, card,
                   "f64_config3_dense_65536")
    err = max(err, e)
    _, e = b4_case(dev, xy_d, qv_d[:33].contiguous(), qe_d[:33].contiguous(),
                   None, card, "f64_dense_g33")
    err = max(err, e)
    _, e = b4_case(dev, xy_d, qv_d, qe_d, sel[:, :3].contiguous(), card,
                   "f64_gathered_c3")
    err = max(err, e)
    dead = qe_d.clone()
    dead[::97] = False  # boundaries 0, 97, ...: no valid edge
    got, e = b4_case(dev, xy_d[:20_000], qv_d, dead, None, card,
                     "f64_no_valid_edge_dense")
    err = max(err, e)
    big = torch.finfo(torch.float64).max
    if not torch.all(got[:, ::97] == big) or torch.any(got[:, 1::97] == big):
        raise AssertionError("B4 f64: a boundary with no valid edge is not "
                             "DBL_MAX")
    dsel = sel.clone()
    dsel[:, 0] = 97
    got, e = b4_case(dev, xy_d, qv_d, dead, dsel, card,
                     "f64_no_valid_edge_gathered")
    err = max(err, e)
    if not torch.all(got[:, 0] == big):
        raise AssertionError("B4 f64 gathered: no valid edge is not DBL_MAX")
    return err, (xy_d, qv_d, qe_d, sel)


#: The x64 legs by the CPU twin that runs them: in the full run each is a
#: background twin (``TWINS``), the polygon ⋈ polygon one, the longest,
#: queued first; without the pool they run here.
X64_TWINS = {"x64_gg": ("gg_join",),
             "x64": ("range_polygons", "join"),
             "x64_geometry": ("geom_range", "pg_join", "pp_query_panes"),
             "x64_light": ("range_linestrings", "range_points", "knn",
                           "geom_knn", "soa_panes", "knn_query_panes",
                           "run_multi")}
#: The pane-carry legs' depth cuts: config 2's first five panes (one full
#: 5-pane window), and phase 18's and phase 22's three panes.
X64_PANES = 5
#: The polygon ⋈ polygon leg's candidate width to start from: the width
#: phase 21's first window grows to (its retry doubles 32 to 64), as a
#: later window of that stream starts from it. The leg's window then
#: takes one distance pass on the card and on the CPU, not two.
X64_GG_CAND = 64
#: Calls of each plain-version timing at 40d's B4 shapes (the dense one
#: takes ~55 ms a call on the card).
X64_PLAIN_REPEATS = 5


def x64_inputs(legs=None):
    """{leg: (operator class, stream, query or right side, radius,
    configuration, operator keywords)} of 40c's ``legs`` (all by
    default), built from the seeds. The point-stream legs: config 3's
    polygons, 32 of them opened as linestrings and config 1's point query
    over config 3's stream (one window each), config 2's kNN
    (``X64_KNN_WINDOWS`` windows), config 4's join (one window; the query
    is the right side). The geometry and pane-carry legs, each at full
    width in a depth cut: phase 14's polygon stream against its 32
    polygons (one window) and phase 17's kNN on it; phase 20's
    join_point_1000polygons and phase 21's polygon ⋈ polygon (one window
    each); ``run_soa_panes`` over config 2's first five panes;
    ``query_panes`` with a polygon query over phase 18's three panes;
    ``run_multi`` at 64 queries over one window of 262,144 points;
    ``PointPointJoinQuery.query_panes`` over phase 22's three panes a
    side."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.models.objects import LineString, Point

    q = Point(x=QUERY[0], y=QUERY[1])
    one = dict(window_size=1.0, slide_step=1.0)
    two = dict(window_size=2.0, slide_step=1.0)
    join = {"cap": JOIN_CAP}

    def lines():
        return [LineString(obj_id=f"line{i}", coords=p.rings[0][:4])
                for i, p in enumerate(range_polygons()[:32])]

    @functools.lru_cache(maxsize=None)
    def geo():
        return geometry_chunks(GEOM_WINDOWS, GEOM_WIN)[:X64_WINDOWS]

    def pg_left():
        xy, ts = pg_points()
        return point_chunks(xy, ts, PG_WIN)[:X64_WINDOWS]

    builders = {
        "range_polygons": lambda: (
            ops.PointPolygonRangeQuery, range_chunks(X64_WINDOWS, RANGE_WIN,
                                                     7),
            range_polygons(), RANGE_R, one, {}),
        "range_linestrings": lambda: (
            ops.PointLineStringRangeQuery,
            range_chunks(X64_WINDOWS, RANGE_WIN, 7), lines(), RANGE_R, one,
            {}),
        "range_points": lambda: (
            ops.PointPointRangeQuery, range_chunks(X64_WINDOWS, PP_WIN, 42),
            [q], PP_R, one, {}),
        "knn": lambda: (ops.PointPointKNNQuery,
                        pane_chunks()[:X64_KNN_WINDOWS], q, PANE_R, one, {}),
        "join": lambda: (ops.PointPointJoinQuery,
                         soa_join_chunks(1)[:X64_WINDOWS],
                         soa_join_chunks(2)[:X64_WINDOWS], JOIN_R, one,
                         join),
        "geom_range": lambda: (ops.PolygonPolygonRangeQuery, geo(),
                               geometry_queries("polygon"), GEOM_R, one, {}),
        "geom_knn": lambda: (ops.PolygonPolygonKNNQuery, geo(),
                             knn_query("polygon"), KNN_GEOM_R, one, {}),
        "pg_join": lambda: (ops.PointPolygonJoinQuery, pg_left(),
                            polygon_chunks(pg_polygons(), X64_WINDOWS),
                            PG_R, one, {}),
        "gg_join": lambda: (ops.PolygonPolygonJoinQuery, geo(),
                            polygon_chunks(range_polygons(), X64_WINDOWS),
                            PG_R, one, {"_cand": X64_GG_CAND}),
        "soa_panes": lambda: (ops.PointPointKNNQuery,
                              pane_chunks()[:X64_PANES], q, PANE_R,
                              dict(window_size=PANE_WINDOW_S,
                                   slide_step=1.0), {}),
        "knn_query_panes": lambda: (
            ops.PointPolygonKNNQuery, knn_points(QP_PANES, QP_PANE_PTS, 7),
            knn_query("polygon"), KNN_RUN_R, two, {}),
        "run_multi": lambda: (ops.PointPointKNNQuery,
                              *multi_stream(1, MULTI_WIN), MULTI_R, one, {}),
        "pp_query_panes": lambda: (ops.PointPointJoinQuery, *qpj_streams(),
                                   JOIN_R, two, join),
    }
    return {leg: builders[leg]() for leg in (builders if legs is None
                                              else legs)}


def x64_bits(d):
    """Distances as float64 bits; array distances must be float64, and
    Python floats (the object paths') must hold a value no float32 holds
    where any is non-zero."""
    if isinstance(d, np.ndarray):
        if d.dtype != np.float64:
            raise AssertionError(f"x64 leg: {d.dtype} distances")
    elif any(d) and all(float(np.float32(x)) == x for x in d):
        raise AssertionError("x64 leg: float32 distances on an object path")
    return np.asarray(d, np.float64).view(np.int64).tolist()


def x64_run(leg, op, a, b, r):
    """One leg's run in the windows' comparable form, distances as
    ``x64_bits``."""
    if leg.startswith("range_"):
        return [(w[0], w[1], w[2]["ts"].tolist(), x64_bits(w[3]))
                for w in op.run_soa(a, b, r)]
    if leg in ("knn", "soa_panes", "geom_knn"):
        run = op.run_soa_panes if leg == "soa_panes" else op.run_soa
        k, nseg = ((KNN_GEOM_K, GEOM_OBJECTS) if leg == "geom_knn"
                   else (PANE_K, NUM_SEGMENTS))
        return [(w[0], w[1], w[2].tolist(), x64_bits(w[3]), w[4])
                for w in run(a, b, r, k, nseg)]
    if leg == "join":
        return [(w[0], w[1], w[2].tolist(), w[3].tolist(), x64_bits(w[4]),
                 w[5], w[6])
                for w in op.run_soa(a, b, r, max_pairs=JOIN_MAX_PAIRS)]
    if leg in ("geom_range", "pg_join", "gg_join"):
        return [(w[0], w[1], w[2].tolist(), w[3].tolist(), x64_bits(w[4]),
                 w[5]) for w in op.run_soa(a, b, r)]
    if leg == "knn_query_panes":
        return [(w.start, w.end, w.window_count,
                 [n[0] for n in w.neighbors],
                 x64_bits([n[1] for n in w.neighbors]),
                 [(n[2].obj_id, n[2].timestamp) for n in w.neighbors])
                for w in op.query_panes(iter(a), b, r, KNN_RUN_K)]
    if leg == "run_multi":
        return [(m.start, m.end, m.window_count,
                 [([n[0] for n in w.neighbors],
                   x64_bits([n[1] for n in w.neighbors]))
                  for w in m.results])
                for m in op.run_multi(iter(a), b, r, MULTI_K)]
    return [(w.start, w.end, w.overflow, w.window_count,
             sorted((x.obj_id, x.timestamp, y.obj_id, y.timestamp, d)
                    for x, y, d in w.pairs),
             x64_bits([d for *_, d in w.pairs]))
            for w in op.query_panes(iter(a), iter(b), r)]


def x64_matches(leg, windows) -> int:
    """A leg's matches over its windows (pairs, kept objects or
    neighbours): the length of the field of ``x64_run``'s window form
    that lists them."""
    if leg == "join":
        return sum(w[5] for w in windows)
    if leg == "run_multi":
        return sum(len(ids) for m in windows for ids, _ in m[3])
    field = {"geom_range": 2, "pg_join": 2, "gg_join": 2,
             "pp_query_panes": 4}.get(leg, 3)
    return sum(len(w[field]) for w in windows)


def x64_legs(device, inputs, legs=None, on_leg=None):
    """40c: the slice's paths with ``precision.x64(True)`` at the entry
    points' default dtype, on ``device``: the ``legs`` of ``inputs``
    (``x64_inputs``; all by default). ``on_leg(leg)``, when given, is
    called before each leg. Returns ({leg: windows} in comparable form,
    distances as float64 bits; the seconds of all; {leg: seconds})."""
    import torch

    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import QueryConfiguration

    out, secs = {}, {}
    for leg in (inputs if legs is None else legs):
        cls, a, b, r, conf, kw = inputs[leg]
        state = {k: v for k, v in kw.items() if k.startswith("_")}
        op = cls(QueryConfiguration(**conf), UniformGrid(**BEIJING),
                 device=device, **{k: v for k, v in kw.items()
                                   if k not in state})
        for k, v in state.items():  # a retry state carried in
            setattr(op, k, v)
        if on_leg is not None:
            on_leg(leg)
        t0 = time.perf_counter()
        with precision.x64(True):
            out[leg] = x64_run(leg, op, a, b, r)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs[leg] = time.perf_counter() - t0
    return out, sum(secs.values()), secs


class X64Launches:
    """The float64 launches of 40c's card run, leg by leg (the deltas of
    ``launches_f64``), and B4's by mode (dense over many boundaries,
    G = 1, gathered), read by wrapping the module function B4's wrapper
    dispatches to (``polyline_min_dist_cuda`` on the card, the plain
    version on a CPU rehearsal). On the card the plain versions raise
    while it is installed: no float64 leg may reach them. Keeps each
    leg's first float64 arguments of each B4 mode, and of B3 (mode
    "b3"), for 40d."""

    def __init__(self, gpu):
        from spatialflink_tpu_torch.ops import join_kernel as jk
        from spatialflink_tpu_torch.ops import polyline_kernel as pk

        self.gpu, self.pk, self.jk = gpu, pk, jk
        self.leg, self.at = None, (0, 0)
        self.by_leg = {}
        self.modes = {"dense": 0, "G=1": 0, "gathered": 0}
        self.first = {}
        self.saved = {}

    def _counts(self):
        return (self.jk.join_extract.launches_f64,
                self.pk.polyline_min_dist.launches_f64)

    def _close(self):
        if self.leg is not None:
            now = self._counts()
            self.by_leg[self.leg] = {
                "join_extract": now[0] - self.at[0],
                "polyline_min_dist": now[1] - self.at[1]}
        self.leg = None

    def on_leg(self, leg):
        self._close()
        self.leg, self.at = leg, self._counts()

    def __enter__(self):
        pk, jk = self.pk, self.jk
        name = ("polyline_min_dist_cuda" if self.gpu == "cuda"
                else "polyline_min_dist_plain")
        inner = getattr(pk, name)
        self.saved = {(pk, name): inner}

        def b4(xy, verts, ev, sel=None):
            if xy.dtype.itemsize == 8 and self.leg is not None:
                mode = ("gathered" if sel is not None
                        else "G=1" if verts.shape[0] == 1 else "dense")
                self.modes[mode] += 1
                self.first.setdefault((self.leg, mode),
                                      (xy, verts, ev, sel))
            return inner(xy, verts, ev, sel)

        setattr(pk, name, b4)
        b3_name = ("join_extract_cuda" if self.gpu == "cuda"
                   else "join_extract_plain")
        b3_inner = getattr(jk, b3_name)
        self.saved[(jk, b3_name)] = b3_inner

        def b3(*args):
            if args[0].dtype.itemsize == 8 and self.leg is not None:
                self.first.setdefault((self.leg, "b3"), args)
            return b3_inner(*args)

        setattr(jk, b3_name, b3)
        if self.gpu == "cuda":
            def plain(*_a, **_k):
                raise AssertionError("40c: a float64 leg on the card reached "
                                     "a plain version")
            self.saved[(pk, "polyline_min_dist_plain")] = \
                pk.polyline_min_dist_plain
            self.saved.setdefault((jk, "join_extract_plain"),
                                  jk.join_extract_plain)
            pk.polyline_min_dist_plain = plain
            jk.join_extract_plain = plain
        return self

    def __exit__(self, *exc):
        self._close()
        for (mod, name), fn in self.saved.items():
            setattr(mod, name, fn)
        return False


#: 40d's float64 B4 shapes: (label, the leg and mode of the call timed).
X64_B4_SHAPES = (("dense", "geom_range", "dense"),
                 ("G=1", "knn_query_panes", "G=1"),
                 ("join tiles", "pg_join", "gathered"))


def b4_work(xy, verts, ev, sel):
    """(bytes, float64 operations) of one B4 call: every input read once
    and the (N, C) output written once; 20 operations a (point, valid
    edge) pair this call's data evaluates."""
    n = xy.shape[0]
    c = verts.shape[0] if sel is None else sel.shape[1]
    nbytes = (xy.numel() + verts.numel()) * xy.element_size() \
        + ev.numel() + (0 if sel is None else 4 * sel.numel()) \
        + n * c * xy.element_size()
    n_valid = ev.sum(dim=1)
    edges = int(n_valid.sum()) * n if sel is None \
        else int(n_valid[sel.long()].sum())
    return nbytes, 20 * edges


# 40e: the trajectory and serving slice (A14.2b) in float64, one leg a
# family, each at full width in a one-window cut, on the card and on the
# CPU through the plain versions: tJoin ``run_soa`` (tjoin_10s_1s_sliding's
# window at 0, 204,800 points a side, cap 64, through B3's float64
# instantiation), ``run`` and ``run_single`` (phase 23's ``Point``s, one
# window), ``run_soa_panes`` on the device engine (phase 35a's cut of
# tjoin_panes_10s_10ms), the tStats device pane engine (bench_tstats_pane,
# uncut) and ``run_soa`` (its window at 0), tRange, tKnn and tAggregate
# ``run_soa`` (phase 25's streams, one window each) and
# ``QServeOperator.run`` (qserve_1024q_mixed's first window). Their CPU
# runs are background twins (``X64E_TWINS``).

#: The 40e legs by the CPU twin that runs them.
X64E_TWINS = {"x64_traj": ("tjoin_soa", "tjoin_run", "tjoin_run_single",
                           "tjoin_panes"),
              "x64_traj_light": ("tstats_panes", "tstats_soa", "trange_soa",
                                 "tknn_soa", "tagg_soa", "qserve")}
#: The 40e legs whose B3 float64 launches must move.
X64E_B3_LEGS = ("tjoin_soa", "tjoin_run", "tjoin_run_single")
#: tKnn's and tAggregate's window: config 2's first PANE_WINDOW_S panes.
X64E_PANE_WINDOW = int(PANE_WINDOW_S)


@functools.lru_cache(maxsize=None)
def _tjoin_sides():
    return tjoin_chunks(31), tjoin_chunks(32)


def x64e_inputs(legs=None):
    """{leg: its inputs} of 40e's ``legs`` (all by default), built from
    phases 23-26's, 34's and 35a's builders and cut to one window."""
    from spatialflink_tpu_torch.models.objects import Point

    def tjoin_soa():
        # tjoin_10s_1s_sliding's window at 0: its first ten slides.
        return tuple(c[:TJ_WINDOW_S] for c in _tjoin_sides())

    def tjoin_run():
        # Phase 23's Point streams, their first window of T_CUT.
        return tuple(traj_points(c, T_CUT, T_CUT, side)
                     for c, side in zip(_tjoin_sides(), ("l", "r")))

    def tstats_soa():
        ts, xy, oid = tstats_stream()
        m = ts < TS_WINDOW_MS  # the 10 s / 1 s run's window at 0
        return ([{"ts": ts[m], "x": xy[m, 0], "y": xy[m, 1],
                  "oid": oid[m].astype(np.int32)}],)

    def trange_soa():
        chunks = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)[:1]
        # Phase 25's ids: its generator's first draw is the first window's.
        chunks[0]["oid"] = np.random.default_rng(77).integers(
            0, TR_IDS, RANGE_WIN).astype(np.int32)
        return chunks, range_polygons()[:TR_QUERIES]

    def qserve_window():
        # 34b's stream is built from its first QS_OP_WINDOWS windows of
        # points; the leg serves the first window of it.
        xy, oid = qserve_points()
        n = QS_OP_WINDOWS * QS_WIN
        return xy[:n], oid[:n]

    builders = {
        "tjoin_soa": tjoin_soa,
        "tjoin_run": tjoin_run,
        "tjoin_run_single": lambda: tjoin_run()[:1],
        "tjoin_panes": lambda: tuple(tpanes_cut(tpanes_stream(),
                                                JS_TJ_PANES)),
        "tstats_panes": tstats_stream,
        "tstats_soa": tstats_soa,
        "trange_soa": trange_soa,
        "tknn_soa": lambda: (pane_chunks()[:X64E_PANE_WINDOW],
                             Point(x=QUERY[0], y=QUERY[1])),
        "tagg_soa": lambda: (pane_chunks()[:X64E_PANE_WINDOW],),
        "qserve": qserve_window,
    }
    return {leg: builders[leg]() for leg in (builders if legs is None
                                              else legs)}


def x64e_run(leg, device, inp):
    """One 40e leg on ``device``, in the float64 mode at the entry
    points' default dtype; the windows in comparable form, distances as
    float64 bits (``x64_bits``), the tStats sums as arrays."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.streams.panes import traj_stats_sliding

    grid = UniformGrid(**BEIJING)

    def conf(window, slide=None):
        return ops.QueryConfiguration(window_size=window,
                                      slide_step=slide or window)

    def pair_rows(res):
        return [(w.start, w.end, w.window_count,
                 [(a.obj_id, b.obj_id, a.coords.tobytes(),
                   b.coords.tobytes()) for a, b, _ in w.pairs],
                 x64_bits([d for *_, d in w.pairs])) for w in res]

    def soa_rows(res):
        return [(w[0], w[1], w[2].tolist(), w[3].tolist(), x64_bits(w[4]),
                 w[5], w[6]) for w in res]

    if leg == "tjoin_soa":
        op = ops.PointPointTJoinQuery(conf(TJ_WINDOW_S), grid, cap=TJ_CAP,
                                      device=device)
        return soa_rows(op.run_soa(*inp, TJ_R, TJ_IDS,
                                   max_pairs=TJ_MAX_PAIRS))
    if leg in ("tjoin_run", "tjoin_run_single"):
        op = ops.PointPointTJoinQuery(conf(1.0), grid, cap=TJ_CAP,
                                      device=device)
        run = op.run if leg == "tjoin_run" else op.run_single
        return pair_rows(run(*(iter(s) for s in inp), TJ_R))
    if leg == "tjoin_panes":
        op = ops.PointPointTJoinQuery(
            conf(TP_PPW * TP_SLIDE_MS / 1000, TP_SLIDE_MS / 1000), grid,
            device=device)
        return soa_rows(op.run_soa_panes(*inp, TP_R, TP_IDS, cap_w=TP_CAP_W,
                                         pair_sel=TP_PAIR_SEL,
                                         backend="device"))
    if leg == "tstats_panes":
        res = traj_stats_sliding(*inp, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS,
                                 backend="device", device=device)
        if res.spatial.dtype != np.float64:
            raise AssertionError(f"40e {leg}: {res.spatial.dtype} sums")
        return res
    if leg == "tstats_soa":
        op = ops.PointTStatsQuery(conf(TS_WINDOW_MS / 1000), grid,
                                  device=device)
        out = list(op.run_soa(*inp, TS_BUCKET))
        if any(w[2].dtype != np.float64 for w in out):
            raise AssertionError(f"40e {leg}: float32 sums")
        return [(w[0], w[1], w[2], w[3], w[4]) for w in out]
    if leg == "trange_soa":
        op = ops.PointPolygonTRangeQuery(conf(1.0), grid, device=device)
        return [(w[0], w[1], w[2].tolist(), w[3])
                for w in op.run_soa(*inp, TR_IDS)]
    if leg == "tknn_soa":
        op = ops.PointPointTKNNQuery(conf(PANE_WINDOW_S), grid,
                                     device=device)
        return [(w[0], w[1], w[2].tolist(), x64_bits(w[3]), w[4])
                for w in op.run_soa(inp[0], inp[1], PANE_R, PANE_K,
                                    NUM_SEGMENTS)]
    if leg == "tagg_soa":
        op = ops.PointTAggregateQuery(conf(PANE_WINDOW_S), grid,
                                      aggregate="SUM", device=device)
        return [(w.start, w.end, w.window_count, w.cells)
                for w in op.run_soa(*inp)]
    # qserve: the first window of 34b's stream, served in float64.
    events = [e for e in qserve_command_stream(*inp) if e.timestamp < 1000]
    op = qserve.QServeOperator(conf(1.0), grid, device=device)
    try:
        res = list(op.run(iter(events)))
    finally:
        qserve.uninstall()
    return [(r.start, r.end, r.window_count, list(r.lines()),
             x64_bits([row[4] for row in r.rows])) for r in res]


def x64e_matches(leg, windows) -> int:
    """A 40e leg's matches over its windows (pairs, hits, neighbours,
    cells, egress rows, or the tStats windows' point count)."""
    if leg == "tstats_panes":
        return int(windows.count.sum())
    if leg == "tstats_soa":
        return int(sum(w[4].sum() for w in windows))
    if leg in ("tjoin_soa", "tjoin_panes"):
        return sum(w[5] for w in windows)
    return sum(len(w[3] if leg in ("tjoin_run", "tjoin_run_single",
                                   "qserve", "tagg_soa") else w[2])
               for w in windows)


def x64e_same(leg, got, want, inp):
    """Whether a 40e leg's card windows equal its CPU run's: exactly, the
    tStats spatial sums within their float64 bounds (``index_add_`` on
    the card adds in another order)."""
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.ops.trajectory import spatial_sum_bound
    from spatialflink_tpu_torch.streams.panes import pane_spatial_bound

    if leg == "tstats_panes":
        with precision.x64(True):
            bound = pane_spatial_bound(*inp, TS_BUCKET, TS_WINDOW_MS,
                                       TS_SLIDE_MS)
        check_pane_windows(got, want, bound, f"40e {leg}")
        return True
    if leg == "tstats_soa":
        return len(got) == len(want) and all(
            g[:2] == w[:2] and np.array_equal(g[3], w[3])
            and np.array_equal(g[4], w[4])
            and np.all(np.abs(g[2] - w[2]) <= spatial_sum_bound(
                g[4], np.maximum(g[2], w[2]), np.float64))
            for g, w in zip(got, want))
    return got == want


def x64e_legs(device, inputs, legs=None, on_leg=None):
    """40e: ``x64_legs`` for the trajectory and serving legs. Returns
    ({leg: windows}, the seconds of all, {leg: seconds})."""
    import torch

    from spatialflink_tpu_torch import precision

    out, secs = {}, {}
    for leg in (inputs if legs is None else legs):
        if on_leg is not None:
            on_leg(leg)
        t0 = time.perf_counter()
        with precision.x64(True):
            out[leg] = x64e_run(leg, device, inputs[leg])
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        secs[leg] = time.perf_counter() - t0
    return out, sum(secs.values()), secs


def check_x64e(gpu, card):
    """40e on the card (``gpu``), its CPU runs in the twins, compared
    later. Returns the B3 float64 launches of its legs."""
    t0 = time.perf_counter()
    inputs = x64e_inputs()
    in_secs = time.perf_counter() - t0
    with X64Launches(gpu) as xl:
        got, _, g_secs = x64e_legs(gpu, inputs, on_leg=xl.on_leg)
    short = [leg for leg in X64E_B3_LEGS
             if xl.by_leg[leg]["join_extract"] < 1]
    if short or any(c["polyline_min_dist"] for c in xl.by_leg.values()):
        raise AssertionError(f"40e: float64 B3 launches short on {short}, "
                             f"or B4 reached: {xl.by_leg}")
    for leg, windows in got.items():
        if not x64e_matches(leg, windows):
            raise AssertionError(f"40e {leg}: no match")
    b3 = sum(xl.by_leg[leg]["join_extract"] for leg in X64E_B3_LEGS)
    print("x64 40e legs (precision.x64(True), the default dtype float64) on "
          "the card: " + ", ".join(
              f"{leg} {x64e_matches(leg, got[leg])} matches in "
              f"{g_secs[leg]:.3f} s" for leg in got)
          + f"; float64 B3 launches " + ", ".join(
              f"{leg} {xl.by_leg[leg]['join_extract']}"
              for leg in X64E_B3_LEGS)
          + f"; inputs {in_secs:.3f} s"
          + ("; no plain version reached" if gpu == "cuda" else "")
          + f" [{card}]")
    if sorted(leg for legs in X64E_TWINS.values() for leg in legs) != \
            sorted(inputs):
        raise AssertionError("40e: a leg without its CPU twin")
    for name, legs in X64E_TWINS.items():
        def held_twin(name=name, legs=legs):
            want, _, w_secs = twin(name, *(inputs[leg] for leg in legs))
            for leg in legs:
                if not x64e_same(leg, got[leg], want[leg], inputs[leg]):
                    raise AssertionError(f"40e x64 {leg}: the card's windows "
                                         f"differ from the CPU's")
            print("exact x64 40e legs ("
                  + ", ".join(f"{leg} {x64e_matches(leg, got[leg])} matches,"
                              f" {g_secs[leg]:.3f} s on the card, "
                              f"{w_secs[leg]:.3f} s on the CPU"
                              for leg in legs)
                  + f"): equal to the CPU run through the plain versions "
                  f"(the CPU twin {name}), float64 distances bit for bit, "
                  f"tStats sums within their float64 bounds [{card}]")
        later(held_twin)
    return b3, got, g_secs


def x64e_tjoin_shape(dev, card):
    """40d at tJoin's shape: B3's float64 instantiation on the planes of
    tjoin_10s_1s_sliding's window at 0 (204,800 points a side, grid 100,
    one layer, cap 64, r = 0.001), bit-exact against its plain version,
    then timed beside it and its bound. Returns its row."""
    import torch

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
    )

    grid = UniformGrid(**BEIJING)
    sides = [x64_side(grid, np.stack([np.concatenate([c["x"] for c in side]),
                                      np.concatenate([c["y"] for c in side])],
                                     axis=1))
             for side in x64e_inputs(["tjoin_soa"])["tjoin_soa"]]
    head, planes, over, err = join_case(dev, grid, *sides, TJ_R,
                                        TJ_MAX_PAIRS, card, "f64_tjoin_cap64",
                                        cap=TJ_CAP)
    if over or planes[0].dtype != torch.float64:
        raise AssertionError(f"B3 f64 at tJoin's shape: overflow {over}, "
                             f"{planes[0].dtype} planes")
    args = (*planes, grid.n, 1, TJ_R, TJ_MAX_PAIRS)
    ms, call = time_ms(lambda: join_extract_cuda(*args))
    plain, _ = time_ms(lambda: join_extract_plain(*args), X64_PLAIN_REPEATS)
    tests = join_candidate_pairs(grid, *sides, cap=TJ_CAP)
    nbytes = sum(t.numel() * t.element_size() for t in planes) \
        + 16 * TJ_MAX_PAIRS + 4
    bnd, by_ = bound_ms(nbytes, 6 * tests, F64_OPS_PER_S)
    print(f"time join_extract_f64 at tJoin's shape (tjoin_10s_1s_sliding's "
          f"window at 0: {len(sides[0][0])} points a side, grid "
          f"{grid.n}, cap {TJ_CAP}, r={TJ_R}, {int(head[3])} pairs): kernel "
          f"{ms:.6f} ms device ({call:.6f} ms per call with its launches), "
          f"plain PyTorch {plain:.6f} ms, bound {bnd:.6f} ms ({by_}: "
          f"{nbytes} B, {tests} candidate pair tests x 6 float64 "
          f"operations at {F64_OPS_PER_S:g}/s), library none, medians of "
          f"{REPEATS} calls (the plain version's of {X64_PLAIN_REPEATS}) "
          f"[{card}]")
    return {"ms": ms, "call_ms": call, "plain_ms": plain, "bound_ms": bnd,
            "bound_by": by_, "points": int(len(sides[0][0])), "cap": TJ_CAP,
            "pairs": int(head[3]), "max_abs_err": err}


# 40f: the mesh runs in float64 (A14.2c), every leg at its configuration's
# full window width in a one-window cut (depth only), through the user's
# entry point with ``mesh=`` on four shards of the card (the 2-D range
# kNN's data × query mesh 2 × 2; the halo route eight shards), against the
# same leg's float64 run on one device of the card, bit for bit (the tStats
# pane engine's spatial sums within their float64 bound: ``index_add_``
# adds in another order on the card), and that run against the CPU's
# (the background twin ``x64_mesh``). The legs: config 3's polygon range
# (1,000 polygons, r = 0.002, seed 7: one window of 262,144 points; the
# mesh runs the dense kernel, one B4 a shard, one device the pruned one);
# config 4's point join (one window, 131,072 points a side, B3 a shard);
# join_point_1000polygons (one window, B4 gathered a shard); config 2's
# kNN (its first one-second window); ``run_multi`` at 64 queries on the
# 2 × 2 mesh (one window of 262,144); phase 17's geometry kNN (the first
# of phase 14's windows, 131,072 polygons); tjoin_10s_1s_sliding's window
# at 0 (204,800 points a side, cap 64, B3 a shard); bench_tstats_pane
# uncut; tjoin_panes_10s_10ms at 100 panes a side (35a's cut; r = 0.001,
# which float32 cannot hold); qserve_1024q_mixed's first of 8 windows;
# ``run_partitioned`` at range_8shard_halo's configuration (one window)
# against ``run``. The four gathering programs across processes run in
# float64 in phase 39's ranks (legs a64, b64, d64; 39c's inputs are
# float64 already).

#: The 40f legs by the CPU twin that runs them (one device, through the
#: plain versions).
X64F_TWINS = {"x64_mesh": ("range", "join", "pg_join", "knn", "geom_knn",
                           "tjoin", "halo")}
#: The 40f legs whose one-device run on the card is a 40c or 40e leg's:
#: the same stream, entry point and window, held to the CPU by that
#: leg's twin.
X64F_SHARED = {"run_multi": "40c", "tstats_panes": "40e",
               "tjoin_panes": "40e", "qserve": "40e"}
#: The float64 launches (B3, B4) each shard of a leg's mesh programs
#: makes a call: the launches a leg's mesh run must add are these times
#: the shard calls it made (``X64FShards``).
X64F_PER_SHARD = {"range": (0, 1), "join": (1, 0), "pg_join": (0, 1),
                  "geom_knn": (0, 2), "tjoin": (1, 0)}
#: The legs whose rows 40d times at a shard's shape: (label, leg, mode).
X64F_SHARD_SHAPES = (("b3", "join", "b3"), ("b3", "tjoin", "b3"),
                     ("b4", "range", "dense"), ("b4", "pg_join", "gathered"))


def x64f_inputs(legs=None):
    """{leg: its host arrays} of 40f's ``legs`` (all by default), from
    the seeds of the phases that own the configurations, each cut to its
    first window; ``x64f_objects`` makes the objects a run takes."""
    def range_xy():
        return (join_stream(RANGE_WIN, 7).astype(np.float64),)

    def join():
        return tuple(soa_join_chunks(seed)[0] for seed in (1, 2))

    def pg_join():
        xy, ts = pg_points()
        return xy[:PG_WIN].astype(np.float64), ts[:PG_WIN]

    def geom():
        return (geometry_chunks(GEOM_WINDOWS, GEOM_WIN)[0],)

    def tjoin():
        return tuple(c[:TJ_WINDOW_S] for c in _tjoin_sides())

    def qserve_window():
        xy, oid = qserve_points()
        n = QS_OP_WINDOWS * QS_WIN
        return xy[:n], oid[:n]

    def halo():
        _, _, xy, _, qxy, _ = halo_range_inputs()
        return xy[:HALO_WIN], qxy

    builders = {
        "range": range_xy, "join": join, "pg_join": pg_join,
        "knn": lambda: (pane_chunks()[0],),
        "run_multi": lambda: multi_arrays(MULTI_WIN),
        "geom_knn": geom, "tjoin": tjoin, "tstats_panes": tstats_stream,
        "tjoin_panes": lambda: tuple(tpanes_cut(tpanes_stream(),
                                                JS_TJ_PANES)),
        "qserve": qserve_window, "halo": halo,
    }
    return {leg: builders[leg]() for leg in (builders if legs is None
                                              else legs)}


def x64f_objects(leg, inp):
    """A leg's stream as its entry point takes it: ``Point`` (or
    ``Polygon``) objects in one-second windows, and its queries."""
    from spatialflink_tpu_torch.models.objects import Point

    def points(xy, ts, ids, prefix):
        return [Point(obj_id=f"{prefix}{i}", timestamp=int(t), x=x, y=y)
                for i, t, (x, y) in zip(ids, ts.tolist(),
                                        np.asarray(xy, np.float64).tolist())]

    def per_second(n):
        return (np.arange(n, dtype=np.int64) * 1000) // n

    if leg == "range":
        xy = inp[0]
        return points(xy, per_second(len(xy)), range(len(xy)), "p"), \
            range_polygons()
    if leg == "join":
        return tuple(points(np.stack([c["x"], c["y"]], axis=1), c["ts"],
                            range(len(c["ts"])), side)
                     for c, side in zip(inp, ("l", "r")))
    if leg == "pg_join":
        xy, ts = inp
        return (points(xy, ts, range(len(xy)), "p"),
                polygon_objects(pg_polygons(), 1))
    if leg == "knn":
        c = inp[0]
        return (points(np.stack([c["x"], c["y"]], axis=1), c["ts"],
                       c["oid"].tolist(), "o"),
                Point(obj_id="query", x=QUERY[0], y=QUERY[1]))
    if leg == "run_multi":
        xy, oid, qxy = inp
        return (points(xy, per_second(len(xy)), oid.tolist(), "o"),
                [Point(obj_id=f"mq{i}", x=x, y=y)
                 for i, (x, y) in enumerate(qxy.tolist())])
    if leg == "geom_knn":
        return geometry_objects(list(inp)), knn_query("polygon")
    if leg == "tjoin":
        n = TJ_WINDOW_S * TJ_SLIDE_PTS
        return tuple(traj_points(c, n, TJ_SLIDE_PTS, side)
                     for c, side in zip(inp, ("l", "r")))
    if leg == "qserve":
        return [e for e in qserve_command_stream(*inp) if e.timestamp < 1000]
    if leg == "halo":
        xy, qxy = inp
        return (points(xy, per_second(len(xy)), range(len(xy)), "h"),
                [Point(obj_id=f"hq{i}", x=x, y=y)
                 for i, (x, y) in enumerate(qxy.tolist())])
    return inp  # the array legs


def x64f_mesh(leg, gpu):
    """The mesh of a leg's sharded run on ``gpu``."""
    if leg == "run_multi":
        return mesh_of(gpu, (2, 2), ("data", "query"))
    if leg == "halo":
        return halo_mesh(gpu)
    return mesh_of(gpu)


def x64f_run(leg, device, objs, mesh=None):
    """One 40f leg on ``device`` in the float64 mode at the entry points'
    default dtype, on ``mesh`` (None: one device); the windows in
    comparable form, distances as float64 bits (``x64_bits``). The halo
    leg's one-device run is ``run``'s flag-table route."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.streams.panes import traj_stats_sliding

    grid = UniformGrid(**BEIJING)

    def conf(window=1.0, slide=None):
        return ops.QueryConfiguration(window_size=window,
                                      slide_step=slide or window)

    def pairs(res):
        # A mesh's pairs are the one device's as a set: sorted.
        return [(w.start, w.end, w.overflow, w.window_count, sorted(
            (a.obj_id, a.timestamp, b.obj_id, b.timestamp,
             np.float64(d).view(np.int64).item()) for a, b, d in w.pairs),
            sorted(x64_bits([d for *_, d in w.pairs]))) for w in res]

    def kept(res):
        return [(w.start, w.end, w.window_count,
                 [(o.obj_id, o.timestamp) for o in w.objects],
                 x64_bits(np.asarray(w.dists))) for w in res]

    def knn(res):
        return [(w.start, w.end, [n[0] for n in w.neighbors],
                 x64_bits([n[1] for n in w.neighbors])) for w in res]

    if leg == "range":
        op = ops.PointPolygonRangeQuery(conf(), grid, device=device)
        return kept(op.run(iter(objs[0]), objs[1], RANGE_R, mesh=mesh))
    if leg == "join":
        op = ops.PointPointJoinQuery(conf(), grid, cap=JOIN_CAP,
                                     device=device)
        return pairs(op.run(iter(objs[0]), iter(objs[1]), JOIN_R,
                            mesh=mesh))
    if leg == "pg_join":
        op = ops.PointPolygonJoinQuery(conf(), grid, device=device)
        return pairs(op.run(iter(objs[0]), iter(objs[1]), PG_R, mesh=mesh))
    if leg == "knn":
        op = ops.PointPointKNNQuery(conf(), grid, device=device)
        return knn(op.run(iter(objs[0]), objs[1], PANE_R, PANE_K,
                          mesh=mesh))
    if leg == "run_multi":
        op = ops.PointPointKNNQuery(conf(), grid, device=device)
        return [(m.start, m.end, m.window_count,
                 [([n[0] for n in w.neighbors],
                   x64_bits([n[1] for n in w.neighbors]))
                  for w in m.results])
                for m in op.run_multi(iter(objs[0]), objs[1], MULTI_R,
                                      MULTI_K, mesh=mesh)]
    if leg == "geom_knn":
        op = ops.PolygonPolygonKNNQuery(conf(), grid, device=device)
        return knn(op.run(iter(objs[0]), objs[1], KNN_GEOM_R, KNN_GEOM_K,
                          mesh=mesh))
    if leg == "tjoin":
        op = ops.PointPointTJoinQuery(conf(TJ_WINDOW_S), grid, cap=TJ_CAP,
                                      device=device)
        # Pairs by their ids and distance bits; each trajectory's
        # coordinates once by its id.
        return [(w.start, w.end, w.window_count, sorted(
            (a.obj_id, b.obj_id, np.float64(d).view(np.int64).item())
            for a, b, d in w.pairs),
            sorted(x64_bits([d for *_, d in w.pairs])),
            sorted((k, t.coords.tobytes()) for k, t in {
                t.obj_id: t for a, b, _ in w.pairs for t in (a, b)}.items()))
            for w in op.run(iter(objs[0]), iter(objs[1]), TJ_R, mesh=mesh)]
    if leg == "tstats_panes":
        res = traj_stats_sliding(*objs, TS_BUCKET, TS_WINDOW_MS, TS_SLIDE_MS,
                                 backend="device", device=device, mesh=mesh)
        if res.spatial.dtype != np.float64:
            raise AssertionError(f"40f {leg}: {res.spatial.dtype} sums")
        return res
    if leg == "tjoin_panes":
        op = ops.PointPointTJoinQuery(
            conf(TP_PPW * TP_SLIDE_MS / 1000, TP_SLIDE_MS / 1000), grid,
            device=device)
        return [(w[0], w[1], w[2].tolist(), w[3].tolist(), x64_bits(w[4]),
                 w[5], w[6])
                for w in op.run_soa_panes(*objs, TP_R, TP_IDS,
                                          cap_w=TP_CAP_W,
                                          pair_sel=TP_PAIR_SEL,
                                          backend="device", mesh=mesh)]
    if leg == "qserve":
        op = qserve.QServeOperator(conf(), grid, device=device)
        try:
            res = list(op.run(iter(objs), mesh=mesh))
        finally:
            qserve.uninstall()
        return [(r.start, r.end, r.window_count, list(r.lines()),
                 x64_bits([row[4] for row in r.rows])) for r in res]
    # halo: run_partitioned on the mesh, run's flag-table route without.
    op = ops.PointPointRangeQuery(conf(), halo_grid(HALO_N), device=device)
    res = (op.run(iter(objs[0]), objs[1], HALO_R) if mesh is None else
           op.run_partitioned(iter(objs[0]), objs[1], HALO_R, mesh))
    return kept(res)


def x64f_matches(leg, windows) -> int:
    """A 40f leg's matches over its windows (pairs, kept objects,
    neighbours, egress rows, the tStats windows' point count)."""
    if leg == "tstats_panes":
        return int(windows.count.sum())
    if leg == "tjoin_panes":
        return sum(w[5] for w in windows)
    if leg == "run_multi":
        return sum(len(ids) for m in windows for ids, _ in m[3])
    field = {"range": 3, "halo": 3, "qserve": 3, "tjoin": 3}.get(leg, 4)
    if leg in ("knn", "geom_knn"):
        field = 2
    return sum(len(w[field]) for w in windows)


def x64f_same(leg, got, want, inp, label):
    """Whether two runs of a 40f leg agree: exactly, the tStats pane
    engine's spatial sums within their float64 bound."""
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.streams.panes import pane_spatial_bound

    if leg == "tstats_panes":
        with precision.x64(True):
            bound = pane_spatial_bound(*inp, TS_BUCKET, TS_WINDOW_MS,
                                       TS_SLIDE_MS)
        check_pane_windows(got, want, bound, label)
        return True
    return got == want


def x64f_legs(device, inputs, legs=None, on_leg=None):
    """40f's ``legs`` of ``inputs`` on one ``device`` (the CPU twin's
    runs): ({leg: windows}, the seconds of all, {leg: seconds})."""
    from spatialflink_tpu_torch import precision

    out, secs = {}, {}
    for leg in (inputs if legs is None else legs):
        objs = x64f_objects(leg, inputs[leg])
        if on_leg is not None:
            on_leg(leg)
        t0 = time.perf_counter()
        with precision.x64(True):
            out[leg] = x64f_run(leg, device, objs)
        secs[leg] = time.perf_counter() - t0
    return out, sum(secs.values()), secs


class X64FShards:
    """Counts the shard calls of the mesh programs (``sharded.
    _shard_parts``, every shard of every sharded window, join and pruned
    program) while installed: a leg's float64 launches must be its
    per-shard launches (``X64F_PER_SHARD``) times these."""

    def __enter__(self):
        from spatialflink_tpu_torch.parallel import sharded

        self.mod, self.inner, self.shards = sharded, sharded._shard_parts, 0

        def counted(mesh, args, data_idx, fn):
            parts = self.inner(mesh, args, data_idx, fn)
            self.shards += len(parts)
            return parts

        sharded._shard_parts = counted
        return self

    def __exit__(self, *exc):
        self.mod._shard_parts = self.inner
        return False


def check_x64f(gpu, card, shared=None):
    """40f on ``gpu`` (the card; ``cpu`` rehearses it): each leg on one
    device, then on its mesh, held bit-equal (the tStats sums within
    their bound), the mesh run's float64 launches held to its shard
    calls; the CPU runs in the twin ``x64_mesh``, compared later.
    ``shared``: {leg: (windows, seconds)} of the ``X64F_SHARED`` legs'
    one-device runs, made by 40c and 40e (a leg missing there, as in a
    rehearsal of 40f alone, runs here). Returns (the mesh runs' float64
    launches {"join_extract", "polyline_min_dist"}, the first float64
    kernel arguments of each leg's shards: {(leg, mode): args})."""
    import torch

    from spatialflink_tpu_torch import precision

    t0 = time.perf_counter()
    inputs = x64f_inputs()
    in_secs = time.perf_counter() - t0
    if float(np.float32(TP_R)) == TP_R:
        raise AssertionError("40f: the pane-carry tJoin's radius is a "
                             "float32 value")
    got, one_ms, mesh_ms, shards = {}, {}, {}, {}
    totals = {"join_extract": 0, "polyline_min_dist": 0}
    with X64Launches(gpu) as xl:
        for leg in inputs:
            objs = x64f_objects(leg, inputs[leg])
            runs = {}
            if leg in (shared or {}):
                runs["one"] = shared[leg][0]
                one_ms[leg] = 1e3 * shared[leg][1]
            for where, mesh in (("one", None),
                                ("mesh", x64f_mesh(leg, gpu))):
                if where in runs:
                    continue
                xl.on_leg(leg if mesh is not None else f"{leg} one device")
                with X64FShards() as sc:
                    t1 = time.perf_counter()
                    with precision.x64(True):
                        runs[where] = x64f_run(leg, gpu, objs, mesh)
                    if gpu == "cuda":
                        torch.cuda.synchronize()
                    secs = time.perf_counter() - t1
                (one_ms if mesh is None else mesh_ms)[leg] = 1e3 * secs
                shards[leg] = sc.shards
            xl.on_leg(None)
            if not x64f_same(leg, runs["mesh"], runs["one"], inputs[leg],
                             f"40f {leg}") or not x64f_matches(leg,
                                                               runs["mesh"]):
                raise AssertionError(f"40f {leg}: the mesh run differs from "
                                     f"the one-device run, or holds nothing")
            b3, b4 = X64F_PER_SHARD.get(leg, (0, 0))
            made = xl.by_leg[leg]
            need = {"join_extract": b3 * shards[leg],
                    "polyline_min_dist": b4 * shards[leg]}
            if made != need or (b3 or b4) and not shards[leg]:
                raise AssertionError(f"40f {leg}: float64 launches {made}, "
                                     f"the shards' {need} ({shards[leg]} "
                                     f"shard calls)")
            for k in totals:
                totals[k] += made[k]
            got[leg] = runs["one"]
            n_win = len(runs["one"].starts) if leg == "tstats_panes" \
                else len(runs["one"])
            print(f"x64 40f {leg}: {x64f_matches(leg, runs['one'])} matches "
                  f"over {n_win} windows; mesh "
                  f"{mesh_ms[leg] / n_win:.3f} ms a window on "
                  f"{x64f_mesh(leg, gpu).devices.size} shards, one device "
                  f"{one_ms[leg] / n_win:.3f} ms a window"
                  + (f" ({X64F_SHARED[leg]}'s run)" if leg in (shared or {})
                     else "")
                  + f" (the shards share one card: not a scaling figure); "
                  + ("equal" if leg != "tstats_panes" else
                     "counts and temporal sums equal, spatial sums within "
                     "pane_spatial_bound")
                  + f"; float64 launches of the mesh run join_extract="
                  f"{made['join_extract']} polyline_min_dist="
                  f"{made['polyline_min_dist']} ({shards[leg]} shard calls)"
                  + ("; no plain version reached" if gpu == "cuda" else "")
                  + f" [{card}]")
    first = {key: xl.first[key] for key in xl.first
             if key[0] in X64F_PER_SHARD}
    print(f"x64 40f: inputs {in_secs:.3f} s; the mesh runs' float64 "
          f"launches join_extract={totals['join_extract']} "
          f"polyline_min_dist={totals['polyline_min_dist']} [{card}]")
    if sorted([leg for legs in X64F_TWINS.values() for leg in legs]
              + list(X64F_SHARED)) != sorted(inputs):
        raise AssertionError("40f: a leg without its CPU run")
    for name, legs in X64F_TWINS.items():
        def held_twin(name=name, legs=legs):
            want, _, w_secs = twin(name, *(inputs[leg] for leg in legs))
            for leg in legs:
                if not x64f_same(leg, got[leg], want[leg], inputs[leg],
                                 f"40f {leg} CPU"):
                    raise AssertionError(f"40f x64 {leg}: the card's windows "
                                         f"differ from the CPU's")
            print("exact x64 40f legs ("
                  + ", ".join(f"{leg} {x64f_matches(leg, got[leg])} matches,"
                              f" {w_secs[leg]:.3f} s on the CPU"
                              for leg in legs)
                  + f"): the card's one-device runs, and so its mesh runs, "
                  f"equal to the CPU runs through the plain versions (the "
                  f"CPU twin {name}), float64 distances bit for bit; "
                  + ", ".join(f"{leg}'s through {where}'s twin"
                              for leg, where in X64F_SHARED.items())
                  + f" [{card}]")
        later(held_twin)
    return totals, first


def plane_pair_tests(planes, layers):
    """Pair tests a B3 call's planes hold: each cell's left points times
    the right points of its (2·layers + 1)² neighbour cells."""
    lidx, ridxp = planes[2], planes[5]
    n = lidx.shape[0]
    cl = (lidx >= 0).sum(dim=-1).long()
    cr = (ridxp >= 0).sum(dim=-1).long()
    span = 2 * layers + 1
    nb = sum(cr[dx:dx + n, dy:dy + n] for dx in range(span)
             for dy in range(span))
    return int((cl * nb).sum())


def x64f_shard_rows(dev, card, first):
    """40d at a shard's shape: B3's and B4's float64 instantiations on the
    first arguments one shard of 40f's mesh legs gave them, bit-exact
    against their plain versions, then timed beside them and their
    bounds. Returns {label: row}."""
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
    )
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rows = {}
    for kind, leg, mode in X64F_SHARD_SHAPES:
        args = first[(leg, mode)]
        label = f"mesh_shard_{leg}"
        if kind == "b3":
            planes, (grid_n, layers, radius, max_pairs) = args[:6], args[6:]
            got, err = b3_compare(planes, grid_n, layers, radius, max_pairs,
                                  card, f"f64_{label}")
            ms, call = time_ms(lambda: join_extract_cuda(*args))
            plain, _ = time_ms(lambda: join_extract_plain(*args),
                               X64_PLAIN_REPEATS)
            tests = plane_pair_tests(planes, layers)
            nbytes = sum(p.numel() * p.element_size() for p in planes) \
                + 16 * max_pairs + 4
            nops = 6 * tests
            shape = (f"{int((planes[2] >= 0).sum())} left points on a "
                     f"{grid_n}-grid, cap {planes[0].shape[-1]}, "
                     f"{int(got[3])} pairs")
        else:
            _, err = b4_case(dev, *args, card, f"f64_{label}")
            ms, call = time_ms(lambda: polyline_min_dist_cuda(*args))
            plain, _ = time_ms(lambda: polyline_min_dist_plain(*args),
                               X64_PLAIN_REPEATS)
            nbytes, nops = b4_work(*args)
            xy, verts, _, sel = args
            c = verts.shape[0] if sel is None else sel.shape[1]
            shape = (f"{mode}, N={xy.shape[0]} points, C={c} "
                     f"{'boundaries' if sel is None else 'slots'} of "
                     f"V={verts.shape[1]}")
        bnd, by_ = bound_ms(nbytes, nops, F64_OPS_PER_S)
        name = "join_extract_f64" if kind == "b3" else \
            "polyline_min_dist_f64"
        print(f"time {name} at a shard's shape (40f {leg}'s first shard "
              f"call: {shape}): kernel {ms:.6f} ms device ({call:.6f} ms "
              f"per call with its launches), plain PyTorch {plain:.6f} ms, "
              f"bound {bnd:.6f} ms ({by_}: {nbytes} B, {nops} float64 "
              f"operations at {F64_OPS_PER_S:g}/s), library none, medians "
              f"of {REPEATS} calls (the plain version's of "
              f"{X64_PLAIN_REPEATS}) [{card}]")
        rows[label] = {"ms": ms, "call_ms": call, "plain_ms": plain,
                       "bound_ms": bnd, "bound_by": by_, "max_abs_err": err,
                       "shape": shape}
    return rows


def check_x64(dev, card, gpu="cuda"):
    """Phase 40: the float64 mode on the card (``--x64-only`` runs it
    alone). Returns the float64 kernels' rows of the ``kernels`` record.
    ``gpu="cpu"`` rehearses the legs' logic on the CPU (40a, 40b and 40d
    need the card and are skipped; the launch checks then need the plain
    versions wrapped to count)."""
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract,
        join_extract_cuda,
        join_extract_plain,
    )
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist,
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    t_phase = t0 = time.perf_counter()
    walls = {}
    if gpu == "cuda":
        err3, planes, sides = check_x64_b3(dev, card)
        err4, b4g = check_x64_b4(dev, card)
        walls["a+b"] = time.perf_counter() - t0

    # 40c: the legs on the card, then on the CPU: the heavy ones' CPU runs
    # in the background pool (compared after phase 36), the others here.
    t0 = time.perf_counter()
    inputs = x64_inputs()
    walls["c inputs"] = time.perf_counter() - t0
    join_extract.launches_f64 = polyline_min_dist.launches_f64 = 0
    with X64Launches(gpu) as xl:
        got, _, g_secs = x64_legs(gpu, inputs, on_leg=xl.on_leg)
    launches = {"join_extract_f64": join_extract.launches_f64,
                "polyline_min_dist_f64": polyline_min_dist.launches_f64}
    need = {  # leg: (B3, B4) float64 launches it must make at least
        "join": (X64_WINDOWS, 0), "pp_query_panes": (1, 0),
        "range_polygons": (0, X64_WINDOWS),
        "range_linestrings": (0, X64_WINDOWS),
        "geom_range": (0, 2 * X64_WINDOWS), "geom_knn": (0, 2 * X64_WINDOWS),
        "pg_join": (0, X64_WINDOWS), "gg_join": (0, 2 * X64_WINDOWS),
        "knn_query_panes": (0, QP_PANES)}
    short = {leg: xl.by_leg[leg] for leg, (b3, b4) in need.items()
             if xl.by_leg[leg]["join_extract"] < b3
             or xl.by_leg[leg]["polyline_min_dist"] < b4}
    if short or min(xl.modes.values()) < 1:
        raise AssertionError(f"40c: float64 launches short: {short}, B4 by "
                             f"mode {xl.modes}")

    def held(legs, want, w_secs, where):
        for leg in legs:
            if got[leg] != want[leg] or not x64_matches(leg, got[leg]):
                raise AssertionError(f"40c x64 {leg}: the card's windows "
                                     f"differ from the CPU's, or hold "
                                     f"nothing")
        print("exact x64 legs (precision.x64(True), the default dtype "
              "float64; "
              + ", ".join(f"{leg} {len(got[leg])} windows, "
                          f"{x64_matches(leg, got[leg])} matches, "
                          f"{g_secs[leg]:.3f} s on the card, "
                          f"{w_secs[leg]:.3f} s on the CPU" for leg in legs)
              + f"): every window equal to the CPU run through the plain "
              f"versions ({where}), float64 distances bit for bit [{card}]")

    if sorted(leg for legs in X64_TWINS.values() for leg in legs) != \
            sorted(inputs):
        raise AssertionError("40c: a leg without its CPU twin")
    for name, legs in X64_TWINS.items():
        def held_twin(name=name, legs=legs):
            want, _, w_secs = twin(name, *(inputs[leg][1:] for leg in legs))
            held(legs, want, w_secs, f"the CPU twin {name}")
        later(held_twin)
    print("x64 float64 launches on the legs (B3, B4): "
          + ", ".join(f"{leg} {c['join_extract']}/{c['polyline_min_dist']}"
                      for leg, c in xl.by_leg.items())
          + f"; B4 by mode {xl.modes}; in all join_extract="
          f"{launches['join_extract_f64']} polyline_min_dist="
          f"{launches['polyline_min_dist_f64']}"
          + ("; no plain version reached" if gpu == "cuda" else "")
          + f" [{card}]")
    walls["c"] = time.perf_counter() - t0
    # 40e: the trajectory and serving slice.
    t0 = time.perf_counter()
    tj_b3, tj_got, tj_secs = check_x64e(gpu, card)
    walls["e"] = time.perf_counter() - t0
    # 40f: the mesh runs, on the one-device runs of 40c and 40e where
    # those are its legs'.
    t0 = time.perf_counter()
    runs = {"40c": (got, g_secs), "40e": (tj_got, tj_secs)}
    mesh_l, shard_first = check_x64f(gpu, card, {
        leg: (runs[where][0][leg], runs[where][1][leg])
        for leg, where in X64F_SHARED.items()})
    walls["f"] = time.perf_counter() - t0
    rows = {}
    if gpu == "cuda":
        # 40d: the float64 kernels' times at the shapes of 40a and 40b,
        # B3 also at tJoin's (cap 64), and B4 at the legs' dense, G = 1
        # and join-tile shapes.
        t0 = time.perf_counter()
        b3 = (*planes, BEIJING["num_partitions"], 1, JOIN_R, JOIN_MAX_PAIRS)
        b3_ms, b3_call = time_ms(lambda: join_extract_cuda(*b3))
        b3_plain, _ = time_ms(lambda: join_extract_plain(*b3))
        pair_tests = join_candidate_pairs(UniformGrid(**BEIJING), *sides)
        b3_bytes = sum(t.numel() * t.element_size() for t in planes) \
            + 16 * JOIN_MAX_PAIRS + 4
        b3_bound, b3_by = bound_ms(b3_bytes, 6 * pair_tests, F64_OPS_PER_S)
        b4_bytes, b4_ops = b4_work(*b4g)
        b4_ms, b4_call = time_ms(lambda: polyline_min_dist_cuda(*b4g))
        b4_plain, _ = time_ms(lambda: polyline_min_dist_plain(*b4g))
        b4_bound, b4_by = bound_ms(b4_bytes, b4_ops, F64_OPS_PER_S)
        tj = x64e_tjoin_shape(dev, card)
        shard_rows = x64f_shard_rows(dev, card, shard_first)
        for name, ms, call, plain, bnd, by_, nb, no, shape in (
                ("join_extract_f64", b3_ms, b3_call, b3_plain, b3_bound,
                 b3_by, b3_bytes, 6 * pair_tests, "the join's full shape"),
                ("polyline_min_dist_f64", b4_ms, b4_call, b4_plain,
                 b4_bound, b4_by, b4_bytes, b4_ops,
                 "config 3 gathered, N=262,144, C=8")):
            print(f"time {name}: kernel {ms:.6f} ms device ({call:.6f} ms "
                  f"per call with its launch), plain PyTorch {plain:.6f} ms, "
                  f"bound {bnd:.6f} ms ({by_}: {nb} B, {no} float64 "
                  f"operations at {F64_OPS_PER_S:g}/s), library none, "
                  f"medians of {REPEATS} calls at {shape} [{card}]")
        shapes = {}
        for label, leg, mode in X64_B4_SHAPES:
            args = xl.first[(leg, mode)]
            xy, verts, ev, sel = args
            nb, no = b4_work(*args)
            ms, call = time_ms(lambda: polyline_min_dist_cuda(*args))
            plain, _ = time_ms(lambda: polyline_min_dist_plain(*args),
                               X64_PLAIN_REPEATS)
            bnd, by_ = bound_ms(nb, no, F64_OPS_PER_S)
            c = verts.shape[0] if sel is None else sel.shape[1]
            shapes[label] = dict(ms=ms, call_ms=call, plain_ms=plain,
                                 bound_ms=bnd, bound_by=by_,
                                 launches=xl.modes[mode], leg=leg,
                                 points=int(xy.shape[0]), slots=int(c),
                                 vertices=int(verts.shape[1]))
            print(f"time polyline_min_dist_f64 {label} ({leg}'s first "
                  f"{mode} call: N={xy.shape[0]} points, C={c} "
                  f"{'boundaries' if sel is None else 'slots'} of "
                  f"V={verts.shape[1]}; {xl.modes[mode]} {mode} launches on "
                  f"the legs): kernel {ms:.6f} ms device ({call:.6f} ms per "
                  f"call with its launch), plain PyTorch {plain:.6f} ms, "
                  f"bound {bnd:.6f} ms ({by_}: {nb} B, {no} float64 "
                  f"operations at {F64_OPS_PER_S:g}/s), library none, "
                  f"medians of {REPEATS} calls (the plain version's of "
                  f"{X64_PLAIN_REPEATS}) [{card}]")
        rows = {
            "join_extract_f64": {
                "name": "join_extract_f64", "route": "cuda",
                "source": "spatialflink_tpu_torch/kernels/csrc/"
                          "join_extract.cu",
                "replaces": "spatialflink_tpu/ops/pallas_join.py:41",
                "launches": launches["join_extract_f64"] + tj_b3
                + mesh_l["join_extract"],
                "launches_query_panes":
                    xl.by_leg["pp_query_panes"]["join_extract"],
                "launches_tjoin": tj_b3,
                "launches_mesh": mesh_l["join_extract"],
                "max_abs_err": max(err3, tj["max_abs_err"], *(
                    r["max_abs_err"] for k, r in shard_rows.items()
                    if k in ("mesh_shard_join", "mesh_shard_tjoin"))),
                "ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bound,
                "bound_by": b3_by, "library_ms": None, "dtype": "float64",
                "shapes": {"tjoin_window": {**tj, "launches": tj_b3},
                           "mesh_shard_join": shard_rows["mesh_shard_join"],
                           "mesh_shard_tjoin":
                               shard_rows["mesh_shard_tjoin"]}},
            "polyline_min_dist_f64": {
                "name": "polyline_min_dist_f64", "route": "cuda",
                "source": "spatialflink_tpu_torch/kernels/csrc/"
                          "polyline_min_dist.cu",
                "replaces": "spatialflink_tpu/ops/pallas_kernels.py:39",
                "launches": launches["polyline_min_dist_f64"]
                + mesh_l["polyline_min_dist"],
                "launches_by_mode": dict(xl.modes),
                "launches_mesh": mesh_l["polyline_min_dist"],
                "max_abs_err": max(err4, *(
                    r["max_abs_err"] for k, r in shard_rows.items()
                    if k in ("mesh_shard_range", "mesh_shard_pg_join"))),
                "ms": b4_ms, "plain_ms": b4_plain,
                "bound_ms": b4_bound, "bound_by": b4_by,
                "library_ms": None, "dtype": "float64",
                "shapes": {**shapes,
                           "mesh_shard_range": shard_rows["mesh_shard_range"],
                           "mesh_shard_pg_join":
                               shard_rows["mesh_shard_pg_join"]}},
        }
        walls["d"] = time.perf_counter() - t0
    print(f"phase walls: 40 {time.perf_counter() - t_phase:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
          + f" s) [{card}]")
    return rows


def twin_halo_range():
    """Phase 38a: the halo range's windows on an eight-shard CPU mesh."""
    inputs = halo_range_inputs()
    return digest(inputs[2], inputs[4]), halo_range_run("cpu", inputs)


def twin_halo_registry():
    """Phase 38d: the halo registry bucket on an eight-shard CPU mesh."""
    rin = halo_registry_inputs()
    return digest(rin[2], rin[5], rin[7]), halo_registry_run("cpu", rin)


def twin_run_soa():
    """Phase 8: ``run_soa`` over both 16-window join streams."""
    chunks = (soa_join_chunks(1), soa_join_chunks(2))
    return digest(chunks), run_soa_path("cpu", chunks)


def twin_range():
    """Phase 12: config 3's first ``RANGE_CPU_WINDOWS`` windows."""
    from spatialflink_tpu_torch.operators import PointPolygonRangeQuery

    cut = range_chunks(RANGE_WINDOWS, RANGE_WIN, 7)[:RANGE_CPU_WINDOWS]
    polys = range_polygons()
    want, secs, op = run_range("cpu", PointPolygonRangeQuery, cut, polys,
                               RANGE_R)
    return digest(cut, polys), (want, secs, op._ncand)


def twin_geometry_range():
    """Phase 14: the first ``GEOM_CPU_WINDOWS`` polygon windows."""
    from spatialflink_tpu_torch.operators import PolygonPolygonRangeQuery

    cut = geometry_chunks(GEOM_WINDOWS, GEOM_WIN)[:GEOM_CPU_WINDOWS]
    polys = geometry_queries("polygon")
    return digest(cut, polys), run_geometry(
        "cpu", PolygonPolygonRangeQuery, cut, polys)


def twin_pg_join():
    """Phase 20: join_point_1000polygons, every window."""
    from spatialflink_tpu_torch.operators import PointPolygonJoinQuery

    xy, ts = pg_points()
    left = point_chunks(xy, ts, PG_WIN)
    right = polygon_chunks(pg_polygons(), PG_WINDOWS)
    want, secs, _ = run_join_soa("cpu", PointPolygonJoinQuery, left, right,
                                 PG_R)
    return digest(left, right), (want, secs)


def twin_gg_join():
    """Phase 21: the first ``GG_CPU_WINDOWS`` polygon ⋈ polygon windows."""
    from spatialflink_tpu_torch.operators import PolygonPolygonJoinQuery

    left = geometry_chunks(GEOM_WINDOWS, GEOM_WIN)[:GG_CPU_WINDOWS]
    right = polygon_chunks(range_polygons(), GG_WINDOWS)[:GG_CPU_WINDOWS]
    want, secs, _ = run_join_soa("cpu", PolygonPolygonJoinQuery, left, right,
                                 PG_R)
    return digest(left, right), (want, secs)


def twin_driver_range():
    """Phase 32a: the range leg's clean run on the CPU, its egress."""
    import shutil
    import tempfile

    import torch

    tmp = tempfile.mkdtemp(prefix="sft_driver_twin_")
    try:
        t0 = time.perf_counter()
        egress, _ = driver_range_leg(torch.device("cpu"), tmp,
                                     driver_range_stream(), range_polygons())
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return digest(driver_range_arrays()), (egress, secs)


def twin_query_panes():
    """Phase 22: ``query_panes`` over the two ``Point`` streams."""
    streams = qpj_streams()
    return digest(streams), run_query_panes("cpu", streams)


def twin_tjoin_soa():
    """Phase 23: ``run_soa`` at the first, a middle and the last full
    window."""
    chunks = (tjoin_chunks(31), tjoin_chunks(32))
    want, secs, _ = run_tjoin_soa("cpu", chunks, slide_s=TJ_WINDOW_S)
    return digest(chunks), (want, secs)


def twin_tjoin_objects(method):
    """Phase 23: ``run`` (both streams) or ``run_single`` (the left) on
    ``Point`` objects."""
    from spatialflink_tpu_torch.operators import PointPointTJoinQuery

    pts = tjoin_object_streams((tjoin_chunks(31), tjoin_chunks(32)))
    streams = pts if method == "run" else pts[:1]
    return digest(streams), run_objects_family(
        "cpu", PointPointTJoinQuery, method, streams, TJ_R,
        op_kw={"cap": TJ_CAP})


def twin_tagg_sum():
    """Phase 25: tAggregate SUM ``run_soa`` over config 2's stream."""
    from spatialflink_tpu_torch.operators import PointTAggregateQuery

    chunks = pane_chunks()
    return digest(chunks), traj_soa("cpu", PointTAggregateQuery, chunks,
                                    window=PANE_WINDOW_S, aggregate="SUM")


def twin_tjoin_panes():
    """Phase 26: the pane engine over the first ``TP_CPU_PANES`` panes."""
    cols = tpanes_columns(tpanes_stream())
    return digest(cols), tjoin_panes_cpu(cols)


def twin_x64(name):
    """Phase 40c: the x64 legs of ``X64_TWINS[name]`` on the CPU."""
    legs = X64_TWINS[name]
    inputs = x64_inputs(legs)
    return (digest(*(inputs[leg][1:] for leg in legs)),
            x64_legs("cpu", inputs, legs))


def twin_x64f(name):
    """Phase 40f: the legs of ``X64F_TWINS[name]`` on one CPU device."""
    legs = X64F_TWINS[name]
    inputs = x64f_inputs(legs)
    return (digest(*(inputs[leg] for leg in legs)),
            x64f_legs("cpu", inputs, legs))


def twin_x64e(name):
    """Phase 40e: the legs of ``X64E_TWINS[name]`` on the CPU."""
    legs = X64E_TWINS[name]
    inputs = x64e_inputs(legs)
    return (digest(*(inputs[leg] for leg in legs)),
            x64e_legs("cpu", inputs, legs))


# The background twins, in the order the phases ask for them, but for
# the longest, phase 40's polygon ⋈ polygon, queued first.
TWINS = {"x64_gg": functools.partial(twin_x64, "x64_gg"),
         "run_soa": twin_run_soa, "range": twin_range,
         "geometry_range": twin_geometry_range, "pg_join": twin_pg_join,
         "gg_join": twin_gg_join, "query_panes": twin_query_panes,
         "tjoin_soa": twin_tjoin_soa,
         "tjoin_run": functools.partial(twin_tjoin_objects, "run"),
         "tjoin_run_single": functools.partial(twin_tjoin_objects,
                                               "run_single"),
         "tagg_sum": twin_tagg_sum, "tjoin_panes": twin_tjoin_panes,
         "driver_range": twin_driver_range, "halo_range": twin_halo_range, "halo_registry": twin_halo_registry,
         "x64": functools.partial(twin_x64, "x64"),
         "x64_geometry": functools.partial(twin_x64, "x64_geometry"),
         "x64_light": functools.partial(twin_x64, "x64_light"),
         "x64_traj": functools.partial(twin_x64e, "x64_traj"),
         "x64_traj_light": functools.partial(twin_x64e, "x64_traj_light"),
         "x64_mesh": functools.partial(twin_x64f, "x64_mesh")}


def run_domain_phases(card, gpu="cuda"):
    """Phases 29-30, their walls printed. Returns (B4 launches of the
    counters run, phase 29's benchmark rates)."""
    t0 = time.perf_counter()
    brakes, rates = check_sncb(card, gpu)
    t1 = time.perf_counter()
    launches = check_mn_and_counters(card, brakes, gpu)
    t2 = time.perf_counter()
    print(f"phase walls: 29 {t1 - t0:.3f} s, 30 {t2 - t1:.3f} s [{card}]")
    return launches, rates


def run_ingest_phases(card, gpu="cuda"):
    """Phases 27-28, their walls printed. Returns B4's launches."""
    t0 = time.perf_counter()
    launches, gps = check_ingest(card, gpu)
    t1 = time.perf_counter()
    check_apps(card, gps, gpu)
    t2 = time.perf_counter()
    print(f"phase walls: 27 {t1 - t0:.3f} s, 28 {t2 - t1:.3f} s [{card}]")
    return launches


def run_trajectory_phases(dev, card, gpu="cuda"):
    """Phases 23-26, each phase's wall printed. Returns (B3 launches of
    phase 23, B3's timing row at the tJoin shape)."""
    t0 = time.perf_counter()
    launches, got, secs, chunks = check_tjoin(card, gpu)
    row = time_tjoin(dev, card, got, secs, chunks)
    t1 = time.perf_counter()
    check_tstats(dev, card, gpu)
    t2 = time.perf_counter()
    rates = check_traj_families(card, gpu)
    t3 = time.perf_counter()
    tp_secs = check_tjoin_panes(dev, card, gpu)
    t4 = time.perf_counter()
    n = 2 * TJ_SLIDES * TJ_SLIDE_PTS
    print(f"e2e rates: tJoin run_soa {n / secs:.1f} points/s, "
          + ", ".join(f"{k} {v:.1f} points/s" for k, v in rates.items())
          + f", tJoin run_soa_panes {2 * TP_PANES * TP_PANE_PTS / tp_secs:.1f}"
          f" points/s [{card}]")
    print(f"phase walls: 23 {t1 - t0:.3f} s, 24 {t2 - t1:.3f} s, 25 "
          f"{t3 - t2:.3f} s, 26 {t4 - t3:.3f} s [{card}]")
    return launches, row


def run_join_phases(dev, card, geo_chunks):
    """Phases 20-22, each phase's wall printed. Returns (B4 launches of
    phase 20, of phase 21, B3 launches of query_panes, B4 timing
    rows)."""
    t0 = time.perf_counter()
    pg_launches, pg_secs, pg_op, pg_inputs = check_join_point_geometry(card)
    t1 = time.perf_counter()
    gg_launches, gg_secs, gg_op, gg_inputs = check_join_geometry_geometry(
        card, geo_chunks)
    qp_launches, qp_rate = check_join_panes(card)
    t2 = time.perf_counter()
    rows = time_join(dev, card, (pg_secs, pg_op, pg_inputs),
                     (gg_secs, gg_op, gg_inputs), qp_rate)
    t3 = time.perf_counter()
    print(f"phase walls: 20 {t1 - t0:.3f} s, 21 {t2 - t1:.3f} s, 22 "
          f"{t3 - t2:.3f} s [{card}]")
    return pg_launches, gg_launches, qp_launches, rows


def run_new_phases(dev, card, geo_chunks):
    """Phases 17-19, each phase's wall printed. Returns (B4 launches of
    phase 17, of phase 18, B4 timing rows)."""
    t0 = time.perf_counter()
    geo_launches, geo_secs = check_knn_geometry(card, geo_chunks)
    t1 = time.perf_counter()
    pane_launches, rates = check_knn_panes(card)
    t2 = time.perf_counter()
    rows = time_knn(dev, card, geo_chunks, geo_secs, rates)
    t3 = time.perf_counter()
    print(f"phase walls: 17 {t1 - t0:.3f} s, 18 {t2 - t1:.3f} s, 19 "
          f"{t3 - t2:.3f} s [{card}]")
    return geo_launches, pane_launches, rows


def main(argv=None) -> int:
    import signal

    def on_term(signum, _frame):
        raise SystemExit(128 + signum)

    # A SIGTERM to this process alone unwinds it, so that the children
    # are stopped below.
    signal.signal(signal.SIGTERM, on_term)
    try:
        return run(argv)
    finally:
        stop_twins()
        stop_children(DRIVER_CHILDREN)
        stop_children(PARTITION_CHILDREN)
        stop_children(MULTIHOST_CHILDREN)
        stop_children(DAG_CHILDREN)


def run(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-4 and 7 only (build and check the kernels)")
    ap.add_argument("--trajectory-only", action="store_true",
                    help="phases 1-2 and 23-26 only (build, then the "
                         "trajectory layer)")
    ap.add_argument("--ingest-only", action="store_true",
                    help="phases 1-2 and 27-28 only (build, then ingest "
                         "and the apps)")
    ap.add_argument("--domain-only", action="store_true",
                    help="phases 1-2 and 29-30 only (build, then the SNCB "
                         "and MobilityNebula layers and the op counters)")
    ap.add_argument("--runtime-only", action="store_true",
                    help="phases 1-2 and 31 only (build, then telemetry, "
                         "faults and ablation on the card)")
    ap.add_argument("--driver-only", action="store_true",
                    help="phases 1-2 and 32 only (build, then the dataflow "
                         "driver, checkpoints and exactly-once egress)")
    ap.add_argument("--overload-only", action="store_true",
                    help="phases 1-2 and 33 only (build, then overload "
                         "control and the SLO engine)")
    ap.add_argument("--qserve-only", action="store_true",
                    help="phases 1-2 and 34 only (build, then standing-"
                         "query serving)")
    ap.add_argument("--jobsurface-only", action="store_true",
                    help="phases 1-2 and 35 only (build, then the native "
                         "engines and Kafka into the headline program)")
    ap.add_argument("--dag-only", action="store_true",
                    help="phases 1-2 and 36 only (build, then the composed "
                         "SNCB DAG and the StreamingJob entry point)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="phases 1-2 and 37 only (build, then the mesh "
                         "layer, four shards on the card)")
    ap.add_argument("--partition-only", action="store_true",
                    help="phases 1-2 and 38 only (build, then the grid-"
                         "partitioned halo layer and multi-process runs)")
    ap.add_argument("--multihost-only", action="store_true",
                    help="phases 1-2 and 39 only (build, then the mesh "
                         "programs on two gloo ranks of the card)")
    ap.add_argument("--x64-only", action="store_true",
                    help="phases 1-2 and 40 only (build, then the float64 "
                         "mode: B3 and B4 in float64 and every float64 "
                         "path against the CPU)")
    ap.add_argument("--multihost-child", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--driver-child", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--dag-child", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--child-device", default="cuda", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if args.dag_child and args.child_device == "cpu":
        return dag_child(args.dag_child, "cpu")  # a CPU rehearsal's child
    if args.multihost_child and args.child_device == "cpu":
        return multihost_child(args.multihost_child, "cpu")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.driver_child:  # one child process of phase 32a
        return driver_child(args.driver_child)
    if args.dag_child:  # one child process of phase 36b
        return dag_child(args.dag_child)
    if args.multihost_child:  # one rank of phase 39
        return multihost_child(args.multihost_child)
    from spatialflink_tpu_torch import kernels
    from spatialflink_tpu_torch.ops import wire_codec as wc
    from spatialflink_tpu_torch.ops.wire_digest_kernel import (
        wire_digest,
        wire_digest_cuda,
        wire_digest_plain,
    )
    from spatialflink_tpu_torch.streams.wire import WireFormat
    from spatialflink_tpu_torch.grid import UniformGrid

    # Phase 1
    t_start = time.perf_counter()
    if not (args.quick or args.trajectory_only or args.ingest_only
            or args.domain_only or args.runtime_only or args.driver_only
            or args.overload_only or args.qserve_only
            or args.jobsurface_only or args.dag_only or args.mesh_only
            or args.partition_only or args.multihost_only or args.x64_only):
        threads = start_twins()
        print(f"host: {os.cpu_count()} CPUs; {threads} torch threads here, "
              f"{TWIN_WORKERS} CPU-twin workers of {TWIN_THREADS}")
    card = card_line()
    dev = torch.device("cuda", 0)
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # Phase 2
    t0 = time.perf_counter()
    kernels.build()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s (nvcc, "
          f"{len(kernels.SOURCES)} sources in parallel) [{card}]")
    for name, log in kernels.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}")

    wf = WireFormat.for_grid(UniformGrid(**BEIJING))
    t0 = time.perf_counter()
    panes = headline_panes(wf)
    print(f"data: {len(panes)} panes x {SLIDE} points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")

    if args.trajectory_only or args.ingest_only or args.domain_only \
            or args.runtime_only or args.driver_only or args.overload_only \
            or args.qserve_only or args.jobsurface_only or args.dag_only \
            or args.mesh_only or args.partition_only or args.multihost_only \
            or args.x64_only:
        if args.trajectory_only:
            run_trajectory_phases(dev, card)
        if args.ingest_only:
            run_ingest_phases(card)
        if args.domain_only:
            run_domain_phases(card)
        if args.runtime_only:
            check_runtime(card, panes, wf)
        if args.driver_only:
            check_driver(card, panes, wf)
        if args.overload_only:
            check_overload(card, panes, wf)
        if args.qserve_only:
            check_qserve(card)
        if args.jobsurface_only:
            check_jobsurface(card, panes, wf)
        if args.dag_only:
            check_dag(card)
        if args.mesh_only:
            check_mesh(card)
        if args.partition_only:
            check_partition(card)
        if args.multihost_only:
            check_multihost(card)
        if args.x64_only:
            check_x64(dev, card)
        print(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s "
              f"[{card}]")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0


    # Phases 3-4
    err_b1 = check_digest(dev, wf, panes, card)
    err_b2, codec_args = check_codec(dev, panes, card)
    # Phase 7
    err_b3, join_planes_, join_sides = check_join(dev, card)
    # Phase 11
    err_b4, b4_inputs = check_polyline(dev, card)
    if args.quick:
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # Phase 5: the main path, three ways, each against its CPU twin.
    launches = {"wire_digest": 0, "wire_codec_decode": 0}
    n_points = sum(p.shape[1] for p in panes)
    for mode in ("sync", "pipelined", "pipelined_delta"):
        wire_digest.launches = 0
        wc.decode_wire_pane.launches = 0
        got, secs, kinds = run_path("cuda", mode, panes, wf)
        run_launches = (wire_digest.launches, wc.decode_wire_pane.launches)
        launches["wire_digest"] += run_launches[0]
        launches["wire_codec_decode"] += run_launches[1]
        want, cpu_secs, _ = run_path("cpu", mode, panes, wf)
        check_windows(got, want, mode)
        if kinds[0] != "cuda" or run_launches[0] < len(panes):
            raise AssertionError(f"{mode}: digest kernel not on the path")
        if mode == "pipelined_delta" and (
                kinds[1] != "cuda" or run_launches[1] < len(panes)):
            raise AssertionError("codec kernel not on the delta path")
        print(f"e2e {mode}: {len(got)} windows, {n_points} points in "
              f"{secs:.6f} s = {n_points / secs:.1f} points/s; launches "
              f"wire_digest={run_launches[0]} "
              f"wire_codec_decode={run_launches[1]}; windows equal the CPU "
              f"plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

    profile_run(lambda: run_path("cuda", "sync", panes, wf), card)

    # Phase 6: kernel times at the headline shape.
    from spatialflink_tpu_torch.ops.compaction import wire_pane_bucket

    nb = wire_pane_bucket(SLIDE)
    wire = torch.from_numpy(np.concatenate(
        [panes[2], np.zeros((3, nb - SLIDE), np.uint16)], axis=1)).to(dev)
    q = np.float32(QUERY)
    b1 = (wire, SLIDE, q, wf.scale, wf.origin, RADIUS, NUM_SEGMENTS)
    b1_ms, b1_call = time_ms(lambda: wire_digest_cuda(*b1))
    b1_plain, _ = time_ms(lambda: wire_digest_plain(*b1))
    b1_bound, b1_by = bound_ms(6 * SLIDE + 8 * NUM_SEGMENTS + 4, 11 * SLIDE)
    _, _, bx, by, bo, _, _ = codec_args
    used_words = sum((SLIDE * b + 31) // 32 for b in (bx, by, bo))
    b2_ms, b2_call = time_ms(lambda: wc.decode_wire_pane_cuda(
        *codec_args, n=nb, num_segments=NUM_SEGMENTS))
    b2_plain, _ = time_ms(lambda: wc.decode_wire_pane_plain(
        *codec_args, n=nb, num_segments=NUM_SEGMENTS))
    b2_bound, b2_by = bound_ms(
        4 * used_words + 6 * nb + 8 * NUM_SEGMENTS, 40 * nb)
    per_call = {
        "wire_digest": launches_per_call(lambda: wire_digest_cuda(*b1)),
        "wire_codec_decode": launches_per_call(
            lambda: wc.decode_wire_pane_cuda(*codec_args, n=nb,
                                             num_segments=NUM_SEGMENTS)),
    }
    for name, ms, call, plain, bnd, by_ in (
            ("wire_digest", b1_ms, b1_call, b1_plain, b1_bound, b1_by),
            ("wire_codec_decode", b2_ms, b2_call, b2_plain, b2_bound,
             b2_by)):
        kern, mems = per_call[name]
        print(f"time {name}: kernel {ms:.6f} ms device ({call:.6f} ms per "
              f"call with its launch), {kern:g} kernel launches and "
              f"{mems:g} memsets per call, plain PyTorch {plain:.6f} ms, "
              f"bound {bnd:.6f} ms ({by_}), medians of {REPEATS} calls at "
              f"the headline shape [{card}]")
        if kern > 1 or mems > 0:
            raise AssertionError(f"{name} takes {kern:g} kernel launches and "
                                 f"{mems:g} memsets a call")
    floor_ms, floor_call = time_ms(lambda: torch.cuda._sleep(1))
    print(f"time floor: one near-empty kernel (torch.cuda._sleep(1)) "
          f"{floor_ms:.6f} ms device ({floor_call:.6f} ms per call), the "
          f"same method [{card}]")

    # Phase 8: the join's main path, run_soa at full width, against its
    # CPU twin.
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract,
        join_extract_cuda,
        join_extract_plain,
    )

    t0 = time.perf_counter()
    chunks = (soa_join_chunks(1), soa_join_chunks(2))
    print(f"data: 2 x {JOIN_WINDOWS} x {JOIN_WIN} join points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    n_join = 2 * JOIN_WINDOWS * JOIN_WIN
    join_extract.launches = 0
    soa_got, secs = run_soa_path("cuda", chunks)
    soa_launches = join_extract.launches
    if soa_launches < JOIN_WINDOWS:
        raise AssertionError(f"run_soa: {soa_launches} B3 launches")
    print(f"e2e run_soa: {len(soa_got)} windows, pairs per window "
          f"{[w[5] for w in soa_got]}, {n_join} points in {secs:.6f} s = "
          f"{n_join / secs:.1f} points/s; launches join_extract="
          f"{soa_launches}; held against the CPU plain run [{card}]")

    def held(got=soa_got, chunks=chunks):
        want, cpu_secs = twin("run_soa", chunks)
        check_soa_join(got, want)
        print(f"exact run_soa: all {len(got)} windows equal the CPU plain "
              f"run ({cpu_secs:.3f} s on the host CPU) [{card}]")
    later(held)

    # Phase 9: run on Point objects, two query types, against the CPU.
    t0 = time.perf_counter()
    streams = join_objects()
    print(f"data: 2 x {len(streams[0])} Point objects in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")
    obj_launches = 0
    for qt in ("WindowBased", "RealTimeNaive"):
        join_extract.launches = 0
        pairs, wins, o_secs = run_objects("cuda", qt, streams)
        run_launches = join_extract.launches
        obj_launches += run_launches
        c_pairs, c_wins, c_secs = run_objects("cpu", qt, streams)
        if pairs != c_pairs or wins != c_wins or not pairs:
            raise AssertionError(f"run {qt}: differs from the CPU run")
        if qt == "WindowBased" and run_launches < JOIN_OBJ_WINDOWS:
            raise AssertionError(f"run {qt}: {run_launches} B3 launches")
        print(f"e2e run {qt}: {len(wins)} windows, "
              f"{sum(pairs.values())} pairs in {o_secs:.6f} s; launches "
              f"join_extract={run_launches}; equal to the CPU run "
              f"({c_secs:.3f} s) [{card}]")

    profile_run(lambda: run_soa_path("cuda", chunks), card, "run_soa")
    from spatialflink_tpu_torch.operators import QueryConfiguration
    from spatialflink_tpu_torch.operators.base import soa_point_batches

    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    t0 = time.perf_counter()
    for side in chunks:
        for _ in soa_point_batches(UniformGrid(**BEIJING), side, conf):
            pass
    asm_secs = time.perf_counter() - t0
    print(f"host SoA assembly alone (windows, cells, centring, padding) of "
          f"both streams: {asm_secs:.6f} s, {100 * asm_secs / secs:.1f}% of "
          f"the run_soa wall above [{card}]")

    # Phase 10: B3's time at the join's full shape.
    b3 = (*join_planes_, BEIJING["num_partitions"], 1, JOIN_R,
          JOIN_MAX_PAIRS)
    b3_ms, b3_call = time_ms(lambda: join_extract_cuda(*b3))
    b3_plain, _ = time_ms(lambda: join_extract_plain(*b3))
    pair_tests = join_candidate_pairs(UniformGrid(**BEIJING), *join_sides)
    b3_bytes = sum(t.numel() * t.element_size() for t in join_planes_) \
        + 12 * JOIN_MAX_PAIRS + 4
    b3_bound, b3_by = bound_ms(b3_bytes, 6 * pair_tests)
    b3_kernels, b3_memsets = launches_per_call(lambda: join_extract_cuda(*b3))
    print(f"time join_extract: kernel {b3_ms:.6f} ms device ({b3_call:.6f} "
          f"ms per call with its launches), {b3_kernels:g} kernel launches and "
          f"{b3_memsets:g} memsets per call, plain PyTorch {b3_plain:.6f} ms, "
          f"bound {b3_bound:.6f} ms ({b3_by}: {b3_bytes} B, {pair_tests} "
          f"candidate pair tests x 6 operations), medians of {REPEATS} "
          f"calls at the join's full shape [{card}]")
    if b3_kernels > 2:
        raise AssertionError(f"B3 takes {b3_kernels} kernel launches a call")

    # Phases 12-13
    b4_launches, (b4g_ms, b4g_plain, b4g_bound, b4g_by) = check_range(
        dev, card, b4_inputs)
    # Phases 14-16: the geometry-stream range path and the kNN run.
    geo_launches, geo_chunks, geo_secs = check_geometry(card)
    knn_launches, knn_walls, knn_stream = check_knn_run(card)
    b4_launches += geo_launches + knn_launches
    b4_shapes = time_geometry(dev, card, geo_chunks, geo_secs, knn_stream,
                              knn_walls)
    # Phases 17-19: geometry-stream kNN and the pane-carry / SoA kNN paths.
    knn_geo_launches, knn_pane_launches, knn_shapes = run_new_phases(
        dev, card, geo_chunks)
    b4_launches += knn_geo_launches + knn_pane_launches
    b4_shapes.update(knn_shapes)
    # Phases 20-22: the geometry joins and the pane-carry point join.
    pg_launches, gg_launches, qp_launches, join_shapes = run_join_phases(
        dev, card, geo_chunks)
    b4_launches += pg_launches + gg_launches
    b4_shapes.update(join_shapes)
    settle_twins()
    # Phases 23-26: the trajectory layer (tJoin through B3, the pane-carry
    # tJoin).
    tj_launches, tj_row = run_trajectory_phases(dev, card)
    settle_twins()
    # Phases 27-28: ingest (serde, sources, shapefile, CRS) feeding the
    # range operators through B4, and the apps.
    ingest_launches = run_ingest_phases(card)
    b4_launches += ingest_launches
    settle_twins()
    # Phases 29-30: the SNCB and MobilityNebula layers (the zone test on
    # the card) and the op counters over the range operators through B4.
    domain_launches, _ = run_domain_phases(card)
    b4_launches += domain_launches
    settle_twins()
    # Phase 31: the runtime layer on the card, through all four kernels.
    rt = check_runtime(card, panes, wf)
    settle_twins()
    # Phase 32: the dataflow driver, checkpoints and exactly-once egress
    # (B1, B3, B4).
    drv = check_driver(card, panes, wf)
    # Phase 33: overload control and the SLO engine (B1, B3, B4).
    ov = check_overload(card, panes, wf)
    # Phase 34: standing-query serving (plain PyTorch; no hand kernel).
    check_qserve(card)
    # Phase 35: the native engines and Kafka into the headline program
    # (B1).
    js = check_jobsurface(card, panes, wf)
    # Phase 38's child processes start here, to overlap phases 36-37.
    partition_children = start_partition_children("cuda")
    # Phase 36: the composed SNCB DAG and the StreamingJob entry point
    # (B3 through option 5's query_panes).
    t0 = time.perf_counter()
    dg = check_dag(card)
    print(f"phase walls: 36 {time.perf_counter() - t0:.3f} s [{card}]")
    # Phase 37: the mesh layer, four shards on the card (B3, B4), with
    # 36b's smoke's mesh child as 37f's.
    mesh_l = check_mesh(card, smoke_line=dg["mesh_line"])
    # Phase 38: the grid-partitioned halo layer and multi-process runs
    # (plain PyTorch; no hand kernel).
    check_partition(card, children=partition_children)
    # Phase 39: the four gathering mesh programs on two gloo ranks of the
    # card, after phase 38's children have ended (plain PyTorch; no hand
    # kernel).
    check_multihost(card)
    # Phase 40: the float64 mode, B3 and B4 in float64 and the slice's
    # x64 run_soa paths against the CPU.
    x64_rows = check_x64(dev, card)
    # The comparisons with the CPU twins of the background processes.
    t0 = time.perf_counter()
    run_later()
    print(f"phase walls: CPU twins' comparisons {time.perf_counter() - t0:.3f}"
          f" s [{card}]")
    record = {"kernels": [
        {"name": "wire_digest", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_digest.cu",
         "replaces": "spatialflink_tpu/ops/pallas_digest.py:48",
         "launches": launches["wire_digest"] + rt["wire_digest"]
         + drv["wire_digest"] + ov["wire_digest"] + js["wire_digest"],
         "launches_runtime": rt["wire_digest"],
         "launches_driver": drv["wire_digest"],
         "launches_overload": ov["wire_digest"],
         "launches_jobsurface": js["wire_digest"], "max_abs_err": err_b1,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None,
         "kernels_per_call": per_call["wire_digest"][0],
         "memsets_per_call": per_call["wire_digest"][1]},
        {"name": "wire_codec_decode", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_codec.cu",
         "replaces": "spatialflink_tpu/ops/wire_codec.py:361",
         "launches": launches["wire_codec_decode"]
         + rt["wire_codec_decode"],
         "launches_runtime": rt["wire_codec_decode"], "max_abs_err": err_b2,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None,
         "kernels_per_call": per_call["wire_codec_decode"][0],
         "memsets_per_call": per_call["wire_codec_decode"][1]},
        {"name": "join_extract", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/join_extract.cu",
         "replaces": "spatialflink_tpu/ops/pallas_join.py:41",
         "launches": soa_launches + obj_launches + qp_launches
         + tj_launches + rt["join_extract"] + drv["join_extract"]
         + ov["join_extract"] + dg["join_extract"]
         + mesh_l["join_extract"],
         "launches_runtime": rt["join_extract"],
         "launches_mesh": mesh_l["join_extract"],
         "launches_dag": dg["join_extract"],
         "launches_driver": drv["join_extract"],
         "launches_overload": ov["join_extract"],
         "max_abs_err": err_b3,
         "ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None,
         "launches_query_panes": qp_launches,
         "launches_tjoin": tj_launches,
         "shapes": {"tjoin_window": tj_row}},
        {"name": "polyline_min_dist", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/polyline_min_dist.cu",
         "replaces": "spatialflink_tpu/ops/pallas_kernels.py:39",
         "launches": b4_launches + rt["polyline_min_dist"]
         + drv["polyline_min_dist"] + ov["polyline_min_dist"]
         + mesh_l["polyline_min_dist"],
         "launches_runtime": rt["polyline_min_dist"],
         "launches_mesh": mesh_l["polyline_min_dist"],
         "launches_driver": drv["polyline_min_dist"],
         "launches_overload": ov["polyline_min_dist"],
         "max_abs_err": err_b4,
         "ms": b4g_ms, "plain_ms": b4g_plain, "bound_ms": b4g_bound,
         "bound_by": b4g_by, "library_ms": None,
         "launches_geometry_range": geo_launches,
         "launches_knn_run": knn_launches,
         "launches_knn_geometry": knn_geo_launches,
         "launches_knn_panes": knn_pane_launches,
         "launches_join_point_geometry": pg_launches,
         "launches_join_geometry_geometry": gg_launches,
         "launches_ingest": ingest_launches,
         "launches_domain": domain_launches,
         "shapes": b4_shapes},
        x64_rows["join_extract_f64"],
        x64_rows["polyline_min_dist_f64"],
    ]}
    print("CPU twins in background processes (seconds of the CPU run, "
          "seconds this process waited for it): "
          + ", ".join(f"{k} {v[0]:.3f} / {v[1]:.3f}"
                      for k, v in twin_log.items())
          + f"; {TWIN_WORKERS} workers of {TWIN_THREADS} threads [{card}]")
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
