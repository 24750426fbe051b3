#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spatialflink_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, full sizes
    python3 chip_smoke.py --quick    # phases 1-4, 7 and 11: build and check
    python3 chip_smoke.py --trajectory-only   # phases 1-2 and 23-26
    python3 chip_smoke.py --ingest-only       # phases 1-2 and 27-28

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
   262,144 points, 1,000 polygons, the bbox-pruned path) through B4, each
   window equal to the same operator run on the CPU, and B4's launch
   count up by at least 10; then, at 2–3 windows each and against the
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
   each window equal to the same operator run on the CPU (starts, ends,
   kept indices and oids, distance bits) and B4's launch count up by at
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
21. run ``PolygonPolygonJoinQuery.run_soa`` on phase 14's stream (4 ×
   131,072 polygons) ⋈ config 3's 1,000 polygons at r = 0.002, each
   window equal to the CPU run and B4 up by at least 2 a window; then, at
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
   plain PyTorch) at the JAX suite's tjoin_panes_10s_10ms, uncut (10 s
   windows by 10 ms, ppw 1,000; 2,000 panes of 1,024 points a side from
   seed 23; 64 ids, cap_w 256, pair_sel 16, r = 0.001, grid n = 100):
   2,999 windows, one scan with every overflow counter 0, the capacity
   plan printed beside the measured occupancy; time the host steps, the
   engine's steady state alone (a warm scan of 1,000 slides, then 1,000
   timed) and its parts a slide, with its launches a slide; a profiler
   trace of the whole operator run (the device's idle share) and of 40
   steady slides (the kernel rows); then hold the card's windows equal
   (ids in order, distance bits) to the engine's CPU run of the stream
   cut to its
   first 1,024 panes over every window ending before pane 1,024, to
   ``run_soa`` through B3 at the windows starting 0 and 10,000 ms (10 s
   tumbling), and to the segmented pipelined scan over every window;
27. read the range suite's config 3 back from files through the port's
   ingest: its 1,000 polygons written as GeoJSON lines, WKT lines and a
   shapefile and read back (``polygon_stream``, ``read_shapefile``; the
   GeoJSON rings bit-equal to the generated ones, the shapefile's
   bit-equal reversed, as it stores exteriors clockwise), its 10 x
   262,144 points written as ``oid,ts,x,y`` CSV in ``to_csv_point``'s
   format and fed through ``csv_chunk_source`` and a numpy chunk parser
   into ``PointPolygonRangeQuery.run_soa`` on the card against the
   GeoJSON-read polygons (B4): every window bit-equal to the run fed the
   arrays directly, the first 2 to the CPU run; the rate from file to
   fetched results, the seconds inside the parser, and the device's idle
   share, all of one traced run; the GeoJSON-read polygons as a stream
   through ``PolygonPolygonRangeQuery.run`` against 32 shapefile-read
   ones, equal to the CPU run; then ``csv_source`` with
   ``parse_csv_point`` (2 x 20,000 ``Point``s, bad lines skipped) into
   ``run`` against the WKT-read polygons, and
   ``SyntheticGpsSource`` at its defaults (600,000 events) into ``run``
   against 32 polygons, each equal to its CPU run; ``utm_forward``,
   ``utm_inverse`` and ``haversine_distance`` on 1,048,576 float64 points
   on the card within rtol 1e-12 of the host runs and a round trip within
   1e-11 deg;
28. run ``check_in_query_soa`` on the card (1,048,576 events, 10,000
   users, 256 rooms, missed doors of both directions) equal to the host
   walk ``check_in_query``; ``cell_stay_time_soa`` on the synthetic
   stream (10 s by 5 s, config 3's grid) equal to its CPU run (int64);
   ``sliding_aggregate`` (10 s by 10 ms, host numpy) against a
   brute-force loop over its first 50 windows.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Every number printed was measured in
this run on the card named beside it.
"""

from __future__ import annotations

import argparse
import functools
import json
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
# (bench_suite.py:1071-1241), uncut: 10 s windows by 10 ms (ppw 1,000),
# 1,024 points a side a pane over 2,000 panes (ppw to fill the window,
# then 1,000 steady), positions uniform on the Beijing extent and ids
# uniform over 64 from seed 23, cap_w 256, pair_sel 16, r = 0.001, grid
# n = 100 (one candidate layer: 9 cells probed a point). The CPU twin
# runs the engine on the first TP_CPU_PANES panes: the windows ending
# before that pane, 25 of them full (the CPU takes ~25-40 ms a slide at
# this width, so the whole stream's 2,999 would take minutes).
TP_PPW = 1000
TP_SLIDE_MS = 10
TP_PANE_PTS = 1024
TP_STEADY = 1000
TP_PANES = TP_PPW + TP_STEADY
TP_IDS = 64
TP_CAP_W = 256
TP_PAIR_SEL = 16
TP_R = 0.001
TP_CPU_PANES = TP_PPW + 24
TP_WARM_PANES = 24
TP_PROFILE_SLIDES = 40
TP_REPS = 3
# Phases 27-28: ingest and the apps. Phase 27 reads config 3 back from
# files (phase 12's 1,000 polygons as GeoJSON lines, WKT lines and a
# shapefile; its 10 x 262,144 points as oid,ts,x,y CSV, oids over
# TR_IDS); the CPU twin of the CSV run_soa compares its first
# INGEST_CPU_WINDOWS windows (a cut: ~5 s a window on the host). The
# synthetic GPS source runs at its defaults (20,000 events/s for 30 s,
# 10 devices, seed 42) over the Beijing extent into
# PointPolygonRangeQuery.run against config 3's first SYN_QUERIES
# polygons, and feeds phase 28's stay time (10 s windows by 5 s, config
# 3's grid) and pane aggregates (10 s by 10 ms, brute force on the first
# AGG_BRUTE_WINDOWS windows). CRS: CRS_POINTS float64 lon/lat points over
# Belgium from seed 43. Check-in: CHECKIN_EVENTS events from seed 44,
# each with probability CHECKIN_REPEAT its user's previous door again (a
# missed event of either direction).
INGEST_CPU_WINDOWS = 2
SYN_QUERIES = 32
CRS_POINTS = 1 << 20
BELGIUM = (2.5, 6.4, 49.5, 51.5)
CHECKIN_EVENTS = 1 << 20
CHECKIN_USERS = 10_000
CHECKIN_ROOMS = 256
CHECKIN_REPEAT = 0.2
STAY_WINDOW_S, STAY_SLIDE_S = 10, 5
AGG_SIZE_MS, AGG_SLIDE_MS = 10_000, 10
AGG_BRUTE_WINDOWS = 50

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
    return a.shape == b.shape and bool(torch.equal(a, b))


def max_abs_err(a, b) -> float:
    """Max |a - b| on the tensors' device; float32 entries at FLT_MAX in
    both (no valid edge, no candidate) are left out."""
    import torch

    if a.dtype == torch.float32:
        live = (a < torch.finfo(torch.float32).max) | \
            (b < torch.finfo(torch.float32).max)
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


def time_ms(fn):
    """(device ms, call ms): medians over REPEATS calls of ``fn`` after
    two warm-up calls.

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
              torch.cuda.Event(enable_timing=True)) for _ in range(REPEATS)]
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


def trace_busy(run):
    """(wall s, device busy s, kernels) of one ``run()`` under a
    torch.profiler trace of CUDA activity. Busy time is the union of the
    device-side intervals, read from the raw trace events: for a trace
    of the whole pane-carry tJoin (~670,000 kernels) that is far cheaper
    than building the profiler's event objects."""
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
    spans.sort()
    busy_ns, end = 0, -1
    for lo, hi in spans:
        if hi > end:
            busy_ns += hi - max(lo, end)
            end = hi
    return wall, busy_ns / 1e9, kernels


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = nops / SCALAR_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    want, cpu_secs, cpu_op = run_range("cpu", PointPolygonRangeQuery,
                                       r_chunks, polys, RANGE_R)
    hits = check_range_windows(got, want, "range run_soa", RANGE_R)
    if b4_launches < RANGE_WINDOWS or len(got) != RANGE_WINDOWS \
            or path != "pruned" or min(hits) == 0:
        raise AssertionError(f"range run_soa: {len(got)} windows, path "
                             f"{path}, {b4_launches} B4 launches")
    if (op._ncand,) != (cpu_op._ncand,):
        raise AssertionError("range run_soa: candidate counts differ")
    print(f"e2e range run_soa (config 3, {path} path, cand {op._ncand}): "
          f"{len(got)} windows, matches per window {hits}, {n_range} points "
          f"in {r_secs:.6f} s = {n_range / r_secs:.1f} points/s; launches "
          f"polyline_min_dist={b4_launches}; {len(want)} windows equal the "
          f"CPU plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

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
    want, cpu_secs = run_geometry("cpu", ops.PolygonPolygonRangeQuery,
                                  chunks, polys)
    hits = check_geometry_windows(got, want, "geometry run_soa")
    if b4_launches < 2 * GEOM_WINDOWS or min(hits) == 0:
        raise AssertionError(f"geometry run_soa: {b4_launches} B4 launches, "
                             f"matches {hits}")
    n = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e geometry range run_soa (PolygonPolygon, {GEOM_QUERIES} "
          f"polygons, r={GEOM_R}): {len(got)} windows, matches per window "
          f"{hits}, {n} objects in {secs:.6f} s = {n / secs:.1f} objects/s; "
          f"launches polyline_min_dist={b4_launches}; windows equal the CPU "
          f"plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

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


def multi_stream(n_win, per_win):
    """The multi-query config's points (bench_suite.py:503-515: positions
    and oids from seed 29) as ``Point`` objects, ``per_win`` a one-second
    window, and its 64 query points (seed 23)."""
    from spatialflink_tpu_torch.models.objects import Point

    n = n_win * per_win
    rng = np.random.default_rng(29)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1).astype(np.float32).astype(np.float64)
    oid = rng.integers(0, NUM_SEGMENTS, n)
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_win
    pts = [Point(obj_id=f"o{i}", timestamp=int(t), x=x, y=y)
           for i, t, (x, y) in zip(oid.tolist(), ts.tolist(), xy.tolist())]
    rq = np.random.default_rng(23)
    qxy = np.stack([rq.uniform(115.6, 117.5, MULTI_Q),
                    rq.uniform(39.7, 41.0, MULTI_Q)], axis=1)
    qxy = qxy.astype(np.float32).astype(np.float64)
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
    want, cpu_secs, _ = run_join_soa("cpu", ops.PointPolygonJoinQuery, left,
                                     right, PG_R)
    pairs = check_join_windows(got, want, "point-polygon join run_soa",
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
          f"{op._pair_cap}, budget {op._geom_max_pairs}; windows equal the "
          f"CPU plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

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
    """Phase 21: ``PolygonPolygonJoinQuery.run_soa`` on phase 14's stream
    against config 3's 1,000 polygons, the other classes, approximate
    mode, the multi-ring stream and ``run`` at a cut depth, each against
    its CPU twin. Returns (B4 launches, seconds and operator of the
    full-width run, its inputs)."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist

    polys = range_polygons()
    right = polygon_chunks(polys, GEOM_WINDOWS)
    polyline_min_dist.launches = 0
    got, secs, op = run_join_soa(gpu, ops.PolygonPolygonJoinQuery,
                                 geo_chunks, right, PG_R)
    b4_launches = polyline_min_dist.launches
    want, cpu_secs, _ = run_join_soa("cpu", ops.PolygonPolygonJoinQuery,
                                     geo_chunks, right, PG_R)
    pairs = check_join_windows(got, want, "polygon-polygon join run_soa",
                               PG_R)
    if len(got) != GEOM_WINDOWS or b4_launches < 2 * GEOM_WINDOWS \
            or min(pairs) == 0:
        raise AssertionError(f"polygon-polygon join run_soa: pairs {pairs}, "
                             f"{b4_launches} B4 launches")
    n = GEOM_WINDOWS * GEOM_WIN
    print(f"e2e polygon-polygon join run_soa ({GEOM_WINDOWS} x {GEOM_WIN} "
          f"polygons of phase 14 ⋈ config 3's {len(polys)} polygons, "
          f"r={PG_R}): pairs per window {pairs}, {n} objects in "
          f"{secs:.6f} s = {n / secs:.1f} objects/s; launches "
          f"polyline_min_dist={b4_launches}; cand {op._cand}, pair_cap "
          f"{op._pair_cap}, budget {op._geom_max_pairs}; windows equal the "
          f"CPU plain run ({cpu_secs:.3f} s on the host CPU) [{card}]")

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


def check_join_panes(card, gpu="cuda"):
    """``PointPointJoinQuery.query_panes`` at a cut depth: each window
    equal to its CPU run in order and to ``run`` as a multiset, B3
    launched once for each new block of two non-empty panes. Returns
    (B3 launches, points/s)."""
    import collections

    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    n = QPJ_PANES * QPJ_PANE_PTS
    streams = []
    for side, seed in (("l", 3), ("r", 4)):
        xy = join_stream(n, seed).astype(np.float64)
        ts = (np.arange(n, dtype=np.int64) * 1000) // QPJ_PANE_PTS
        streams.append([Point(obj_id=f"{side}{i}", timestamp=int(t),
                              x=float(x), y=float(y))
                        for i, (t, (x, y)) in enumerate(zip(ts, xy))])
    join_extract.launches = 0
    after = []
    got, secs = run_query_panes(gpu, streams, launches=after)
    launches = join_extract.launches
    cpu, c_secs = run_query_panes("cpu", streams)
    run, _ = run_query_panes(gpu, streams, method="run")
    if got != cpu:
        raise AssertionError("query_panes differs from its CPU run")
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
          f"blocks), {launches} in all; equal to the CPU run "
          f"({c_secs:.3f} s) in order and to run as multisets [{card}]")
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
          f"{1e3 * gg_secs / GEOM_WINDOWS:.6f} ms [{card}]")
    print(f"e2e rates: point-polygon join run_soa "
          f"{PG_WINDOWS * PG_WIN / pg_secs:.1f} points/s, polygon-polygon "
          f"join run_soa {GEOM_WINDOWS * GEOM_WIN / gg_secs:.1f} objects/s, "
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
    want, cpu_secs, _ = run_tjoin_soa("cpu", chunks, slide_s=TJ_WINDOW_S)
    by_start = {g[0]: g for g in got}
    n_windows = TJ_SLIDES + TJ_WINDOW_S - 1
    if len(got) != n_windows or launches < n_windows \
            or tuple(w[0] for w in want) != TJ_CPU_STARTS:
        raise AssertionError(f"tJoin run_soa: {len(got)} windows, {launches} "
                             f"B3 launches, CPU windows "
                             f"{[w[0] for w in want]}")
    for w in want:
        g = by_start[w[0]]
        if g[:2] != w[:2] or g[5:] != w[5:] or not all(
                np.array_equal(a, b) for a, b in zip(g[2:5], w[2:5])):
            raise AssertionError(f"tJoin run_soa: window {w[:2]} differs "
                                 f"from the CPU run")
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
          f"starting {list(TJ_CPU_STARTS)} ms (the first, a middle and the "
          f"last full window) equal the CPU plain run ({cpu_secs:.3f} s on "
          f"the host CPU for those 3) [{card}]")

    pts = [traj_points(c, 2 * T_CUT, T_CUT, side)
           for c, side in zip(chunks, ("l", "r"))]
    obj_launches = 0
    for method, streams in (("run", pts), ("run_single", pts[:1])):
        join_extract.launches = 0
        g, o_secs = run_objects_family(gpu, ops.PointPointTJoinQuery, method,
                                       streams, TJ_R, op_kw={"cap": TJ_CAP})
        launched = join_extract.launches
        obj_launches += launched
        w, c_secs = run_objects_family("cpu", ops.PointPointTJoinQuery,
                                       method, streams, TJ_R,
                                       op_kw={"cap": TJ_CAP})
        if g != w or len(g) != 2 or launched < 2 or not all(x[3] for x in g):
            raise AssertionError(
                f"tJoin {method}: equal to the CPU run {g == w}, pairs "
                f"{[len(x[3]) for x in g]}, {launched} B3 launches")
        print(f"e2e tJoin {method} (Point objects, 2 windows of {T_CUT} a "
              f"side): trajectory pairs {[len(x[3]) for x in g]} in "
              f"{o_secs:.6f} s; launches join_extract={launched}; equal to "
              f"the CPU run ({c_secs:.3f} s) [{card}]")
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
                       TS_WINDOW_MS, TS_SLIDE_MS, device=gpu)
    t0 = time.perf_counter()
    got = traj_stats_sliding(*args, device=gpu)
    secs = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = traj_stats_sliding(*args, device="cpu")
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
    profile_run(lambda: traj_stats_sliding(*args, device="cuda"), card,
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


def check_traj_families(card, gpu="cuda"):
    """Phase 25: tRange ``run_soa`` on config 3's stream against 32
    polygons, tKnn, tAggregate (SUM) and tFilter ``run_soa`` on config
    2's stream; the other aggregates, the inactive threshold and ``run``
    on ``Point``s at 2 x 20,000; each against its CPU run. Returns the
    e2e rates."""
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point

    import torch

    def soa(device, cls, chunks, *args, window=1.0, slide=1.0, **op_kw):
        op = cls(ops.QueryConfiguration(window_size=window,
                                        slide_step=slide),
                 UniformGrid(**BEIJING), device=device, **op_kw)
        t0 = time.perf_counter()
        out = list(op.run_soa(chunks, *args))
        if op.device.type == "cuda":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(a, b):
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if hasattr(a, "cells"):
            return (a.start, a.end, a.window_count, a.cells) == \
                (b.start, b.end, b.window_count, b.cells)
        return a == b

    def case(label, cls, chunks, *args, n, **kw):
        g, secs = soa(gpu, cls, chunks, *args, **kw)
        w, c_secs = soa("cpu", cls, chunks, *args, **kw)
        if not same(g, w) or not g:
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
        aggregate="SUM")
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


def run_tjoin_panes(device, chunks):
    """``PointPointTJoinQuery.run_soa_panes`` at phase 26's configuration;
    returns the windows, seconds (the device synchronised) and the
    operator."""
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
                                cap_w=TP_CAP_W, pair_sel=TP_PAIR_SEL))
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

    # 1. The operator end to end on the card, after a run on the stream's
    # first TP_WARM_PANES panes (every slide is full width: it takes
    # the one-time costs of the first launches out of the timed run).
    cut = [[{k: v[:TP_WARM_PANES * TP_PANE_PTS]
             for k, v in side[0].items()}] for side in chunks]
    cut_got, cut_secs, _ = run_tjoin_panes(gpu, cut)
    got, secs, op = run_tjoin_panes(gpu, chunks)
    if not all(same_window(a, b) for a, b in zip(
            cut_got[:TP_WARM_PANES], got)):
        raise AssertionError("run_soa_panes: the windows of a cut stream "
                             "differ from the whole stream's")
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
          f"{n_pts / secs:.1f} points/s, every window fetched (after a "
          f"first run on {TP_WARM_PANES} panes a side, "
          f"{len(cut_got)} windows in {cut_secs:.3f} s) [{card}]")
    # The device's idle share over the whole operator run, traced.
    tr_wall, tr_busy, tr_kern = trace_busy(
        lambda: run_tjoin_panes(gpu, chunks))
    print(f"profile e2e run_soa_panes (the whole run, CUDA activity): wall "
          f"{tr_wall:.6f} s traced ({secs:.6f} s untraced), device busy "
          f"{tr_busy:.6f} s ({100 * tr_busy / tr_wall:.1f}%, idle "
          f"{100 - 100 * tr_busy / tr_wall:.1f}%), {tr_kern} kernels = "
          f"{tr_kern / n_slides:.2f} a slide [{card}]")

    # Its host steps, timed alone.
    cols = []
    for side in chunks:
        cols.append([np.concatenate([c[k] for c in side])
                     for k in ("ts", "x", "y", "oid")])
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
        *radius_args[:-1], cpu_cap)
    cpu_secs = time.perf_counter() - t0
    cpu_counters = [int(cc.cap_overflow), int(cc.sel_overflow),
                    int(cc.cmp_overflow)]
    cw = cw.numpy()
    if cpu_counters != [0, 0, 0] or not all(
            same_window(pane_window(s, cw[s]), got[s]) for s in range(m)):
        raise AssertionError(f"run_soa_panes: the card's windows differ from "
                             f"the CPU run of the first {m} panes "
                             f"(counters {cpu_counters})")

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

    # 3c. The segmented pipelined scan against the one scan.
    pipeline.install(pipeline.PipelinePolicy())
    try:
        seg, seg_secs, _ = run_tjoin_panes(gpu, chunks)
    finally:
        pipeline.uninstall()
    if len(seg) != len(got) or not all(
            same_window(a, b) for a, b in zip(seg, got)):
        raise AssertionError("run_soa_panes: the segmented pipelined scan "
                             "differs from the one scan")
    print(f"exact run_soa_panes: the card's windows equal the engine's CPU "
          f"run of the first {m} panes over all {m} windows ending before "
          f"pane {m} ({m - TP_PPW + 1} full; {cpu_secs:.3f} s on the host "
          f"CPU, cap_c {cpu_cap}), run_soa through B3 at the windows "
          f"starting {starts} ms (10 s tumbling, cap {cap_c}, overflow 0, "
          f"pairs {[w[5] for w in soa]}, {soa_secs:.3f} s) and the segmented "
          f"pipelined scan over all {len(got)} windows ({seg_secs:.3f} s = "
          f"{n_pts / seg_secs:.1f} points/s); ids in order, distance bits "
          f"[{card}]")
    print(f"phase 26 wall: {time.perf_counter() - t_phase:.3f} s [{card}]")
    return secs


# ---------------------------------------------------------------------------
# Phases 27-28: ingest (serde, sources, shapefile, CRS) and the apps.


class CsvChunkParser:
    """``oid,ts,x,y`` lines → a SoA chunk, through numpy's text reader:
    the buffer-at-a-time parser ``csv_chunk_source`` is given here (the
    JAX package gives it its native parsers; the port has none)."""

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
        polyline_min_dist.launches = 0
        parser, got = TimedParser(CsvChunkParser()), []
        # One run, timed and traced: the wall, the device's idle share and
        # the seconds inside parse() all come from it.
        csv_ms, _ = profile_run(lambda: got.extend(op.run_soa(
            csv_chunk_source(csv_path, parser), from_geojson, RANGE_R)),
            card, "ingest CSV -> run_soa")
        csv_secs = csv_ms / 1e3
        csv_launches = polyline_min_dist.launches
        launches += csv_launches
        parsed = parser.chunks
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
              f"torch.profiler); inside parse() {parser.secs:.6f} s of it "
              f"({100 * parser.secs / csv_secs:.1f}% of the wall); the same "
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

    # The synthetic GPS source at its defaults into run.
    t0 = time.perf_counter()
    src = SyntheticGpsSource(BEIJING["min_x"], BEIJING["max_x"],
                             BEIJING["min_y"], BEIJING["max_y"])
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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-4 and 7 only (build and check the kernels)")
    ap.add_argument("--trajectory-only", action="store_true",
                    help="phases 1-2 and 23-26 only (build, then the "
                         "trajectory layer)")
    ap.add_argument("--ingest-only", action="store_true",
                    help="phases 1-2 and 27-28 only (build, then ingest "
                         "and the apps)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
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

    if args.trajectory_only or args.ingest_only:
        if args.trajectory_only:
            run_trajectory_phases(dev, card)
        if args.ingest_only:
            run_ingest_phases(card)
        print(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s "
              f"[{card}]")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    wf = WireFormat.for_grid(UniformGrid(**BEIJING))
    t0 = time.perf_counter()
    panes = headline_panes(wf)
    print(f"data: {len(panes)} panes x {SLIDE} points in "
          f"{time.perf_counter() - t0:.3f} s (host set-up)")

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
    got, secs = run_soa_path("cuda", chunks)
    soa_launches = join_extract.launches
    want, cpu_secs = run_soa_path("cpu", chunks)
    check_soa_join(got, want)
    if soa_launches < JOIN_WINDOWS:
        raise AssertionError(f"run_soa: {soa_launches} B3 launches")
    print(f"e2e run_soa: {len(got)} windows, pairs per window "
          f"{[w[5] for w in got]}, {n_join} points in {secs:.6f} s = "
          f"{n_join / secs:.1f} points/s; launches join_extract="
          f"{soa_launches}; windows equal the CPU plain run "
          f"({cpu_secs:.3f} s on the host CPU) [{card}]")

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
    # Phases 23-26: the trajectory layer (tJoin through B3, the pane-carry
    # tJoin).
    tj_launches, tj_row = run_trajectory_phases(dev, card)
    # Phases 27-28: ingest (serde, sources, shapefile, CRS) feeding the
    # range operators through B4, and the apps.
    ingest_launches = run_ingest_phases(card)
    b4_launches += ingest_launches
    record = {"kernels": [
        {"name": "wire_digest", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_digest.cu",
         "replaces": "spatialflink_tpu/ops/pallas_digest.py:48",
         "launches": launches["wire_digest"], "max_abs_err": err_b1,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None,
         "kernels_per_call": per_call["wire_digest"][0],
         "memsets_per_call": per_call["wire_digest"][1]},
        {"name": "wire_codec_decode", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_codec.cu",
         "replaces": "spatialflink_tpu/ops/wire_codec.py:361",
         "launches": launches["wire_codec_decode"], "max_abs_err": err_b2,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None,
         "kernels_per_call": per_call["wire_codec_decode"][0],
         "memsets_per_call": per_call["wire_codec_decode"][1]},
        {"name": "join_extract", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/join_extract.cu",
         "replaces": "spatialflink_tpu/ops/pallas_join.py:41",
         "launches": soa_launches + obj_launches + qp_launches
         + tj_launches,
         "max_abs_err": err_b3,
         "ms": b3_ms, "plain_ms": b3_plain, "bound_ms": b3_bound,
         "bound_by": b3_by, "library_ms": None,
         "launches_query_panes": qp_launches,
         "launches_tjoin": tj_launches,
         "shapes": {"tjoin_window": tj_row}},
        {"name": "polyline_min_dist", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/polyline_min_dist.cu",
         "replaces": "spatialflink_tpu/ops/pallas_kernels.py:39",
         "launches": b4_launches, "max_abs_err": err_b4,
         "ms": b4g_ms, "plain_ms": b4g_plain, "bound_ms": b4g_bound,
         "bound_by": b4g_by, "library_ms": None,
         "launches_geometry_range": geo_launches,
         "launches_knn_run": knn_launches,
         "launches_knn_geometry": knn_geo_launches,
         "launches_knn_panes": knn_pane_launches,
         "launches_join_point_geometry": pg_launches,
         "launches_join_geometry_geometry": gg_launches,
         "launches_ingest": ingest_launches,
         "shapes": b4_shapes},
    ]}
    print(f"chip_smoke wall: {time.perf_counter() - t_start:.3f} s [{card}]")
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
