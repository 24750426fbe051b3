#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``spatialflink_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # every phase, headline sizes
    python3 chip_smoke.py --quick    # phases 1-4 only: build and check

Phases, each of which raises (and so exits non-zero) on failure:

1. require a CUDA card; print its name and power limit (nvidia-smi);
2. build the hand kernels from ``spatialflink_tpu_torch/kernels/csrc``
   (one nvcc per source, in parallel) and print ptxas's report;
3. hold the wire-digest kernel (B1) bit-exact against its plain PyTorch
   version at the headline shape: a random pane, points exactly on the
   radius, many objects at equal distance, ``n_valid`` below the
   bucket, zero hits, and more than 16,384 hits;
4. hold the codec-decode kernel (B2) bit-exact against its plain version
   at every bit width 0..16 (word-straddling fields included) and on a
   delta-coded headline pane;
5. run ``PointPointKNNQuery.run_wire_panes`` at the headline width (1M
   window, 500k slide, 16,384 objects, k=50, r=0.05, Beijing extent, 21
   panes from numpy seed 42) three ways: synchronous, pipelined raw, and
   pipelined with the delta codec. Every window must equal the same
   operator run on the CPU through the plain versions (starts, ends,
   ``nv`` and ids exact, distances bit-equal) and fill its top-50, and
   both kernels' launch counts must have moved;
6. time each kernel (CUDA events, median of 30 launches at the headline
   shape) beside its bound and its plain version.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Every number printed was measured in
this run on the card named beside it.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

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

# H100 SXM peaks (NVIDIA data sheet): HBM rate, float32 outside the
# tensor cores (used for the kernels' 32-bit scalar operations).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
REPEATS = 30


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def same_bits(a, b) -> bool:
    """Bit-equality of two tensors (float distances compared as bits)."""
    import torch

    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a.cpu(), b.cpu()))


def max_abs_err(a, b) -> float:
    import torch

    a, b = a.cpu(), b.cpu()
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


def profile_run(run, card):
    """Device busy share and kernel time by name over one ``run()``
    (torch.profiler, CUDA activity)."""
    import torch
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

    rows = sorted(prof.key_averages(), key=dev_us, reverse=True)
    busy_us = sum(dev_us(e) for e in rows)
    print(f"profile sync run: wall {wall_us / 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%, idle "
          f"{100 - 100 * busy_us / wall_us:.1f}%) [{card}]")
    for e in rows[:8]:
        if dev_us(e) > 0:
            print(f"  {dev_us(e) / 1e3:.3f} ms device, {e.count} calls: "
                  f"{e.key[:90]}")


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

    def one(args, label):
        nonlocal err
        got = wc.decode_wire_pane_cuda(*args, n=nb,
                                       num_segments=NUM_SEGMENTS)
        want = wc.decode_wire_pane_plain(*args, n=nb,
                                         num_segments=NUM_SEGMENTS)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            err = max(err, max_abs_err(g.to(torch.int32),
                                       w.to(torch.int32)))
        if not all(same_bits(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"B2 {label}: kernel != plain version")

    for b in range(17):
        one((words, SLIDE, b, b, b, px, py), f"width {b}")
        one((words, SLIDE - 1, b, (b + 5) % 17, 14, px, py),
            f"widths {b}/{(b + 5) % 17}/14")
    enc = wc.WirePaneEncoder(NUM_SEGMENTS)
    enc.encode(panes[0])
    tables = [torch.from_numpy(t.copy()).to(dev)
              for t in (enc.pred_x, enc.pred_y)]
    e = enc.encode(panes[1])
    wb = wc.wire_word_bucket(len(e.words), nb)
    coded = torch.from_numpy(
        wc.pad_words(e.words, wb).view(np.int32).copy()).to(dev)
    args = (coded, e.n, e.bx, e.by, e.bo, *tables)
    one(args, "headline pane")
    pane, _, _ = wc.decode_wire_pane_cuda(*args, n=nb,
                                          num_segments=NUM_SEGMENTS)
    if not np.array_equal(pane[:, :SLIDE].cpu().numpy(), panes[1]):
        raise AssertionError("B2 headline pane does not decode to the raw pane")
    print(f"B2 wire_codec_decode: widths 0..16 and a headline pane "
          f"(bx={e.bx} by={e.by} bo={e.bo}, {len(e.words)} words) "
          f"bit_exact=True [{card}]")
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="phases 1-4 only (build and check the kernels)")
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

    # Phases 3-4
    err_b1 = check_digest(dev, wf, panes, card)
    err_b2, codec_args = check_codec(dev, panes, card)
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
    for name, ms, call, plain, bnd, by_ in (
            ("wire_digest", b1_ms, b1_call, b1_plain, b1_bound, b1_by),
            ("wire_codec_decode", b2_ms, b2_call, b2_plain, b2_bound,
             b2_by)):
        print(f"time {name}: kernel {ms:.6f} ms device ({call:.6f} ms per "
              f"call with its launch), plain PyTorch {plain:.6f} ms, bound "
              f"{bnd:.6f} ms ({by_}), medians of {REPEATS} calls at the "
              f"headline shape [{card}]")

    record = {"kernels": [
        {"name": "wire_digest", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_digest.cu",
         "replaces": "spatialflink_tpu/ops/pallas_digest.py:48",
         "launches": launches["wire_digest"], "max_abs_err": err_b1,
         "ms": b1_ms, "plain_ms": b1_plain, "bound_ms": b1_bound,
         "bound_by": b1_by, "library_ms": None},
        {"name": "wire_codec_decode", "route": "cuda",
         "source": "spatialflink_tpu_torch/kernels/csrc/wire_codec.cu",
         "replaces": "spatialflink_tpu/ops/wire_codec.py:361",
         "launches": launches["wire_codec_decode"], "max_abs_err": err_b2,
         "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": b2_bound,
         "bound_by": b2_by, "library_ms": None},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
