"""The port's hand kernels against their plain PyTorch versions, on the
card. Without a card these tests skip (the kernels have no CPU mode).

The machine with the card has no JAX, and ``tests/conftest.py`` imports
it, so run this file there without the conftest::

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

``python3 chip_smoke.py`` runs the same checks at the headline shapes.
"""

import numpy as np
import pytest
import torch

from spatialflink_tpu_torch.ops import wire_codec as twc

NSEG = 512


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card():
    """Both kernels bit-exact against their plain versions on the card
    (``python3 chip_smoke.py`` runs the full set at headline shapes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spatialflink_tpu_torch.ops.wire_digest_kernel import (
        wire_digest_cuda,
        wire_digest_plain,
    )

    rng = np.random.default_rng(5)
    dev = torch.device("cuda")
    wire_np = rng.integers(0, 65536, (3, 4096)).astype(np.uint16)
    wire_np[2] %= NSEG
    wire = torch.from_numpy(wire_np).to(dev)
    consts = (np.float32([0.5, 0.5]), np.float32([1e-5, 1e-5]),
              np.float32([0.0, 0.0]), np.float32(0.3))
    a, ca = wire_digest_cuda(wire, 4000, *consts, NSEG)
    b, cb = wire_digest_plain(wire, 4000, *consts, NSEG)
    assert torch.equal(a.seg_min, b.seg_min) and torch.equal(a.rep, b.rep)
    assert torch.equal(ca, cb)
    words = torch.from_numpy(rng.integers(0, 1 << 32, 6000, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    px = torch.from_numpy(rng.integers(0, 65536, NSEG).astype(np.uint16))
    args = (words, 4000, 7, 9, 9, px.to(dev), px.to(dev))
    got = twc.decode_wire_pane_cuda(*args, n=4096, num_segments=NSEG)
    want = twc.decode_wire_pane_plain(*args, n=4096, num_segments=NSEG)
    assert twc.codec_decodes_agree(got, want)


@pytest.mark.cuda
def test_join_extract_matches_plain_version_on_card():
    """B3 bit-exact against its plain version on the card, in order,
    within and over budget (``python3 chip_smoke.py`` runs the full set
    at the join's full shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )

    rng = np.random.default_rng(6)
    dev = torch.device("cuda")
    gn, n = 16, 3000
    lanes = []
    for _ in range(2):
        xy = rng.uniform(-0.2, gn + 0.2, (n, 2)).astype(np.float32)
        ci = np.floor(xy).astype(np.int64)
        inside = ((ci >= 0) & (ci < gn)).all(axis=1)
        cells = np.where(inside, ci[:, 0] * gn + ci[:, 1], gn * gn)
        lanes += [torch.from_numpy(xy), torch.from_numpy(rng.random(n) > 0.1),
                  torch.from_numpy(cells.astype(np.int32))]
    for radius, layers, cap, budget in ((0.4, 1, 24, 8192), (0.4, 1, 24, 256),
                                        (1.5, 2, 8, 1 << 16)):
        planes, _ = join_planes(*(t.to(dev) for t in lanes), grid_n=gn,
                                layers=layers, cap_left=cap, cap_right=cap)
        got = join_extract_cuda(*planes, gn, layers, radius, budget)
        want = join_extract_plain(*planes, gn, layers, radius, budget)
        torch.cuda.synchronize()
        assert int(want[3]) > 200
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g.cpu(), w.cpu())


@pytest.mark.cuda
def test_polyline_min_dist_matches_plain_version_on_card():
    """B4 bit-exact against its plain version on the card: dense mode
    (boundaries of 4,096 vertices tile through shared memory), gathered
    mode with the query set staged in shared memory and with a set too
    large to stage, an all-invalid boundary (FLT_MAX) and N not a
    multiple of the block (``python3 chip_smoke.py`` runs the full set at
    the range family's full shape)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(8)
    dev = torch.device("cuda")
    for g, v, n in ((40, 8, 3001), (8, 4096, 2000), (3, 64, 777)):
        verts = rng.uniform(-1, 1, (g, v, 2)).astype(np.float32)
        verts[:, 3] = verts[:, 2]  # zero-length edges
        ev = rng.random((g, v - 1)) > 0.2
        ev[-1] = False
        pts = rng.uniform(-1.2, 1.2, (n, 2)).astype(np.float32)
        sel = rng.integers(0, g, (n, 5)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (pts, verts, ev)]
        for s in (None, torch.from_numpy(sel).to(dev)):
            got = polyline_min_dist_cuda(*args, s)
            want = polyline_min_dist_plain(*args, s)
            torch.cuda.synchronize()
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
        dead = torch.from_numpy(sel[:, 0] == g - 1).to(dev)
        assert torch.all(got[dead][:, 0] == torch.finfo(torch.float32).max)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _bit_equal(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g.cpu(), w.cpu())


def _unit_grid_lanes(xys, gn, dev):
    """(xy, valid, cell) lanes of each side on a gn × gn unit grid."""
    lanes = []
    for xy in xys:
        ci = np.floor(xy).astype(np.int64)
        inside = ((ci >= 0) & (ci < gn)).all(axis=1)
        cells = np.where(inside, ci[:, 0] * gn + ci[:, 1], gn * gn)
        lanes += [torch.from_numpy(xy.astype(np.float32)).to(dev),
                  torch.ones(len(xy), dtype=torch.bool, device=dev),
                  torch.from_numpy(cells.astype(np.int32)).to(dev)]
    return lanes


def _spread(rng, i, j, n):
    return np.float32([i, j]) + rng.uniform(0.1, 0.9, (n, 2))


JOIN_CARD_CASES = ["holes_not_prefix", "saturated_cell", "budget_at_cell_end",
                   "budget_zero", "grid_not_multiple_of_block",
                   "repeated_calls"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", JOIN_CARD_CASES)
def test_join_extract_one_pass_cases_on_card(case):
    """B3's one-pass design bit-exact against its plain version where it
    could go wrong: live slots that are not a prefix of their bucket, a
    saturated cell, budgets that end at a cell's end or are 0, a cell count
    that is no multiple of the cells a block takes, repeated calls."""
    dev = _card()
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )

    rng = np.random.default_rng(7)
    gn, cap, radius, budget = 16, 24, 0.4, 8192
    sides = [rng.uniform(0, gn, (3000, 2)) for _ in range(2)]
    if case == "grid_not_multiple_of_block":
        gn = 15  # 225 cells
    elif case in ("saturated_cell", "budget_at_cell_end"):
        radius = float("inf")
        if case == "saturated_cell":
            sides = [_spread(rng, 5, 5, cap),
                     np.concatenate([_spread(rng, 5 + dx, 5 + dy, cap + 6)
                                     for dx in (-1, 0, 1)
                                     for dy in (-1, 0, 1)])]
        else:  # cell (0, 0): 8 left x 16 right = 128 pairs, first
            sides = [np.concatenate([_spread(rng, 0, 0, 8),
                                     _spread(rng, 5, 5, 10)]),
                     np.concatenate([_spread(rng, i, j, 4) for i, j in
                                     ((0, 0), (0, 1), (1, 0), (1, 1))]
                                    + [_spread(rng, 5, 5, 6)])]
            budget = 128
    elif case == "budget_zero":
        budget = 0
    planes, _ = join_planes(*_unit_grid_lanes(sides, gn, dev), grid_n=gn,
                            layers=1, cap_left=cap, cap_right=cap)
    if case == "holes_not_prefix":
        out = []
        for side in (planes[:3], planes[3:]):
            perm = torch.from_numpy(rng.permutation(cap)).to(dev)
            x, y, idx = (t[..., perm].contiguous() for t in side)
            idx[torch.from_numpy(rng.random(tuple(idx.shape)) < 0.25)
                .to(dev)] = -1
            out += [x, y, idx]
        planes = tuple(out)
    want = join_extract_plain(*planes, gn, 1, radius, budget)
    calls = 5 if case == "repeated_calls" else 1
    for _ in range(calls):
        got = join_extract_cuda(*planes, gn, 1, radius, budget)
        torch.cuda.synchronize()
        _bit_equal(got, want)
    count = int(want[3])
    if case == "saturated_cell":
        assert count == cap * 9 * cap
    elif case == "budget_at_cell_end":
        assert count == 8 * 16 + 10 * 6 and len(got[0]) == 128
        assert torch.all((got[0] >= 0) & (got[0] < 8))
    elif case == "budget_zero":
        assert len(got[0]) == 0 and count > 0
    else:
        assert count > 200


B4_CARD_CASES = ["dense_g33", "dense_g1000", "gathered_c3",
                 "invalid_mid_edges"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", B4_CARD_CASES)
def test_polyline_min_dist_redesign_cases_on_card(case):
    """B4's edge-table design bit-exact against its plain version where it
    could go wrong: G not a multiple of the 32 boundaries a dense block
    takes, C not a multiple of the 4-slot vectors, invalid edges between
    valid ones (dense and gathered)."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(9)
    g = {"dense_g33": 33, "dense_g1000": 1000}.get(case, 200)
    verts = rng.uniform(-1, 1, (g, 8, 2)).astype(np.float32)
    ev = np.ones((g, 7), bool)
    if case == "invalid_mid_edges":
        ev[::2, 1] = False
        ev[1::3, 2:4] = False
    pts = rng.uniform(-1.2, 1.2, (3001, 2)).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (pts, verts, ev)]
    sels = {"dense_g33": [None], "dense_g1000": [None],
            "gathered_c3": [rng.integers(0, g, (3001, 3))],
            "invalid_mid_edges": [None, rng.integers(0, g, (3001, 8))]}[case]
    for sel in sels:
        s = None if sel is None else \
            torch.from_numpy(sel.astype(np.int32)).to(dev)
        got = polyline_min_dist_cuda(*args, s)
        want = polyline_min_dist_plain(*args, s)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


B1_CARD_CASES = ["width_2051", "offset_2_bytes", "radius_up_and_down",
                 "num_segments_alternating"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", B1_CARD_CASES)
def test_wire_digest_one_launch_cases_on_card(case):
    """B1's one-launch design bit-exact against its plain version where it
    could go wrong: the 2-byte path (a pane width that is no multiple of
    8; a view 2 bytes past a 16-byte boundary) and scratch that an earlier
    call must have reset (the radius up and down, then no hit;
    ``num_segments`` alternating)."""
    dev = _card()
    from spatialflink_tpu_torch.ops.wire_digest_kernel import (
        wire_digest_cuda,
        wire_digest_plain,
    )

    rng = np.random.default_rng(10)
    n = 2051 if case == "width_2051" else 4096
    wire_np = rng.integers(0, 65536, (3, n)).astype(np.uint16)
    wire_np[2] %= NSEG
    wire = torch.from_numpy(wire_np).to(dev)
    if case == "offset_2_bytes":
        flat = torch.empty(3 * n + 1, dtype=torch.uint16, device=dev)
        wire = flat[1:].view(3, n)
        wire.copy_(torch.from_numpy(wire_np).to(dev))
        assert wire.data_ptr() % 16 == 2
    q, s, o = (np.float32([0.5, 0.5]), np.float32([1e-5, 1e-5]),
               np.float32([0.0, 0.0]))
    calls = [(q, 0.3, NSEG)]
    if case == "radius_up_and_down":
        calls = [(q, r, NSEG) for r in (0.5, 0.05, 0.5, 0.05, 0.5)]
        calls.append((np.float32([5.0, 5.0]), 0.5, NSEG))
    elif case == "num_segments_alternating":
        calls = [(q, 0.3, segs) for segs in (NSEG, 64, NSEG, 64)]
    n_valid = n - 2
    got = [wire_digest_cuda(wire, n_valid, qq, s, o, r, segs)
           for qq, r, segs in calls]
    for (qq, r, segs), (d_k, c_k) in zip(calls, got):
        d_p, c_p = wire_digest_plain(wire, n_valid, qq, s, o, r, segs)
        _bit_equal((d_k.seg_min, d_k.rep, c_k), (d_p.seg_min, d_p.rep, c_p))
    if case == "radius_up_and_down":
        assert int(got[-1][1]) == 0
    else:
        assert int(got[-1][1]) > 100


B2_CARD_CASES = ["payload_1_word", "payload_7_words", "n_valid_0",
                 "n_not_multiple_of_8", "absent_oids",
                 "num_segments_alternating"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", B2_CARD_CASES)
def test_wire_codec_one_launch_cases_on_card(case):
    """B2's one-launch design bit-exact against its plain version where it
    could go wrong: payloads shorter than their streams (every word index
    clamps to the last word), no valid lane, the 2-byte path, a pane in
    which some oids are absent (their predictors stay), and the ``last``
    scratch across ``num_segments`` alternating."""
    dev = _card()
    rng = np.random.default_rng(11)
    words = torch.from_numpy(rng.integers(0, 1 << 32, 6000, dtype=np.uint64)
                             .astype(np.uint32).view(np.int32)).to(dev)
    px = torch.from_numpy(rng.integers(0, 65536, NSEG).astype(np.uint16))
    py = torch.from_numpy(rng.integers(0, 65536, NSEG).astype(np.uint16))
    px, py = px.to(dev), py.to(dev)
    n, segs = 4096, NSEG
    runs = []
    if case.startswith("payload"):
        w = words[:1] if case == "payload_1_word" else words[:7]
        runs = [((w, 4000, *widths, px, py), n, segs)
                for widths in ((16, 16, 14), (5, 9, 3))]
    elif case == "n_valid_0":
        runs = [((words, 0, 7, 9, 9, px, py), n, segs)]
    elif case == "n_not_multiple_of_8":
        runs = [((words, 4000, 7, 9, 9, px, py), 4093, segs)]
    elif case == "num_segments_alternating":
        runs = [((words, 4000, 7, 9, 6, px[:s].contiguous(),
                  py[:s].contiguous()), n, s) for s in (NSEG, 64, NSEG, 64)]
    if case == "absent_oids":
        enc = twc.WirePaneEncoder(NSEG)
        tables = (torch.zeros(NSEG, dtype=torch.uint16, device=dev),) * 2
        for oids in (np.arange(3000) % NSEG, np.arange(3000) % (NSEG // 2)):
            pane = np.stack([rng.integers(0, 65536, 3000),
                             rng.integers(0, 65536, 3000),
                             oids]).astype(np.uint16)
            e = enc.encode(pane)
            coded = torch.from_numpy(twc.pad_words(e.words, len(e.words) + 16)
                                     .view(np.int32).copy()).to(dev)
            args = (coded, e.n, e.bx, e.by, e.bo, *tables)
            got = twc.decode_wire_pane_cuda(*args, n=n, num_segments=NSEG)
            want = twc.decode_wire_pane_plain(*args, n=n, num_segments=NSEG)
            _bit_equal(got, want)
            assert torch.equal(got[0][:, :3000].cpu(),
                               torch.from_numpy(pane))
            prev, tables = tables, got[1:]
        assert torch.equal(tables[0][NSEG // 2:], prev[0][NSEG // 2:])
        assert np.array_equal(tables[0].cpu().numpy(), enc.pred_x)
        assert np.array_equal(tables[1].cpu().numpy(), enc.pred_y)
        return
    for args, nn, s in runs:
        got = twc.decode_wire_pane_cuda(*args, n=nn, num_segments=s)
        want = twc.decode_wire_pane_plain(*args, n=nn, num_segments=s)
        _bit_equal(got, want)


B4_GEOMETRY_CASES = ["geometry_a_to_b", "geometry_b_to_a", "knn_g1",
                     "all_padding_objects"]


def _geometry_boundaries(rng, n, v=16):
    """``n`` packed closed rings of 4 to min(11, v - 1) distinct vertices
    in (n, v) slots, the padding vertices at 0 as
    ``GeometryBatch.from_ragged`` writes them."""
    m = rng.integers(4, min(12, v), n)
    ang = np.sort(rng.uniform(0, 2 * np.pi, (n, v)), axis=1)
    c = rng.uniform(-1, 1, (n, 1, 2))
    verts = c + 0.01 * np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    verts[np.arange(n), m] = verts[:, 0]
    lane = np.arange(v)
    verts = np.where((lane <= m[:, None])[..., None], verts, 0.0)
    ev = lane[None, :v - 1] < m[:, None]
    return verts.astype(np.float32), ev


@pytest.mark.cuda
@pytest.mark.parametrize("case", B4_GEOMETRY_CASES)
def test_polyline_min_dist_geometry_shapes_on_card(case):
    """B4 bit-exact against its plain version at the geometry-range
    path's two dense shapes (object vertices x query boundaries at the
    width ``chip_smoke.py`` runs, 131,072 objects of 16 vertex slots x 32
    queries; query vertices x object boundaries), at the kNN query's one
    boundary (G = 1), and through the geometry kernel on a batch whose
    padding objects have no valid edge (FLT_MAX, never kept)."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )
    from spatialflink_tpu_torch.ops.range import geometry_range_query_kernel

    rng = np.random.default_rng(11)
    big = torch.finfo(torch.float32).max
    if case == "all_padding_objects":
        verts, ev = _geometry_boundaries(rng, 13)
        verts = np.concatenate([verts, np.zeros((3, 16, 2), np.float32)])
        ev = np.concatenate([ev, np.zeros((3, 15), bool)])
        valid = np.arange(16) < 13
        flags = np.where(valid, 1, 0).astype(np.uint8)
        qv, qe = _geometry_boundaries(rng, 4, v=8)
        host = [torch.from_numpy(a) for a in (verts, ev, valid, flags, qv,
                                              qe)]
        for polygonal in (False, True):
            want = geometry_range_query_kernel(
                *host, 0.05, obj_polygonal=polygonal,
                query_polygonal=polygonal)
            got = geometry_range_query_kernel(
                *(t.to(dev) for t in host), 0.05, obj_polygonal=polygonal,
                query_polygonal=polygonal)
            torch.cuda.synchronize()
            _bit_equal(got, want)
            assert torch.all(got[1][13:] == big) and not got[0][13:].any()
        dense = polyline_min_dist_cuda(
            torch.from_numpy(qv.reshape(-1, 2)).to(dev),
            torch.from_numpy(verts).to(dev), torch.from_numpy(ev).to(dev))
        assert torch.all(dense[:, 13:] == big)
        return
    if case == "geometry_a_to_b":
        objs, _ = _geometry_boundaries(rng, 131_072)
        pts = objs.reshape(-1, 2)
        verts, ev = _geometry_boundaries(rng, 32, v=8)
    elif case == "geometry_b_to_a":
        qv, _ = _geometry_boundaries(rng, 32, v=8)
        pts = qv.reshape(-1, 2)
        verts, ev = _geometry_boundaries(rng, 131_072)
    else:
        pts = rng.uniform(-1, 1, (262_144, 2)).astype(np.float32)
        verts, ev = _geometry_boundaries(rng, 1, v=8)
    args = [torch.from_numpy(a).to(dev) for a in (pts, verts, ev)]
    got = polyline_min_dist_cuda(*args)
    want = polyline_min_dist_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == (len(pts), len(verts))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


B4_KNN_GEOMETRY_CASES = ["a_to_b_g1", "b_to_a_8_x_131072", "point_query"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", B4_KNN_GEOMETRY_CASES)
def test_polyline_min_dist_knn_geometry_shapes_on_card(case):
    """B4 bit-exact against its plain version at the geometry kNN path's
    shapes (``chip_smoke.py`` runs them at this width): the object
    vertices of 131,072 boundaries of 16 slots against one query boundary
    of 8 (G = 1); the query's 8 vertices against the 131,072 object
    boundaries; and a point query's degenerate one-edge boundary (2
    vertices) both ways."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(12)
    objs, oev = _geometry_boundaries(rng, 131_072)
    qv, qe = _geometry_boundaries(rng, 1, v=8)
    pt = rng.uniform(-1, 1, (1, 1, 2)).astype(np.float32)
    pv, pe = np.repeat(pt, 2, axis=1), np.ones((1, 1), bool)
    calls = {
        "a_to_b_g1": [(objs.reshape(-1, 2), qv, qe)],
        "b_to_a_8_x_131072": [(qv.reshape(-1, 2), objs, oev)],
        "point_query": [(objs.reshape(-1, 2), pv, pe),
                        (pv.reshape(-1, 2), objs, oev)],
    }[case]
    for host in calls:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in host]
        got = polyline_min_dist_cuda(*args)
        want = polyline_min_dist_plain(*args)
        torch.cuda.synchronize()
        assert got.shape == (len(host[0]), len(host[1]))
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["point", "polygon", "linestring"])
def test_knn_geometry_query_kernel_on_card_equals_cpu(query):
    """``knn_geometry_query_kernel`` on the card (B4 both ways) equals its
    CPU run (the plain versions) for 8,192 polygon objects: segments,
    representatives, ``num_valid`` and distance bits."""
    dev = _card()
    from spatialflink_tpu_torch.ops.knn import knn_geometry_query_kernel

    rng = np.random.default_rng(13)
    verts, ev = _geometry_boundaries(rng, 8192)
    valid = np.arange(8192) < 8000
    flags = rng.integers(0, 3, 8192).astype(np.uint8)
    oid = rng.integers(0, 1024, 8192).astype(np.int32)
    if query == "point":
        qv = np.repeat(rng.uniform(-0.5, 0.5, (1, 2)), 2,
                       axis=0).astype(np.float32)
        qe, qpoly = np.ones(1, bool), False
    else:
        ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
        ring = 0.3 * np.stack([np.cos(ang), np.sin(ang)], axis=1)
        qv = np.concatenate([ring, ring[:1]]).astype(np.float32)
        qe = np.ones(7, bool)
        if query == "linestring":
            qe[-1] = False  # the closing edge: an open polyline
        qpoly = query == "polygon"
    host = [torch.from_numpy(a) for a in (verts, ev, valid, flags, oid, qv,
                                          qe)]
    kw = dict(k=50, num_segments=1024, obj_polygonal=True,
              query_polygonal=qpoly)
    want = knn_geometry_query_kernel(*host, 0.2, **kw)
    got = knn_geometry_query_kernel(*(t.to(dev) for t in host), 0.2, **kw)
    torch.cuda.synchronize()
    _bit_equal(got, want)
    assert int(want.num_valid) == 50


B4_JOIN_CASES = ["point_polygon_gathered", "geometry_a_to_b_gathered",
                 "geometry_b_to_a_gathered"]


def _join_tiles(rng, n_left, m_right, block, cand, points=False):
    """The pruned joins' real ``sel`` lanes on random data: left items
    (points or boundaries of 16 slots, locality-sorted along x) in tiles
    of ``block`` against ``m_right`` boundaries of 8 slots, through
    ``point_tiles``/``geometry_tiles`` and ``tile_lanes``; pad slots past
    a tile's count hold in-range ids, padding rows no valid edge."""
    from spatialflink_tpu_torch.ops import join as tjoin
    from spatialflink_tpu_torch.ops.range import _vert_valid, tile_lanes

    def boxes(v, e):
        ok = _vert_valid(torch.from_numpy(e)).numpy()[..., None]
        big = np.finfo(np.float32).max
        lo = np.where(ok, v, big).min(axis=1)
        hi = np.where(ok, v, -big).max(axis=1)
        return torch.from_numpy(np.concatenate([lo, hi], axis=1))

    bv, be = _geometry_boundaries(rng, m_right, v=8)
    gvalid = torch.ones(m_right, dtype=torch.bool)
    if points:
        xy = rng.uniform(-1, 1, (n_left, 2)).astype(np.float32)
        xy = torch.from_numpy(xy[np.argsort(xy[:, 0])])
        valid = torch.ones(n_left, dtype=torch.bool)
        sx, _, _, gids, _, _ = tjoin.point_tiles(
            xy, valid, boxes(bv, be), gvalid, 0.02, block, cand)
        return (sx, torch.from_numpy(bv), torch.from_numpy(be),
                gids.repeat_interleave(block, dim=0))
    av, ae = _geometry_boundaries(rng, n_left)
    order = np.argsort(av[:, 0, 0])
    av, ae = av[order], ae[order]
    _, _, borig, gids, _, _ = tjoin.geometry_tiles(
        boxes(av, ae), torch.ones(n_left, dtype=torch.bool), boxes(bv, be),
        gvalid, 0.02, block, cand)
    pad = borig.numel() - n_left
    sav = torch.from_numpy(np.concatenate(
        [av, np.zeros((pad, 16, 2), np.float32)]))
    sae = torch.from_numpy(np.concatenate([ae, np.zeros((pad, 15), bool)]))
    a_xy, sel_ab, b_xy, sel_ba = tile_lanes(sav, torch.from_numpy(bv), gids)
    if pad == 0:
        raise AssertionError("the case must hold padding rows")
    return {"a": (a_xy, torch.from_numpy(bv), torch.from_numpy(be), sel_ab),
            "b": (b_xy, sav, sae, sel_ba)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", B4_JOIN_CASES)
def test_polyline_min_dist_join_shapes_on_card(case):
    """B4 gathered bit-exact against its plain version at the pruned
    joins' ``sel`` shapes (``chip_smoke.py`` runs them at full width):
    each point of a 256-point tile against the tile's 64 candidate
    polygons, pad slots (in-range ids past a tile's count) included; each
    vertex of 32-member tiles of 16-slot boundaries against their
    candidates; each candidate vertex against the tile's 32 member rows,
    padding rows (no valid edge, FLT_MAX) included."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(17)
    if case == "point_polygon_gathered":
        host = _join_tiles(rng, 131_000, 1000, 256, 64, points=True)
    else:
        lanes = _join_tiles(rng, 15_990, 1000, 32, 64)
        host = lanes["a" if case == "geometry_a_to_b_gathered" else "b"]
    args = [t.contiguous().to(dev) for t in host]
    got = polyline_min_dist_cuda(*args)
    want = polyline_min_dist_plain(*args)
    torch.cuda.synchronize()
    assert got.shape == host[3].shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "geometry_b_to_a_gathered":
        big = torch.finfo(torch.float32).max
        assert torch.all(got[:, -1][args[3][:, -1] >= 15_990] == big)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["point_polygon", "polygon_polygon"])
def test_pruned_join_kernels_on_card_equal_cpu(kind):
    """The pruned join kernels on the card (B4 gathered, containment,
    ``_compact_pairs``) equal their CPU run (the plain versions): pairs in
    order, distance bits, ``count`` and both overflow counters."""
    dev = _card()
    from spatialflink_tpu_torch.ops import join as tjoin

    rng = np.random.default_rng(19)
    bv, be = _geometry_boundaries(rng, 500, v=8)
    bv = bv * np.float32(8.0)  # polygons of radius 0.08 over [-8, 8]
    from spatialflink_tpu_torch.ops.range import _vert_valid

    def boxes(v, e):
        ok = _vert_valid(torch.from_numpy(e)).numpy()[..., None]
        big = np.finfo(np.float32).max
        return np.concatenate([np.where(ok, v, big).min(axis=1),
                               np.where(ok, v, -big).max(axis=1)], axis=1)

    if kind == "point_polygon":
        xy = rng.uniform(-8, 8, (40_000, 2)).astype(np.float32)
        xy = xy[np.argsort(xy[:, 0])]
        host = [xy, np.ones(40_000, bool), bv, be, np.ones(500, bool),
                boxes(bv, be)]
        kw = dict(polygonal=True, block=256, cand=64, max_pairs=1 << 16,
                  pair_cap=8)
        fn = tjoin.point_geometry_join_pruned_kernel
    else:
        av, ae = _geometry_boundaries(rng, 20_000)
        order = np.argsort(av[:, 0, 0])
        av, ae = av[order] * np.float32(8.0), ae[order]
        host = [av, ae, np.ones(20_000, bool), boxes(av, ae), bv, be,
                np.ones(500, bool), boxes(bv, be)]
        kw = dict(a_polygonal=True, b_polygonal=True, block=32, cand=64,
                  max_pairs=1 << 16, pair_cap=8)
        fn = tjoin.geometry_geometry_join_pruned_kernel
    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in host]
    want = fn(*cpu, 0.05, **kw)
    got = fn(*(t.to(dev) for t in cpu), 0.05, **kw)
    torch.cuda.synchronize()
    _bit_equal(got, want)
    assert int(want.count) > 100
    assert int(want.cand_overflow) == 0 and int(want.pair_overflow) == 0


def _traj_chunks(seed, n, n_obj, span_ms, per_chunk):
    rng = np.random.default_rng(seed)
    ts = np.sort(rng.integers(0, span_ms, n)).astype(np.int64)
    xs = rng.uniform(115.5, 117.6, n)
    ys = rng.uniform(39.6, 41.1, n)
    oid = rng.integers(0, n_obj, n).astype(np.int32)
    return [{"ts": ts[i:i + per_chunk], "x": xs[i:i + per_chunk],
             "y": ys[i:i + per_chunk], "oid": oid[i:i + per_chunk]}
            for i in range(0, n, per_chunk)]


@pytest.mark.cuda
def test_tjoin_run_soa_on_card_equals_cpu():
    """``TJoinQuery.run_soa`` on the card (B3, then the dedup) equals its
    CPU run (the plain versions) window for window: trajectory ids in key
    order, min-distance bits, counts and overflow (B3 is bit-exact and a
    minimum does not depend on the order of its terms); B3 launched once
    a two-sided window."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    grid = UniformGrid(50, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    left = _traj_chunks(31, 40_000, 512, 8000, 5000)
    right = _traj_chunks(32, 40_000, 512, 8000, 5000)
    out = {}
    for d in (dev, "cpu"):
        join_extract.launches = 0
        op = PointPointTJoinQuery(conf, grid, cap=24, device=d)
        out[str(d)] = (list(op.run_soa(left, right, 0.002, 512)),
                       join_extract.launches)
    got, launches = out[str(dev)]
    want, _ = out["cpu"]
    assert len(got) == len(want) == 9 and launches == len(got)
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:] and g[6] == 0
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert np.array_equal(g[4].view(np.int32), w[4].view(np.int32))
    assert min(g[5] for g in got) > 20


@pytest.mark.cuda
def test_traj_stats_on_card_equals_cpu():
    """The pane engine and ``TStatsQuery.run_soa`` on the card against
    their CPU runs: starts, counts and temporal sums exact, spatial sums
    within the stated bounds (the card's ``index_add_`` adds floats in
    another order)."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointTStatsQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.trajectory import spatial_sum_bound
    from spatialflink_tpu_torch.streams.panes import (
        pane_spatial_bound,
        traj_stats_sliding,
    )

    rng = np.random.default_rng(17)
    n = 200_000
    ts = np.sort(rng.integers(0, 30_000, n)).astype(np.int64)
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1)
    oid = rng.integers(0, 500, n).astype(np.int64)
    for size, slide in ((10_000, 10), (2_000, 1_000)):
        got = traj_stats_sliding(ts, xy, oid, 512, size, slide, device=dev)
        want = traj_stats_sliding(ts, xy, oid, 512, size, slide,
                                  backend="device", device="cpu")
        assert np.array_equal(got.starts, want.starts)
        assert np.array_equal(got.count, want.count)
        assert np.array_equal(got.temporal, want.temporal)
        bound = pane_spatial_bound(ts, xy, oid, 512, size, slide)
        assert np.all(np.abs(got.spatial - want.spatial) <= bound[None, :])
    chunks = [{"ts": ts[i:i + 20_000], "x": xy[i:i + 20_000, 0],
               "y": xy[i:i + 20_000, 1], "oid": oid[i:i + 20_000]}
              for i in range(0, n, 20_000)]
    conf = QueryConfiguration(window_size=10.0, slide_step=5.0)
    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    got = list(PointTStatsQuery(conf, grid, device=dev).run_soa(chunks, 512))
    want = list(PointTStatsQuery(conf, grid, device="cpu").run_soa(chunks,
                                                                   512))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2]
        assert np.array_equal(g[3], w[3]) and np.array_equal(g[4], w[4])
        bound = spatial_sum_bound(g[4], np.maximum(g[2], w[2]))
        assert np.all(np.abs(g[2].astype(np.float64) - w[2]) <= bound)


@pytest.mark.cuda
@pytest.mark.parametrize("cap_c", [None, 0])
def test_tjoin_run_soa_panes_on_card_equals_cpu(cap_c):
    """``TJoinQuery.run_soa_panes`` (the pane-carry engine, plain PyTorch)
    on the card equals its CPU run window for window, through the
    compacted probe (``cap_c`` planned) and the full-ring probe: ids in
    key order, distance bits, counts (the digests' scatter-min is exact
    in any order, the roots correctly rounded on both devices)."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )

    grid = UniformGrid(50, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=0.01)
    left = _traj_chunks(41, 20_000, 64, 2_000, 5000)
    right = _traj_chunks(42, 20_000, 64, 2_000, 5000)
    out = {}
    for d in (dev, "cpu"):
        op = PointPointTJoinQuery(conf, grid, device=d)
        out[str(d)] = list(op.run_soa_panes(left, right, 0.004, 64,
                                            cap_w=64, cap_c=cap_c,
                                            backend="device"))
    got, want = out[str(dev)], out["cpu"]
    assert len(got) == len(want) == 299
    for g, w in zip(got, want):
        assert g[0:2] == w[0:2] and g[5:] == w[5:]
        assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])
        assert np.array_equal(g[4].view(np.int64), w[4].view(np.int64))
    assert max(g[5] for g in got) > 100


def _csv_parser():
    """``chip_smoke.CsvChunkParser``: the numpy ``oid,ts,x,y`` chunk
    parser ``csv_chunk_source`` is given on the card."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.CsvChunkParser()


@pytest.mark.cuda
def test_csv_ingest_run_soa_on_card_equals_cpu(tmp_path):
    """A CSV stream read through ``csv_chunk_source`` into
    ``PointPolygonRangeQuery.run_soa`` on the card (B4, gathered) equals
    the same run fed the arrays directly and the CPU run: starts, ends,
    matched values, distance bits; B4 launched once a window."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.streams.soa import csv_chunk_source
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    rng = np.random.default_rng(7)
    n, per_win = 60_000, 20_000
    ts = (np.arange(n, dtype=np.int64) * 1000) // per_win
    x = rng.uniform(115.5, 117.6, n)
    y = rng.uniform(39.6, 41.1, n)
    path = tmp_path / "points.csv"
    path.write_text("".join(f"{i % 512},{t},{a!r},{b!r}\n" for i, (t, a, b)
                            in enumerate(zip(ts.tolist(), x.tolist(),
                                             y.tolist()))))
    polys = generate_query_polygons(200, 115.5, 39.6, 117.6, 41.1,
                                    grid_size=100, seed=3)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)

    def run(d, chunks):
        op = PointPolygonRangeQuery(conf, grid, device=d)
        return list(op.run_soa(chunks, polys, 0.002))

    polyline_min_dist.launches = 0
    got = run(dev, csv_chunk_source(str(path), _csv_parser(), 1 << 16))
    launches = polyline_min_dist.launches
    direct = run(dev, [{"ts": ts, "x": x, "y": y}])
    want = run("cpu", csv_chunk_source(str(path), _csv_parser(), 1 << 20))
    assert len(got) == len(direct) == len(want) == 3 and launches >= 3
    for g, d, w in zip(got, direct, want):
        assert g[:2] == d[:2] == w[:2]
        for k in ("ts", "x", "y"):
            assert np.array_equal(g[2][k], d[2][k])
            assert np.array_equal(g[2][k], w[2][k])
        assert np.array_equal(g[2]["oid"], w[2]["oid"])
        assert np.array_equal(g[3].view(np.uint32), d[3].view(np.uint32))
        assert np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32))
        assert len(g[3]) > 100


@pytest.mark.cuda
def test_check_in_query_soa_on_card_equals_host_walk():
    """The check-in kernel (plain PyTorch: stable sorts, a segmented
    cumulative sum) on the card emits the host walk's (room, capacity,
    occupancy) sequence exactly, missed doors of both directions
    included."""
    dev = _card()
    from spatialflink_tpu_torch.apps.checkin import (
        CheckInEvent,
        check_in_query,
        check_in_query_soa,
    )

    rng = np.random.default_rng(44)
    last, events = {}, []
    for i in range(50_000):
        u = int(rng.integers(0, 700))
        door = (f"room{int(rng.integers(0, 40))}-"
                f"{'in' if rng.integers(0, 2) else 'out'}")
        if u in last and rng.uniform() < 0.2:
            door = last[u]
        last[u] = door
        events.append(CheckInEvent(f"e{i}", door, f"u{u}", 1000 + 3 * i))
    caps = {f"room{i}": i for i in range(0, 40, 3)}
    host = [(r, c, o) for r, c, o, _ in check_in_query(iter(events), caps)]
    got = [(r, c, o) for r, c, o, _ in
           check_in_query_soa(iter(events), caps, device=dev)]
    assert got == host and len(host) > 55_000


@pytest.mark.cuda
def test_cell_stay_time_soa_on_card_equals_cpu():
    """``cell_stay_time_soa`` on the card (``stay_time_cells_kernel``,
    int64 ``index_add_``) equals its CPU run exactly, trajId filter
    included."""
    dev = _card()
    from spatialflink_tpu_torch.apps.staytime import cell_stay_time_soa
    from spatialflink_tpu_torch.grid import UniformGrid

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    chunks = _traj_chunks(51, 100_000, 300, 30_000, 10_000)
    allow = np.random.default_rng(52).uniform(size=300) < 0.7
    for kw in ({}, {"oid_allow": allow}):
        got = list(cell_stay_time_soa(iter(chunks), 10, 5, grid, device=dev,
                                      **kw))
        want = list(cell_stay_time_soa(iter(chunks), 10, 5, grid,
                                       device="cpu", **kw))
        assert len(got) == len(want) == 7
        for g, w in zip(got, want):
            assert g[:2] == w[:2]
            assert np.array_equal(g[2], w[2]) and np.array_equal(g[3], w[3])


@pytest.mark.cuda
def test_run_wire_panes_interpret_raises_on_card():
    """The card always runs the hand kernels: ``interpret=True`` (the JAX
    signature's flag) raises on a card in ``run_wire_panes`` and in both
    selectors, and ``interpret=False`` takes the kernels."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import QueryConfiguration
    from spatialflink_tpu_torch.operators.knn_query import PointPointKNNQuery
    from spatialflink_tpu_torch.ops import wire_knn as twk
    from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    wf = WireFormat.for_grid(grid)
    rng = np.random.default_rng(8)
    n = 3000
    ch = {"ts": np.sort(rng.integers(0, 3000, n)).astype(np.int64),
          "x": rng.uniform(115.5, 117.6, n), "y": rng.uniform(39.6, 41.1, n),
          "oid": rng.integers(0, 256, n)}
    panes = list(wire_panes([ch], wf, 1000, 0))
    q = Point(x=116.4, y=40.19)
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)
    op = PointPointKNNQuery(conf, grid, device=dev)
    with pytest.raises(ValueError, match="interpret"):
        next(op.run_wire_panes(panes, q, 0.5, 5, 256, wf, 0, "auto", 8192,
                               True))
    wire = torch.from_numpy(panes[0]).to(dev)
    with pytest.raises(ValueError, match="interpret"):
        twk.select_wire_digest_step(
            wire, wire.shape[1], np.float32([116.4, 40.19]), wf.scale,
            wf.origin, 0.5, num_segments=256, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        twc.select_wire_decoder("auto", interpret=True, sample_args=(wire,),
                                n=8, num_segments=256)
    got = list(op.run_wire_panes(panes, q, 0.5, 5, 256, wf, 0, "auto", 8192,
                                 False))
    assert got and op.last_wire_digest_kind == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("zone_set", ["q1", "maintenance", "q5_fence",
                                      "mn_q5_fence"])
def test_zone_test_on_card_equals_cpu_and_numpy_twin(zone_set):
    """The SNCB zone test (``contains_any_zone``: float64 point→polygon
    distances, plain PyTorch) on the card: the mask equals the CPU run and
    the numpy twin, distances equal the CPU's bit for bit, on 200,000
    seeded points over each zone set plus points a few ulps either side
    of every buffered edge."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polygon import point_polygon_distance
    from spatialflink_tpu_torch.sncb.common import (
        BufferedZone,
        PolygonLoader,
        contains_any_zone,
        contains_any_zone_np,
    )
    from spatialflink_tpu_torch.sncb.mobility import Q5_FENCE
    from spatialflink_tpu_torch.sncb.queries import buffer_q1_zones

    zones = {
        "q1": lambda: buffer_q1_zones(PolygonLoader.load_geojson_buffered(
            "high_risk_zones.geojson", 20.0), 20.0),
        "maintenance": lambda: PolygonLoader.load_geojson_buffered(
            "maintenance_areas.geojson", 0.0),
        "q5_fence": lambda: PolygonLoader.load_wkt_buffered(
            "q5_fence.wkt", 20.0),
        "mn_q5_fence": lambda: [BufferedZone(
            [np.asarray(Q5_FENCE, float)], 0.001)],
    }[zone_set]()
    rng = np.random.default_rng(61)
    pts = []
    for z in zones:
        verts, ev = z.packed()
        lo, hi = verts.min(0), verts.max(0)
        span = hi - lo + 4 * z.buffer_m
        pts.append(rng.uniform(lo - span, hi + span, (50_000, 2)))
        for i in np.nonzero(ev)[0]:
            a, b = verts[i], verts[i + 1]
            nrm = np.array([b[1] - a[1], a[0] - b[0]]) / np.hypot(*(b - a))
            for sign in (1.0, -1.0):
                p = (a + b) / 2 + sign * nrm * z.buffer_m
                pts.append(p + np.arange(-8, 9)[:, None]
                           * np.spacing(np.abs(p))[None, :])
    pts = np.concatenate(pts)
    got = contains_any_zone(zones, pts, device=dev)
    assert np.array_equal(got, contains_any_zone(zones, pts, device="cpu"))
    assert np.array_equal(got, contains_any_zone_np(zones, pts))
    assert 0 < got.sum() < len(got)
    for z in zones:
        verts, ev = (torch.from_numpy(a) for a in z.packed())
        d = point_polygon_distance(torch.from_numpy(pts).to(dev),
                                   verts.to(dev), ev.to(dev)).cpu()
        want = point_polygon_distance(torch.from_numpy(pts), verts, ev)
        assert d.dtype == torch.float64
        assert torch.equal(d.view(torch.int64), want.view(torch.int64))


@pytest.mark.cuda
def test_op_counters_on_card_equal_cpu():
    """The op counters over ``PointPolygonRangeQuery.run_soa`` (B4) and
    ``PointPointJoinQuery.run_soa`` (B3) on the card equal the CPU run's
    tallies; a disabled run records nothing."""
    dev = _card()
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops import counters as oc
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    polys = generate_query_polygons(200, 115.5, 39.6, 117.6, 41.1,
                                    grid_size=100, seed=3)
    def chunks(seed):
        r = np.random.default_rng(seed)
        n = 60_000
        return [{"ts": (np.arange(n, dtype=np.int64) * 3000) // n,
                 "x": r.uniform(115.5, 117.6, n),
                 "y": r.uniform(39.6, 41.1, n)}]

    snaps = []
    try:
        for d in (dev, "cpu"):
            oc.enable()
            list(PointPolygonRangeQuery(conf, grid, device=d).run_soa(
                chunks(1), polys, 0.002))
            list(PointPointJoinQuery(conf, grid, device=d).run_soa(
                chunks(2), chunks(3), 0.002))
            snap = oc.counters.snapshot()
            snap.pop("throughput_eps")
            snaps.append(snap)
        oc.counters.reset()
        oc.disable()
        list(PointPolygonRangeQuery(conf, grid, device=dev).run_soa(
            chunks(1), polys, 0.002))
        off = oc.counters.snapshot()
    finally:
        oc.disable()
    assert snaps[0] == snaps[1] and snaps[0]["dist_computations"] > 0
    assert snaps[0]["windows"] == 9
    assert off["windows"] == off["dist_computations"] == 0


# ---------------------------------------------------------------------------
# The runtime layer (telemetry, faults, ablation) on the card


def _runtime_paths(dev):
    """B1 (``run_wire_panes`` sync), B1 + B2 (pipelined, delta codec), B3
    (``PointPointJoinQuery.run_soa``) and B4
    (``PointPolygonRangeQuery.run_soa``, the pruned path) on ``dev``,
    small; returns each path's windows as host arrays."""
    from spatialflink_tpu_torch import pipeline
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        PointPointKNNQuery,
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    wf = WireFormat.for_grid(grid)
    rng = np.random.default_rng(9)
    n = 20_000
    ch = {"ts": np.sort(rng.integers(0, 4000, n)).astype(np.int64),
          "x": rng.uniform(115.5, 117.6, n), "y": rng.uniform(39.6, 41.1, n),
          "oid": rng.integers(0, 256, n)}
    panes = list(wire_panes([ch], wf, 1000, 0))
    q = Point(x=116.4, y=40.19)
    out = {}
    for mode, pol in (("sync", None), ("delta", pipeline.PipelinePolicy(
            depth=2, fetch_lag=1, codec="delta"))):
        pipeline.uninstall()
        if pol is not None:
            pipeline.install(pol)
        try:
            op = PointPointKNNQuery(QueryConfiguration(window_size=2.0,
                                                       slide_step=1.0),
                                    grid, device=dev)
            out[mode] = [w[2:4] for w in op.run_wire_panes(
                panes, q, 0.5, 5, 256, wf)]
        finally:
            pipeline.uninstall()
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    pts = [{"ts": (np.arange(n, dtype=np.int64) * 3000) // n,
            "x": r.uniform(115.5, 117.6, n), "y": r.uniform(39.6, 41.1, n)}
           for r in (np.random.default_rng(s) for s in (1, 2))]
    out["join"] = [w[2:5] for w in PointPointJoinQuery(
        conf, grid, cap=48, device=dev).run_soa([pts[0]], [pts[1]], 0.002)]
    polys = generate_query_polygons(100, 115.5, 39.6, 117.6, 41.1,
                                    grid_size=100, seed=3)
    out["range"] = [w[3] for w in PointPolygonRangeQuery(
        conf, grid, device=dev).run_soa([pts[0]], polys, 0.002)]
    return out


def _same_windows(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert len(a[k]) == len(b[k]) > 0, k
        for wa, wb in zip(a[k], b[k]):
            wa = wa if isinstance(wa, tuple) else (wa,)
            wb = wb if isinstance(wb, tuple) else (wb,)
            for x, y in zip(wa, wb):
                assert np.array_equal(np.asarray(x).view(np.uint8),
                                      np.asarray(y).view(np.uint8)), k


@pytest.mark.cuda
def test_kernels_bit_equal_with_telemetry_on_and_off_on_card(tmp_path):
    """B1-B4 through their instrumented wrappers: every window bit-equal
    with telemetry off and on (trace and ledger stream written), each
    kernel launched, and the dispatch table naming the JAX labels."""
    dev = _card()
    from spatialflink_tpu_torch.ops import wire_codec as wc
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.telemetry import telemetry

    off = _runtime_paths(dev)
    counts = (wire_digest, wc.decode_wire_pane, join_extract,
              polyline_min_dist)
    for c in counts:
        c.launches = 0
    telemetry.enable(trace_path=str(tmp_path / "t.jsonl"),
                     stream_path=str(tmp_path / "s.jsonl"))
    try:
        on = _runtime_paths(dev)
        labels = {r["kernel"] for r in telemetry.kernel_table()}
        d2h = telemetry.d2h_transfers
    finally:
        telemetry.disable()
    _same_windows(off, on)
    assert all(c.launches > 0 for c in counts)
    assert {"wire_digest_pallas_step", "wire_pane_decode",
            "join_window_pallas", "knn_merge_digest_list"} <= labels
    assert labels & {"range_polygons_pruned_fused",
                     "range_polygons_pruned_compact_fused"}
    assert d2h > 0


@pytest.mark.cuda
def test_ablated_kernel_returns_zeros_on_card():
    """An armed label returns zeros of the kernel's structure on the card
    after one learning call (the real B1 launch), and nothing launches
    after it."""
    dev = _card()
    from spatialflink_tpu_torch.ablation import ablation
    from spatialflink_tpu_torch.ops.wire_digest_kernel import (
        wire_digest,
        wire_digest_cuda,
    )
    from spatialflink_tpu_torch.telemetry import instrument_jit

    rng = np.random.default_rng(5)
    wire_np = rng.integers(0, 65536, (3, 4096)).astype(np.uint16)
    wire_np[2] %= NSEG
    wire = torch.from_numpy(wire_np).to(dev)
    consts = (np.float32([0.5, 0.5]), np.float32([1e-5, 1e-5]),
              np.float32([0.0, 0.0]), np.float32(0.3))
    f = instrument_jit(lambda w: wire_digest(w, 4000, *consts, NSEG)[0],
                       name="b1")
    real = wire_digest_cuda(wire, 4000, *consts, NSEG)[0]
    ablation.arm(["b1"])
    try:
        learned = f(wire)
        wire_digest.launches = 0
        zero = f(wire)
        launched = wire_digest.launches
    finally:
        ablation.disarm()
    assert torch.equal(learned.seg_min, real.seg_min)
    assert launched == 0
    for z, r in zip(zero, real):
        assert z.device == r.device and z.dtype == r.dtype
        assert z.shape == r.shape and not bool(z.any())


@pytest.mark.cuda
def test_device_dispatch_fires_before_the_kernel_launch_on_card():
    """``device.dispatch`` raises inside the instrumented wrapper before
    the hand kernel is launched (B3's launch count does not move), and a
    rerun after ``disarm()`` launches it."""
    dev = _card()
    from spatialflink_tpu_torch.faults import InjectedFault, faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    r = np.random.default_rng(4)
    n = 8000
    ch = [{"ts": (np.arange(n, dtype=np.int64) * 1000) // n,
           "x": r.uniform(115.5, 117.6, n), "y": r.uniform(39.6, 41.1, n)}]
    join_extract.launches = 0
    faults.arm([{"point": "device.dispatch", "at": 1}])
    try:
        with pytest.raises(InjectedFault):
            list(PointPointJoinQuery(conf, grid, device=dev).run_soa(
                ch, ch, 0.002))
        assert join_extract.launches == 0
    finally:
        faults.disarm()
    assert list(PointPointJoinQuery(conf, grid, device=dev).run_soa(
        ch, ch, 0.002))
    assert join_extract.launches > 0


def _range_driver_leg(dev, workdir, polys, stream, plan=None):
    """``PointPolygonRangeQuery.run(driver=)`` on ``dev`` into a
    transactional sink, checkpointed every window; an armed plan is
    disarmed whatever happens."""
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
        render_range_result,
    )
    from spatialflink_tpu_torch.faults import faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators import (
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.streams.sinks import TransactionalFileSink

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    sink = TransactionalFileSink(str(workdir / "egress.csv"))
    drv = WindowedDataflowDriver(
        checkpoint_path=str(workdir / "ckpt.bin"), checkpoint_every=1,
        sink=sink, retry=RetryPolicy(max_retries=0, backoff_s=0.0),
        failover=False)
    if plan:
        faults.arm(plan)
    try:
        for res in PointPolygonRangeQuery(conf, grid, device=dev).run(
                iter(stream), polys, 0.002, driver=drv):
            for line in render_range_result(res):
                sink.stage(line)
    finally:
        faults.disarm()
    return (workdir / "egress.csv").read_bytes()


@pytest.mark.cuda
def test_range_kill_resume_through_b4_on_card(tmp_path):
    """The range query through B4 under the dataflow driver, killed at its
    second commit and resumed on the card: the egress byte-identical to
    the clean card run and to the CPU run, B4 launched."""
    dev = _card()
    from spatialflink_tpu_torch.faults import InjectedFault
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    polys = generate_query_polygons(100, 115.5, 39.6, 117.6, 41.1,
                                    grid_size=100, seed=3)
    rng = np.random.default_rng(7)
    n = 3 * 4096
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1)
    near = np.concatenate([p.rings[0][:1] for p in polys])
    xy[::3] = near[rng.integers(0, len(near), len(xy[::3]))] + \
        rng.uniform(-0.003, 0.003, (len(xy[::3]), 2))
    stream = [Point(obj_id=f"p{i % 500}", timestamp=int(i * 1000 // 4096),
                    x=float(x), y=float(y)) for i, (x, y) in enumerate(xy)]
    dirs = {k: tmp_path / k for k in ("clean", "chaos", "cpu")}
    for d in dirs.values():
        d.mkdir()
    polyline_min_dist.launches = 0
    clean = _range_driver_leg(dev, dirs["clean"], polys, stream)
    assert polyline_min_dist.launches >= 3 and clean.count(b"\n") > 10
    with pytest.raises(InjectedFault):
        _range_driver_leg(dev, dirs["chaos"], polys, stream, plan=[
            {"point": "sink.write", "at": 2, "times": 10_000}])
    resumed = _range_driver_leg(dev, dirs["chaos"], polys, stream)
    cpu = _range_driver_leg(torch.device("cpu"), dirs["cpu"], polys, stream)
    assert resumed == clean == cpu


@pytest.mark.cuda
def test_wire_carry_checkpoint_restores_on_card_and_cpu(tmp_path):
    """The headline carry through B1: a card run stopped mid-stream,
    checkpointed (the digest ring pulled from the card), restored into a
    card operator and into a CPU operator; both continuations bit-equal
    to the uninterrupted card run."""
    dev = _card()
    from spatialflink_tpu_torch.checkpoint import (
        load_checkpoint,
        operator_state,
        restore_operator,
        save_checkpoint,
    )
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    wf = WireFormat.for_grid(grid)
    rng = np.random.default_rng(42)
    n = 12 * 2000
    panes = list(wire_panes([{
        "ts": np.sort(rng.integers(0, 12_000, n)).astype(np.int64),
        "x": rng.uniform(115.5, 117.6, n), "y": rng.uniform(39.6, 41.1, n),
        "oid": rng.integers(0, NSEG, n)}], wf, 1000, 0))
    q = Point(x=116.4, y=40.19)
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)

    def op(device):
        return PointPointKNNQuery(conf, grid, device=device)

    def run(o, part, flush=True):
        return [(s, e, ids.tolist(), d.view(np.uint32).tolist(), nv)
                for s, e, ids, d, nv in o.run_wire_panes(
                    part, q, 0.5, 10, NSEG, wf, flush_at_end=flush)]

    wire_digest.launches = 0
    whole = run(op(dev), panes)
    assert wire_digest.launches >= len(panes)
    cut = 6
    first = op(dev)
    head = run(first, panes[:cut], flush=False)
    path = str(tmp_path / "wire.ckpt")
    save_checkpoint(path, op=operator_state(first))
    for device in (dev, torch.device("cpu")):
        resumed = op(device)
        restore_operator(resumed, load_checkpoint(path)["op"])
        assert resumed._wire_pane_carry["digests"][0][0].device == \
            resumed.device
        assert head + run(resumed, panes[cut:]) == whole


def _headline_like(seed=42, n_panes=12, per=2000):
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.streams.wire import WireFormat, wire_panes

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    wf = WireFormat.for_grid(grid)
    rng = np.random.default_rng(seed)
    n = n_panes * per
    panes = list(wire_panes([{
        "ts": np.sort(rng.integers(0, n_panes * 1000, n)).astype(np.int64),
        "x": rng.uniform(115.5, 117.6, n), "y": rng.uniform(39.6, 41.1, n),
        "oid": rng.integers(0, NSEG, n)}], wf, 1000, 0))
    return grid, wf, panes


@pytest.mark.cuda
def test_batch_slides_on_the_wire_path_through_b1_on_card(tmp_path):
    """The overload ``batch_slides`` rung on the card: windows bit-equal
    to the unbatched card run and to the CPU run, one device→host copy a
    batch of 4, and a checkpoint taken with a batch open restored into a
    fresh card operator losing no window."""
    dev = _card()
    from spatialflink_tpu_torch import overload
    from spatialflink_tpu_torch.checkpoint import (
        load_checkpoint,
        operator_state,
        restore_operator,
        save_checkpoint,
    )
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.telemetry import telemetry

    grid, wf, panes = _headline_like()
    q = Point(x=116.4, y=40.19)
    conf = QueryConfiguration(window_size=2.0, slide_step=1.0)

    def run(device, part=panes):
        o = PointPointKNNQuery(conf, grid, device=device)
        return o, [(s, e, ids.tolist(), d.view(np.uint32).tolist(), nv)
                   for s, e, ids, d, nv in o.run_wire_panes(
                       part, q, 0.5, 10, NSEG, wf)]

    _, base = run(dev)
    _, cpu = run(torch.device("cpu"))
    try:
        ctrl = overload.install(overload.OverloadController(
            overload.OverloadPolicy(
                ladder=({"action": "batch_slides", "n": 4},),
                degrade_cooldown=1)))
        ctrl.on_slo_evaluation(False)
        wire_digest.launches = 0
        telemetry.enable()
        _, got = run(dev)
        fetches = sum(1 for e in telemetry.events if e["name"] == "fetch")
        telemetry.disable()
        assert wire_digest.launches >= len(panes)
        assert got == base == cpu
        assert fetches == -(-len(base) // 4)
        first = PointPointKNNQuery(conf, grid, device=dev)
        head = []
        gen = first.run_wire_panes(panes, q, 0.5, 10, NSEG, wf)
        for s, e, ids, d, nv in gen:
            head.append((s, e, ids.tolist(), d.view(np.uint32).tolist(), nv))
            if len(head) == 6:  # two windows of the second batch out
                break
        gen.close()
        state = operator_state(first)
        cut = int(state["knn_wire_pane_carry"]["next_pane"])
        path = str(tmp_path / "wire.ckpt")
        save_checkpoint(path, op=state)
        resumed = PointPointKNNQuery(conf, grid, device=dev)
        restore_operator(resumed, load_checkpoint(path)["op"])
        rest = [(s, e, ids.tolist(), d.view(np.uint32).tolist(), nv)
                for s, e, ids, d, nv in resumed.run_wire_panes(
                    panes[cut:], q, 0.5, 10, NSEG, wf)]
        assert head + rest == base
    finally:
        overload.uninstall()
        telemetry.disable()


@pytest.mark.cuda
def test_circuit_breaker_round_trip_on_card():
    """The device-path circuit breaker on the card: two failing windows
    open it, two windows go to the numpy twin with no device attempt, a
    probe closes it, and the device path answers the rest. Windows equal
    the clean card run; with the pipeline armed the driver collapses to
    the synchronous cadence while the circuit is open."""
    dev = _card()
    from spatialflink_tpu_torch import overload, pipeline
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )
    from spatialflink_tpu_torch.faults import faults
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointRangeQuery,
        QueryConfiguration,
    )

    rng = np.random.default_rng(7)
    n = 8 * 2000
    xy = np.stack([rng.uniform(116.0, 116.8, n), rng.uniform(39.8, 40.6, n)],
                  axis=1)
    stream = [Point(obj_id=f"p{i % 500}", timestamp=int(i * 1000 // 2000),
                    x=float(x), y=float(y)) for i, (x, y) in enumerate(xy)]
    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)
    q = [Point(x=116.4, y=40.2)]

    def run(driver=None, plan=None):
        if plan:
            faults.arm(plan)
        try:
            out = []
            for r in PointPointRangeQuery(conf, grid, device=dev).run(
                    iter(stream), q, 0.1, driver=driver):
                out.append((r.start, [p.obj_id for p in r.objects],
                            np.asarray(r.dists).view(np.uint32).tolist(),
                            pipeline.breaker_collapsed()))
            return out
        finally:
            faults.disarm()

    base = [w[:3] for w in run()]
    try:
        for pol, plan in (
                (None, [{"point": "driver.window", "at": 1, "times": 2}]),
                (pipeline.PipelinePolicy(depth=2, fetch_lag=1),
                 [{"point": "pipeline.ship", "at": 1, "times": 2},
                  {"point": "driver.window", "at": 1, "times": 2}])):
            ctrl = overload.OverloadController(overload.OverloadPolicy(
                breaker_failures=2, breaker_probe_every=3))
            drv = WindowedDataflowDriver(
                retry=RetryPolicy(max_retries=0, backoff_s=0.0),
                overload=ctrl, pipeline=pol)
            got = run(drv, plan)
            assert [w[:3] for w in got] == base and len(base) >= 6
            assert ctrl.breaker.snapshot() == {
                "state": "closed", "opens": 1, "probes": 1,
                "consecutive_failures": 0}
            assert drv.backend == "device" and drv.stats["failovers"] == 0
            assert ctrl.degraded_windows == 4
            assert [w[3] for w in got][:5] == [False, True, True, True,
                                               False]
            overload.uninstall()
    finally:
        overload.uninstall()


def _registry_inputs(rng, n, live, rung):
    """A window of ``n`` Beijing points and a bucket of ``live`` standing
    queries padded to ``rung`` lanes, as the operator ships them."""
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.operators.base import center_coords
    from spatialflink_tpu_torch.qserve import (
        StandingQuery,
        bucket_host_arrays,
    )

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    xy = np.stack([rng.uniform(115.5, 117.6, n), rng.uniform(39.6, 41.1, n)],
                  axis=1)
    qs = [StandingQuery(qid=f"q{i}", tenant="t", kind="knn",
                        x=float(rng.uniform(115.6, 117.5)),
                        y=float(rng.uniform(39.7, 41.0)),
                        radius=float((0.002, 0.02, 0.05)[i % 3]), k=8)
          for i in range(live)]
    qxy, radius, qvalid, tables = bucket_host_arrays(grid, qs, rung)
    return [torch.from_numpy(a) for a in (
        center_coords(grid, xy), np.ones(n, bool),
        grid.assign_cells_np(xy).astype(np.int32), tables,
        rng.integers(0, 4096, n).astype(np.int32),
        center_coords(grid, qxy), radius, qvalid)]


@pytest.mark.cuda
@pytest.mark.parametrize("live,rung", [(5, 8), (70, 128)])
def test_registry_bucket_program_on_card_equals_cpu(live, rung):
    """The standing-query bucket program (plain PyTorch, the same dense
    body on both devices) on the card against its CPU run at two rungs:
    every field of every lane bit-equal, the padded lanes empty."""
    dev = _card()
    from spatialflink_tpu_torch.ops.knn import F32_BIG
    from spatialflink_tpu_torch.ops.query_registry import (
        registry_bucket_kernel,
    )

    args = _registry_inputs(np.random.default_rng(8), 65_536, live, rung)
    kw = dict(k=32, num_segments=4096, query_block=min(rung, 32))
    got = registry_bucket_kernel(*(a.to(dev) for a in args), **kw)
    want = registry_bucket_kernel(*args, **kw)
    _bit_equal(got, want)
    assert int(want.within[:live].sum()) > 0
    assert bool((got.num_valid[live:] == 0).all())
    assert bool((got.within[live:] == 0).all())
    assert bool((got.segment[live:] == -1).all())
    assert bool((got.dist[live:] == F32_BIG).all())


@pytest.mark.cuda
def test_qserve_window_on_card_equals_cpu():
    """One ``QServeOperator`` run (registrations, a tenant result budget,
    an unregistration between windows) on the card against the CPU: the
    egress lines, the registry state and the tenant block equal."""
    dev = _card()
    from spatialflink_tpu_torch import overload, qserve
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import QueryConfiguration

    rng = np.random.default_rng(9)
    qs = [qserve.StandingQuery(
        qid=f"q{i}", tenant=f"t{i % 5}", kind=("range", "knn")[i % 2],
        x=float(rng.uniform(116.0, 116.8)), y=float(rng.uniform(39.8, 40.6)),
        radius=float((0.01, 0.03)[i % 2]), k=(5, 20)[i % 2],
        tenant_class=("bulk", "default")[i % 2]) for i in range(40)]
    n = 20_000
    xy = np.stack([rng.uniform(116.0, 116.8, n), rng.uniform(39.8, 40.6, n)],
                  axis=1)
    stream = qserve.boot_commands(qs) + [
        Point(obj_id=f"o{i % 700}", timestamp=int(i * 2000 // n), x=float(x),
              y=float(y)) for i, (x, y) in enumerate(xy)]
    stream.insert(len(qs) + n // 2, qserve.QServeCommand(
        timestamp=1000, action="unregister", uid="u", qid="q3"))

    def run(device):
        ctrl = overload.install(overload.OverloadController(
            overload.OverloadPolicy(tenant_budgets={
                "bulk": {"max_results_per_window": 50}})))
        op = qserve.QServeOperator(
            QueryConfiguration(window_size=1.0, slide_step=1.0),
            UniformGrid(100, 115.5, 117.6, 39.6, 41.1), device=device)
        try:
            lines = [line for r in op.run(iter(stream)) for line in r.lines()]
            return lines, op.registry.state(), ctrl.snapshot()["tenants"]
        finally:
            qserve.uninstall()
            overload.uninstall()

    got, want = run(dev), run("cpu")
    assert got == want
    assert got[2]["bulk"]["results_shed"] > 0 and len(got[0]) > 100


@pytest.mark.cuda
def test_native_tstats_engine_against_the_device_engine_on_card():
    """The native tStats engine (``sf_traj_stats``, host) against the
    device engine on the card: starts, counts and temporal sums exact,
    spatial sums within ``pane_spatial_bound`` (the host engine reads the
    float32 coordinates the device engine does); ``"auto"`` on the card
    keeps the device engine."""
    dev = _card()
    from spatialflink_tpu_torch import native
    from spatialflink_tpu_torch.streams import panes as tpanes

    assert native.available()
    rng = np.random.default_rng(29)
    n = 200_000
    ts = np.sort(rng.integers(0, 30_000, n)).astype(np.int64)
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1)
    xy32 = xy.astype(np.float32).astype(np.float64)
    oid = rng.integers(0, 500, n).astype(np.int64)
    args = (512, 10_000, 10)
    nat = tpanes.traj_stats_sliding(ts, xy32, oid, *args, backend="native",
                                    device=dev)
    taken = []
    real = tpanes._traj_stats_sliding_device

    def spy(*a, **k):
        taken.append(1)
        return real(*a, **k)

    tpanes._traj_stats_sliding_device = spy
    try:
        got = tpanes.traj_stats_sliding(ts, xy, oid, *args, device=dev)
    finally:
        tpanes._traj_stats_sliding_device = real
    assert taken == [1]
    assert np.array_equal(got.starts, nat.starts)
    assert np.array_equal(got.count, nat.count)
    assert np.array_equal(got.temporal, nat.temporal)
    bound = tpanes.pane_spatial_bound(ts, xy32, oid, *args)
    assert np.all(np.abs(got.spatial - nat.spatial) <= bound[None, :])


@pytest.mark.cuda
def test_kafka_to_run_wire_panes_on_card_equals_cpu():
    """Kafka records (``chip_smoke.MiniBroker``, the port's ``KafkaSink``
    and ``WireKafkaSource``) through ``WirePaneAssembler`` into
    ``run_wire_panes`` (B1) on the card, 2 windows of 2 panes, equal to
    the same panes run on the CPU through B1's plain version: ids in
    order, distance bits; B1 launched for each pane."""
    dev = _card()
    import importlib.util
    import itertools
    from pathlib import Path

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointKNNQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.wire_digest_kernel import wire_digest
    from spatialflink_tpu_torch.streams.kafka import (
        KafkaSink,
        WireKafkaSource,
    )
    from spatialflink_tpu_torch.streams.wire import (
        WireFormat,
        WirePaneAssembler,
    )

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    wf = WireFormat.for_grid(grid)
    rng = np.random.default_rng(31)
    n_pane, n_panes, nseg = 20_000, 3, 2048
    q = wf.quantize(np.stack([rng.uniform(115.5, 117.6, n_pane * n_panes),
                              rng.uniform(39.6, 41.1, n_pane * n_panes)],
                             axis=1))
    xy = wf.dequantize_np(q).astype(np.float64)
    oid = rng.integers(0, nseg, n_pane * n_panes)
    ts = (np.arange(n_pane * n_panes) * 1000) // n_pane
    broker = cs.MiniBroker()
    try:
        bs = f"127.0.0.1:{broker.port}"
        sink = KafkaSink("gps", bs, batch=4096)
        for t, x, y, o in zip(ts.tolist(), xy[:, 0].tolist(),
                              xy[:, 1].tolist(), oid.tolist()):
            sink(f"{t},{x!r},{y!r},{o}")
        sink.close()
        src = WireKafkaSource("gps", bs, lambda line: tuple(
            float(v) for v in line.split(",")))
        asm = WirePaneAssembler(wf, 1000, start_ms=0)
        fed = []
        records = iter(src)
        for batch in iter(lambda: list(itertools.islice(records, 4096)),
                          []):
            a = np.array(batch)
            fed += asm.feed({"ts": a[:, 0].astype(np.int64), "x": a[:, 1],
                             "y": a[:, 2], "oid": a[:, 3].astype(np.int64)})
            if len(fed) == n_panes - 1:
                break
        src.close()
    finally:
        broker.close()
    out = {}
    wire_digest.launches = 0
    for d in (dev, "cpu"):
        op = PointPointKNNQuery(QueryConfiguration(window_size=2.0,
                                                   slide_step=1.0), grid,
                                device=d)
        out[str(d)] = list(op.run_wire_panes(
            fed, Point(x=116.4, y=40.19), 0.05, 20, nseg, wf,
            flush_at_end=False))
    assert wire_digest.launches >= len(fed)
    got, want = out[str(dev)], out["cpu"]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and g[4] == w[4] == 20
        assert np.array_equal(g[2], w[2])
        assert np.array_equal(g[3].view(np.uint32), w[3].view(np.uint32))


@pytest.mark.cuda
def test_dag_zone_nodes_and_staytime_on_card_equal_cpu(tmp_path):
    """The composed DAG's device nodes over one window of the toy SNCB
    stream: q1, q2 and q5 (the float64 zone test) and StayTime (the
    segment-sum program) render the same lines on the card as on the CPU
    and as their numpy twins."""
    dev = _card()
    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch.streams.windows import WindowBatch

    evs = [e for e in dag_mod._toy_sncb_stream(360)()
           if getattr(e, "device_id", None) is not None]
    win = WindowBatch(0, 40_000, evs)
    card = dag_mod.build_sncb_dag(str(tmp_path / "card"), device=dev)
    cpu = dag_mod.build_sncb_dag(str(tmp_path / "cpu"), device="cpu")
    for name in ("q1", "q2", "q5", "staytime"):
        got = list(card.node(name).render(card.node(name).process(win, {}),
                                          0, 40_000))
        want = list(cpu.node(name).render(cpu.node(name).process(win, {}),
                                          0, 40_000))
        twin = list(card.node(name).render(
            card.node(name).fallback_process(win, {}), 0, 40_000))
        assert got == want == twin and got, name


@pytest.mark.cuda
def test_dag_run_on_card_equals_cpu(tmp_path):
    """The 7-node SNCB DAG on the toy stream, checkpointed every 2
    windows: every sink byte-identical to the CPU run, and no node
    retried, failed over or degraded on the card."""
    dev = _card()
    from spatialflink_tpu_torch import dag as dag_mod
    from spatialflink_tpu_torch import qserve
    from spatialflink_tpu_torch.driver import (
        RetryPolicy,
        WindowedDataflowDriver,
    )

    sinks = {}
    for tag, d in (("card", dev), ("cpu", "cpu")):
        out = tmp_path / tag
        dag = dag_mod.build_sncb_dag(str(out / "egress"), device=d)
        drv = WindowedDataflowDriver(
            checkpoint_path=str(out / "ck.bin"), checkpoint_every=2,
            sink=None, retry=RetryPolicy(max_retries=1, backoff_s=0.0),
            failover=False)
        try:
            for _ in dag.run(dag_mod._toy_sncb_stream()(), driver=drv):
                pass
            snap = dag.snapshot()
        finally:
            dag_mod.uninstall()
            qserve.uninstall()
        for rec in snap["nodes"].values():
            assert rec["backend"] == "device"
            assert rec["retries"] == rec["failovers"] == 0
            assert rec["degraded_windows"] == 0
        sinks[tag] = {n: (out / "egress" / f"{n}.csv").read_bytes()
                      for n in dag.dag_nodes}
    assert sinks["card"] == sinks["cpu"]
    assert all(sinks["card"].values())


def _card_mesh(shape=(4,), names=("data",)):
    """Four shards of the one card (``cuda:0`` listed once a shard)."""
    from spatialflink_tpu_torch.parallel import make_mesh

    return make_mesh(shape, names, devices=["cuda:0"] * int(np.prod(shape)))


@pytest.mark.cuda
def test_sharded_join_window_compact_b3_a_shard_on_card():
    """The mesh grid join on four shards of the card: B3 once a shard,
    the pair set with its distance bits equal to the unsharded
    ``join_window`` on the card, its overflow 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.ops.join_kernel import join_extract, join_window
    from spatialflink_tpu_torch.parallel.sharded import (
        sharded_join_window_compact,
    )

    rng = np.random.default_rng(19)
    grid = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
    dev = torch.device("cuda")
    a = rng.uniform(0, 10, (4096, 2)).astype(np.float32)
    b = rng.uniform(0, 10, (2048, 2)).astype(np.float32)
    r = 0.3
    cells_a = grid.assign_cells_np(a).astype(np.int32)
    cells_b = grid.assign_cells_np(b).astype(np.int32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    valid_a = torch.ones(4096, dtype=torch.bool, device=dev)
    valid_b = torch.ones(2048, dtype=torch.bool, device=dev)
    join_extract.launches = 0
    got = sharded_join_window_compact(
        _card_mesh(), t(a), valid_a, t(grid.cell_xy_indices_np(a)), t(b),
        valid_b, t(cells_b), grid.neighbor_offsets(r), grid_n=grid.n,
        radius=r, cap=64, max_pairs=1 << 16)
    assert join_extract.launches == 4
    want = join_window(t(a), valid_a, t(cells_a), t(b), valid_b, t(cells_b),
                       grid.n, grid.candidate_layers(r), r, 64, 64, 1 << 16)

    def pairs(res):
        li, ri, d = (x.cpu().numpy() for x in res[:3])
        keep = li >= 0
        return set(zip(li[keep].tolist(), ri[keep].tolist(),
                       d[keep].view(np.uint32).tolist()))

    assert pairs(got) == pairs(want) and pairs(want)
    assert int(got.overflow) == int(want.overflow) == 0


@pytest.mark.cuda
def test_sharded_b4_paths_a_shard_on_card():
    """B4 once a shard on four shards of the card: the dense polygon range
    window program and the gathered point ⋈ polygon join, each equal to
    its unsharded run on the card (keep masks and distance bits; the pair
    set with its distance bits)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from spatialflink_tpu_torch.operators.base import window_program
    from spatialflink_tpu_torch.ops import join as tjoin
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.range import range_polygons_fused
    from spatialflink_tpu_torch.parallel.sharded import (
        sharded_point_geometry_join_pruned,
    )

    rng = np.random.default_rng(20)
    dev = torch.device("cuda")
    n, p = 8192, 40
    xy = torch.from_numpy(rng.uniform(0, 10, (n, 2)).astype(np.float32))
    centres = rng.uniform(1, 9, (p, 2))
    ring = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1], [-1, -1]]) * 0.3
    verts = torch.from_numpy(
        (centres[:, None, :] + ring[None]).astype(np.float32))
    ev = torch.ones((p, 4), dtype=torch.bool)
    cell = torch.from_numpy(rng.integers(0, 400, n).astype(np.int32))
    flags = torch.from_numpy(rng.integers(0, 3, 401).astype(np.uint8))
    args = [x.to(dev) for x in (xy, torch.ones(n, dtype=torch.bool), cell,
                                flags, verts, ev)]
    polyline_min_dist.launches = 0
    got = window_program(_card_mesh(), range_polygons_fused, (0, 1, 2),
                         7)(*args, 0.2)
    assert polyline_min_dist.launches == 4
    want = range_polygons_fused(*args, 0.2)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    bbox = torch.cat([verts.amin(dim=1), verts.amax(dim=1)], dim=1)
    jargs = (args[0], args[1], args[4], args[5],
             torch.ones(p, dtype=torch.bool, device=dev), bbox.to(dev), 0.1)
    kw = dict(polygonal=True, block=256, cand=p, max_pairs=1 << 15,
              pair_cap=p)
    polyline_min_dist.launches = 0
    res = sharded_point_geometry_join_pruned(_card_mesh(), *jargs, **kw)
    assert polyline_min_dist.launches == 4
    one = tjoin.point_geometry_join_pruned_kernel(*jargs, **kw)

    def pairs(r):
        li, ri, d = (x.cpu().numpy() for x in r[:3])
        keep = li >= 0
        return set(zip(li[keep].tolist(), ri[keep].tolist(),
                       d[keep].view(np.uint32).tolist()))

    assert pairs(res) == pairs(one) and pairs(one)
    assert int(res.cand_overflow) == int(one.cand_overflow) == 0


#: One rank of the two-rank registry bucket on the card: it joins from
#: torch's launcher variables, runs ``sharded_registry_bucket`` on a 1-D
#: mesh spanning both ranks (two shards of ``cuda:0`` each) and on a
#: mesh of four ``cuda:0`` shards in this process, and holds every lane
#: bit-equal.
_CARD_RANK_CHILD = """
import numpy as np, torch
from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.batch import PointBatch
from spatialflink_tpu_torch.parallel import make_mesh
from spatialflink_tpu_torch.parallel import sharded as tsh
from spatialflink_tpu_torch.parallel.multihost import (
    global_mesh, initialize_distributed)

assert initialize_distributed()
span = global_mesh(["cuda:0"] * 2, (4,), ("data",))
one = make_mesh((4,), ("data",), devices=["cuda:0"] * 4)
grid = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
rng = np.random.default_rng(21)
b = PointBatch.from_arrays(rng.uniform(0, 10, (2000, 2)), None,
                           rng.integers(0, 100, 2000).astype(np.int32),
                           bucket=2048).with_cells(grid)
qxy = rng.uniform(0, 10, (64, 2))
tables = np.stack([grid.neighbor_flags(3.0, [grid.flat_cell(*p)])
                   for p in qxy])
radius = rng.uniform(0.5, 3.0, 64)
qvalid = rng.random(64) > 0.1
args = [torch.from_numpy(np.ascontiguousarray(a)).to("cuda:0") for a in (
    b.xy, b.valid, b.cell, tables, b.oid, qxy, radius, qvalid)]
got = tsh.sharded_registry_bucket(span, *args, k=8, num_segments=128)
want = tsh.sharded_registry_bucket(one, *args, k=8, num_segments=128)
for g, w in zip(got, want):
    assert g.device == w.device and torch.equal(g, w), (g, w)
assert int(want.within.sum()) > 0
print("CARD_SPAN_OK", torch.distributed.get_rank(), flush=True)
torch.distributed.destroy_process_group()
"""


@pytest.mark.cuda
def test_sharded_registry_bucket_on_two_ranks_of_the_card():
    """Phase 39c at toy size: two gloo ranks of ``cuda:0``, two shards
    each, equal to the one-process mesh of four shards of the card."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    _card()
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CARD_RANK_CHILD],
        cwd=Path(__file__).resolve().parents[1],
        env={**os.environ, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "WORLD_SIZE": "2",
             "RANK": str(rank)},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(outs)
    assert "CARD_SPAN_OK 0" in outs[0] and "CARD_SPAN_OK 1" in outs[1]


# ---------------------------------------------------------------------------
# The float64 mode: B3's and B4's double instantiations


def _bits(t):
    return t.view(torch.int64) if t.dtype == torch.float64 else \
        t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
def test_join_extract_float64_matches_plain_version_on_card():
    """B3's float64 instantiation bit-exact against its plain version on
    float64 planes, in order, within and over budget, at one and two
    layers, with points exactly on a float64 radius."""
    dev = _card()
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )

    rng = np.random.default_rng(16)
    gn, n = 16, 3000
    # On the 2^-36 lattice, so that +2^-3 is exact: d² == r² in float64.
    xys = [np.round(rng.uniform(-0.2, gn + 0.2, (n, 2)) * 2.0 ** 36)
           / 2.0 ** 36 for _ in range(2)]
    xys[1][:200] = xys[0][:200] + np.array([2.0 ** -3, 0.0])
    lanes = []
    for xy, (_, valid, cells) in zip(xys, [
            _unit_grid_lanes([xy], gn, dev) for xy in xys]):
        lanes += [torch.from_numpy(xy).to(dev), valid, cells]
    for radius, layers, cap, budget in ((2.0 ** -3, 1, 24, 8192),
                                        (0.4, 1, 24, 256),
                                        (1.5, 2, 8, 1 << 16)):
        planes, _ = join_planes(*lanes, grid_n=gn, layers=layers,
                                cap_left=cap, cap_right=cap)
        assert planes[0].dtype == torch.float64
        got = join_extract_cuda(*planes, gn, layers, radius, budget)
        want = join_extract_plain(*planes, gn, layers, radius, budget)
        torch.cuda.synchronize()
        assert int(want[3]) > 150 and got[2].dtype == torch.float64
        if radius == 2.0 ** -3:
            li, ri, dd = (t[:int(want[3])].cpu().numpy() for t in want[:3])
            on = (li == ri) & (li < 200)
            assert on.sum() > 100 and np.all(dd[on] == 2.0 ** -3)
        for g, w in zip(got, want):
            assert torch.equal(_bits(g).cpu(), _bits(w).cpu())


@pytest.mark.cuda
def test_join_extract_float64_at_tjoin_cap_64_on_card():
    """B3's float64 instantiation at tJoin's shape, cap 64 (a 20 B slot:
    17,408 B of shared memory a warp, past the default opt-in), bit-exact
    against its plain version on a 100 × 100 grid at one layer with
    crowded cells, within and over budget; then tJoin's float64
    ``run_soa`` and ``run`` on the card through it, equal to the CPU runs
    through the plain version, the float64 launches counted."""
    dev = _card()
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointTJoinQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract,
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )

    rng = np.random.default_rng(24)
    gn, n = 100, 40_000
    xys = [rng.uniform(0, gn, (n, 2)) for _ in range(2)]
    for xy in xys:  # two crowded cells, at ~44 and ~54 points
        xy[:40] = np.array([7.5, 7.5]) + rng.uniform(-0.49, 0.49, (40, 2))
        xy[40:90] = np.array([40.5, 3.5]) + rng.uniform(-0.49, 0.49,
                                                       (50, 2))
    lanes = []
    for xy in xys:
        cells = np.floor(xy).astype(np.int64)
        lanes += [torch.from_numpy(xy).to(dev),
                  torch.ones(n, dtype=torch.bool, device=dev),
                  torch.from_numpy((cells[:, 0] * gn + cells[:, 1])
                                   .astype(np.int32)).to(dev)]
    planes, over = join_planes(*lanes, grid_n=gn, layers=1, cap_left=64,
                               cap_right=64)
    assert planes[0].dtype == torch.float64 and int(over) == 0
    want = join_extract_plain(*planes, gn, 1, 0.3, 1 << 18)
    assert int(want[3]) > 8192
    for budget in (1 << 18, 4096):  # within and over budget: a prefix
        got = join_extract_cuda(*planes, gn, 1, 0.3, budget)
        torch.cuda.synchronize()
        assert got[2].dtype == torch.float64 and int(got[3]) == int(want[3])
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(_bits(g).cpu(), _bits(w[:budget]).cpu())

    grid = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
                max_y=41.1)
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)

    def side(seed):
        r = np.random.default_rng(seed)
        m = 5000
        return [{"ts": np.sort(r.integers(0, 1000, m)).astype(np.int64),
                 "x": r.uniform(116.0, 116.3, m),
                 "y": r.uniform(39.9, 40.1, m),
                 "oid": r.integers(0, 256, m).astype(np.int32)}]

    def runs(device):
        op = PointPointTJoinQuery(conf, UniformGrid(**grid), cap=64,
                                  device=device)
        left, right = side(1), side(2)
        pts = [[Point(obj_id=f"o{o}", timestamp=int(t), x=x, y=y)
                for t, x, y, o in zip(c["ts"][:2000], c["x"][:2000],
                                      c["y"][:2000], c["oid"][:2000])]
               for c in (left[0], right[0])]
        with precision.x64(True):
            soa = [(w[0], w[1], w[2].tolist(), w[3].tolist(),
                    w[4].view(np.int64).tolist(), w[5], w[6])
                   for w in op.run_soa(left, right, 0.001, 256)]
            run = [(w.start, w.end, [(a.obj_id, b.obj_id,
                                      np.float64(d).view(np.int64).item())
                                     for a, b, d in w.pairs])
                   for w in op.run(iter(pts[0]), iter(pts[1]), 0.001)]
        return soa, run

    join_extract.launches_f64 = 0
    card = runs("cuda")
    torch.cuda.synchronize()
    assert join_extract.launches_f64 >= 2
    cpu = runs("cpu")
    assert card == cpu
    assert sum(w[5] for w in cpu[0]) > 100 and all(w[6] == 0
                                                   for w in cpu[0])
    assert sum(len(w[2]) for w in cpu[1]) > 0


@pytest.mark.cuda
def test_polyline_min_dist_float64_matches_plain_version_on_card():
    """B4's float64 instantiation bit-exact against its plain version:
    dense, gathered staged and unstaged, and DBL_MAX for a boundary with
    no valid edge."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(18)
    for g, v, n in ((40, 8, 3001), (8, 4096, 2000), (3, 64, 777)):
        verts = rng.uniform(-1, 1, (g, v, 2)) + 116.0
        verts[:, 3] = verts[:, 2]  # zero-length edges
        ev = rng.random((g, v - 1)) > 0.2
        ev[-1] = False
        pts = rng.uniform(-1.2, 1.2, (n, 2)) + 116.0
        sel = rng.integers(0, g, (n, 5)).astype(np.int32)
        args = [torch.from_numpy(a).to(dev) for a in (pts, verts, ev)]
        for s in (None, torch.from_numpy(sel).to(dev)):
            got = polyline_min_dist_cuda(*args, s)
            want = polyline_min_dist_plain(*args, s)
            torch.cuda.synchronize()
            assert got.dtype == torch.float64
            assert torch.equal(_bits(got), _bits(want))
        dead = torch.from_numpy(sel[:, 0] == g - 1).to(dev)
        assert torch.all(got[dead][:, 0] == torch.finfo(torch.float64).max)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense", "G=1"])
def test_polyline_min_dist_float64_dense_and_g1_on_card(mode):
    """B4's float64 instantiation, dense, bit-exact against its plain
    version at the float64 geometry paths' shapes: every vertex of a
    window of packed boundaries (padding vertices at 0.0 included)
    against a query set of 32, the query vertices against the window's
    boundaries, and a pane of points against one query boundary (the kNN
    pane digest, G = 1); DBL_MAX for a boundary with no valid edge."""
    dev = _card()
    from spatialflink_tpu_torch.ops.polygon import pack_rings
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )

    rng = np.random.default_rng(20)

    def boundaries(g, pad_to, r_max):
        out = []
        for _ in range(g):
            m = int(rng.integers(4, 12))
            ang = np.sort(rng.uniform(0, 2 * np.pi, m))
            c = np.array([116.4, 40.2]) + rng.uniform(-0.3, 0.3, 2)
            ring = c + r_max * rng.uniform(0.3, 1.0, (m, 1)) * np.stack(
                [np.cos(ang), np.sin(ang)], axis=1)
            out.append(pack_rings([ring], pad_to=pad_to))
        verts = np.stack([v for v, _ in out])
        ev = np.stack([e for _, e in out])
        return verts, ev

    qv, qe = boundaries(32 if mode == "dense" else 1, 16, 0.03)
    qe[-1] = False  # a query boundary with no valid edge
    cases = []
    if mode == "dense":
        ov, oe = boundaries(3000, 16, 0.01)
        ov[~np.concatenate([oe, np.zeros((3000, 1), bool)], axis=1)
           & ~np.concatenate([np.zeros((3000, 1), bool), oe], axis=1)] = 0.0
        cases.append((ov.reshape(-1, 2), qv, qe))  # object vertices → queries
        cases.append((qv.reshape(-1, 2), ov, oe))  # query vertices → objects
    else:
        pts = np.array([116.4, 40.2]) + rng.uniform(-0.4, 0.4, (65_536, 2))
        qe[-1] = True
        cases.append((pts, qv, qe))
        cases.append((pts[:40_000], qv, np.zeros_like(qe)))
    for xy, verts, ev in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                for a in (xy, verts, ev)]
        got = polyline_min_dist_cuda(*args)
        want = polyline_min_dist_plain(*args)
        torch.cuda.synchronize()
        assert got.dtype == torch.float64 and got.shape == want.shape
        assert torch.equal(_bits(got), _bits(want))
        dead = ~args[2].any(dim=1)
        assert torch.all(got[:, dead] == torch.finfo(torch.float64).max)


@pytest.mark.cuda
def test_float64_geometry_operators_run_the_float64_kernels_on_card():
    """With the float64 mode on, the geometry-stream range and kNN, the
    point ⋈ polygon and polygon ⋈ polygon joins and the pane-carry kNN
    and join on the card go through B4's and B3's float64 kernels (dense,
    G = 1 and gathered) and equal the same runs on the CPU through the
    plain versions, distances bit for bit."""
    dev = _card()
    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point, Polygon
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    # A coarse grid: the pane join's plain version tests every slot pair
    # of its bucket planes.
    grid = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
                max_y=41.1)
    rng = np.random.default_rng(21)
    polys = generate_query_polygons(60, 115.5, 39.6, 117.6, 41.1, seed=4)
    stream = [Polygon(obj_id=f"g{i % 40}", timestamp=i * 3,
                      rings=[p.rings[0] + rng.uniform(-0.01, 0.01, 2)])
              for i, p in enumerate(polys * 5)]
    xy = np.stack([rng.uniform(115.5, 117.6, 3000),
                   rng.uniform(39.6, 41.1, 3000)], axis=1)
    pts = [Point(obj_id=f"o{i % 200}", timestamp=i // 3, x=x, y=y)
           for i, (x, y) in enumerate(xy)]
    other = [Point(obj_id=f"r{i % 200}", timestamp=i // 3, x=x + 0.004,
                   y=y) for i, (x, y) in enumerate(xy)]
    conf = ops.QueryConfiguration(window_size=0.5, slide_step=0.5)
    two = ops.QueryConfiguration(window_size=0.5, slide_step=0.25)

    def key(res):
        out = []
        for w in res:
            if hasattr(w, "dists"):
                out.append(([o.obj_id for o in w.objects],
                            np.asarray(w.dists).view(np.int64).tolist()))
            elif hasattr(w, "neighbors"):
                out.append([(a, np.float64(b).view(np.int64).item(),
                             c.obj_id) for a, b, c in w.neighbors])
            else:
                out.append(sorted((a.obj_id, b.obj_id,
                                   np.float64(d).view(np.int64).item())
                                  for a, b, d in w.pairs))
        return out

    def runs(device):
        g = UniformGrid(**grid)
        with precision.x64(True):
            return [
                key(ops.PolygonPolygonRangeQuery(conf, g, device=device).run(
                    iter(stream), polys[:8], 0.02)),
                key(ops.PolygonPointKNNQuery(conf, g, device=device).run(
                    iter(stream), Point(x=116.4, y=40.2), 0.5, 10)),
                key(ops.PointPolygonJoinQuery(conf, g, device=device).run(
                    iter(pts), iter(stream), 0.01)),
                key(ops.PolygonPolygonJoinQuery(conf, g, device=device).run(
                    iter(stream), iter(stream), 0.01)),
                key(ops.PointPolygonKNNQuery(two, g, device=device)
                    .query_panes(iter(pts), polys[0], 0.3, 10)),
                key(ops.PointPointJoinQuery(two, g, cap=48, device=device)
                    .query_panes(iter(pts), iter(other), 0.01)),
            ]

    polyline_min_dist.launches_f64 = join_extract.launches_f64 = 0
    card = runs("cuda")
    torch.cuda.synchronize()
    assert polyline_min_dist.launches_f64 >= 10
    assert join_extract.launches_f64 >= 3
    cpu = runs("cpu")
    assert card == cpu
    assert all(any(w for w in leg) for leg in cpu)


@pytest.mark.cuda
def test_float64_mode_runs_the_float64_kernels_on_card():
    """With the float64 mode on, the point-stream range (polygon query
    set), kNN (polygon query) and point–point join ``run_soa`` on the
    card go through B4's and B3's float64 kernels and equal the same runs
    on the CPU through the plain versions, window for window, distances
    bit for bit."""
    dev = _card()
    from spatialflink_tpu_torch import precision
    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point, Polygon
    from spatialflink_tpu_torch.operators import (
        PointPointJoinQuery,
        PointPolygonKNNQuery,
        PointPolygonRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    grid = dict(num_partitions=100, min_x=115.5, max_x=117.6, min_y=39.6,
                max_y=41.1)
    rng = np.random.default_rng(19)
    polys = generate_query_polygons(80, 115.5, 39.6, 117.6, 41.1, seed=3)
    n = 4000

    def stream():
        out = []
        for s in range(3):
            xy = np.stack([rng.uniform(115.5, 117.6, n),
                           rng.uniform(39.6, 41.1, n)], axis=1)
            out.append({"ts": np.arange(n, dtype=np.int64) * 1000 // n
                        + 1000 * s, "x": xy[:, 0], "y": xy[:, 1],
                        "oid": (np.arange(n) % 300).astype(np.int32)})
        return out

    chunks, right = stream(), stream()
    conf = QueryConfiguration(window_size=1.0, slide_step=1.0)

    def runs(device):
        g = UniformGrid(**grid)
        rng_op = PointPolygonRangeQuery(conf, g, device=device)
        knn_op = PointPolygonKNNQuery(conf, g, device=device)
        join_op = PointPointJoinQuery(conf, g, cap=48, device=device)
        pts = [Point(obj_id=f"o{i % 300}", timestamp=int(t), x=x, y=y)
               for c in chunks[:2]
               for i, (t, x, y) in enumerate(zip(c["ts"], c["x"], c["y"]))]
        with precision.x64(True):
            return (list(rng_op.run_soa(chunks, polys, 0.01)),
                    list(knn_op.run(iter(pts), Polygon(
                        obj_id="q", rings=[polys[0].rings[0] * 1.0]),
                        0.3, 20)),
                    list(join_op.run_soa(chunks, right, 0.01)))

    polyline_min_dist.launches = join_extract.launches = 0
    card = runs("cuda")
    torch.cuda.synchronize()
    assert polyline_min_dist.launches >= 3 + 2
    assert join_extract.launches >= 3
    cpu = runs("cpu")
    for g, w in zip(card[0], cpu[0]):
        assert g[:2] == w[:2] and g[3].dtype == np.float64
        assert np.array_equal(g[2]["oid"], w[2]["oid"])
        assert np.array_equal(g[3].view(np.int64), w[3].view(np.int64))
    assert sum(len(w[3]) for w in cpu[0]) > 0
    for g, w in zip(card[1], cpu[1]):
        assert [(a, b, c.obj_id) for a, b, c in g.neighbors] == \
            [(a, b, c.obj_id) for a, b, c in w.neighbors]
    assert sum(len(w.neighbors) for w in cpu[1]) > 0
    for g, w in zip(card[2], cpu[2]):
        assert g[:2] == w[:2] and g[5:] == w[5:] and g[4].dtype == np.float64
        for a, b in zip(g[2:5], w[2:5]):
            assert np.array_equal(a.view(np.int64) if a.dtype == np.float64
                                  else a, b.view(np.int64)
                                  if b.dtype == np.float64 else b)
    assert sum(w[5] for w in cpu[2]) > 0


# ---------------------------------------------------------------------------
# The float64 mode on a mesh: B3's and B4's float64 instantiations a shard


def _beijing_sides(rng, n_left, n_right):
    """Two float64 sides over the Beijing extent on its 100-grid: (xy,
    valid, cell) lanes on the card, raw, as the float64 mode ships them."""
    from spatialflink_tpu_torch.grid import UniformGrid

    grid = UniformGrid(100, 115.5, 117.6, 39.6, 41.1)
    dev = torch.device("cuda")
    lanes = []
    for n in (n_left, n_right):
        xy = np.stack([rng.uniform(115.5, 117.6, n),
                       rng.uniform(39.6, 41.1, n)], axis=1)
        lanes += [torch.from_numpy(xy).to(dev),
                  torch.ones(n, dtype=torch.bool, device=dev),
                  torch.from_numpy(grid.assign_cells_np(xy).astype(
                      np.int32)).to(dev)]
    return grid, lanes


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["join_shard", "tjoin_shard"])
def test_join_extract_float64_at_a_shard_shape_on_card(case):
    """B3's float64 instantiation at a shard's shape of the float64 mesh
    legs, bit-exact against its plain version within and over budget: a
    quarter of config 4's left side (32,768 points) against its whole
    right side (131,072) at r = 0.002, cap 48; a quarter of tJoin's
    window (51,200 against 204,800) at r = 0.001, cap 64."""
    _card()
    from spatialflink_tpu_torch.ops.join_kernel import (
        join_extract_cuda,
        join_extract_plain,
        join_planes,
    )

    n, m, r, cap = ((32_768, 131_072, 0.002, 48) if case == "join_shard"
                    else (51_200, 204_800, 0.001, 64))
    grid, lanes = _beijing_sides(np.random.default_rng(25), n, m)
    layers = grid.candidate_layers(r)
    planes, over = join_planes(*lanes, grid_n=grid.n, layers=layers,
                               cap_left=cap, cap_right=cap)
    assert planes[0].dtype == torch.float64 and int(over) == 0
    want = join_extract_plain(*planes, grid.n, layers, r, 1 << 18)
    count = int(want[3])
    assert count > 1000
    for budget in (1 << 18, count // 2):
        got = join_extract_cuda(*planes, grid.n, layers, r, budget)
        torch.cuda.synchronize()
        assert got[2].dtype == torch.float64 and int(got[3]) == count
        k = len(got[0])
        for g, w in zip(got[:3], want[:3]):
            assert torch.equal(_bits(g).cpu(), _bits(w[:k]).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["dense_1000", "gathered"])
def test_polyline_min_dist_float64_at_a_shard_shape_on_card(mode):
    """B4's float64 instantiation at a shard's shape of the float64 mesh
    legs, bit-exact against its plain version: a quarter of config 3's
    window (65,536 points) against its 1,000 polygons dense, as the mesh
    range runs them; a quarter of join_point_1000polygons' window (32,768
    points) gathered at 8 slots."""
    dev = _card()
    from spatialflink_tpu_torch.operators.base import pack_query_geometries
    from spatialflink_tpu_torch.ops.polyline_kernel import (
        polyline_min_dist_cuda,
        polyline_min_dist_plain,
    )
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    rng = np.random.default_rng(26)
    verts, ev = pack_query_geometries(generate_query_polygons(
        1000, 115.5, 39.6, 117.6, 41.1, seed=3))
    n = 65_536 if mode == "dense_1000" else 32_768
    xy = np.stack([rng.uniform(115.5, 117.6, n),
                   rng.uniform(39.6, 41.1, n)], axis=1)
    sel = None if mode == "dense_1000" else torch.from_numpy(
        rng.integers(0, 1000, (n, 8)).astype(np.int32)).to(dev)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in (xy, verts.astype(np.float64), ev)]
    got = polyline_min_dist_cuda(*args, sel)
    want = polyline_min_dist_plain(*args, sel)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    assert got.shape == (n, 1000 if sel is None else 8)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.cuda
def test_sharded_float64_b3_and_b4_a_shard_on_card():
    """The float64 mode's mesh programs on four shards of the card: the
    grid join through B3's float64 instantiation once a shard, and the
    dense polygon range window program through B4's once a shard, each
    equal to its unsharded run on the card bit for bit."""
    _card()
    from spatialflink_tpu_torch.operators.base import (
        pack_query_geometries,
        window_program,
    )
    from spatialflink_tpu_torch.ops.join_kernel import join_extract, join_window
    from spatialflink_tpu_torch.ops.polyline_kernel import polyline_min_dist
    from spatialflink_tpu_torch.ops.range import range_polygons_fused
    from spatialflink_tpu_torch.parallel.sharded import (
        sharded_join_window_compact,
    )
    from spatialflink_tpu_torch.utils.helper import generate_query_polygons

    rng = np.random.default_rng(27)
    grid, lanes = _beijing_sides(rng, 16_384, 8192)
    r = 0.01
    lxy, lv, lc, rxy, rv, rc = lanes
    in_grid = lv & (lc < grid.num_cells)
    join_extract.launches_f64 = 0
    got = sharded_join_window_compact(
        _card_mesh(), lxy, in_grid,
        torch.from_numpy(grid.cell_xy_indices_np(lxy.cpu().numpy())).to(
            lxy.device), rxy, rv, rc, grid.neighbor_offsets(r),
        grid_n=grid.n, radius=r, cap=64, max_pairs=1 << 16)
    assert join_extract.launches_f64 == 4
    want = join_window(lxy, lv, lc, rxy, rv, rc, grid.n,
                       grid.candidate_layers(r), r, 64, 64, 1 << 16)

    def pairs(res):
        li, ri, d = (x.cpu().numpy() for x in res[:3])
        keep = li >= 0
        return set(zip(li[keep].tolist(), ri[keep].tolist(),
                       d[keep].view(np.int64).tolist()))

    assert got.dist.dtype == torch.float64
    assert pairs(got) == pairs(want) and pairs(want)
    assert int(got.overflow) == int(want.overflow) == 0
    verts, ev = pack_query_geometries(generate_query_polygons(
        100, 115.5, 39.6, 117.6, 41.1, seed=3))
    dev = lxy.device
    flags = torch.from_numpy(rng.integers(0, 3, grid.num_cells + 1).astype(
        np.uint8)).to(dev)
    args = [lxy, lv, lc, flags,
            torch.from_numpy(verts.astype(np.float64)).to(dev),
            torch.from_numpy(ev).to(dev)]
    polyline_min_dist.launches_f64 = 0
    got = window_program(_card_mesh(), range_polygons_fused, (0, 1, 2),
                         7)(*args, r)
    assert polyline_min_dist.launches_f64 == 4
    want = range_polygons_fused(*args, r)
    assert got[1].dtype == torch.float64
    assert torch.equal(got[0], want[0])
    assert torch.equal(_bits(got[1]), _bits(want[1]))
