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
                                  device="cpu")
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
                                            cap_w=64, cap_c=cap_c))
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
