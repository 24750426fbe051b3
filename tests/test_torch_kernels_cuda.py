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
