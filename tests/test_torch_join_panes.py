"""Parity of the PyTorch port's pane-carry point join,
``PointPointJoinQuery.query_panes``, with the JAX package.

The same ``Point`` streams, made with numpy from a seed, go through the
JAX operator and the port. The JAX operator runs its Pallas join in
interpret mode (``join_backend="pallas_interpret"``), whose pair order
the port's join kernel keeps (``tests/test_torch_join.py``); the port
runs on the CPU, where the kernel's wrapper takes its plain version.

Contracts held:
- ``query_panes`` against the JAX ``query_panes``: the same windows
  (starts, ends, overflow, event counts), the pairs in the same order
  (block-major over the window's (left pane, right pane) blocks), the
  same ids and timestamps, distances within 1 ulp;
- ``query_panes`` against the port's own ``run``: the same pairs as a
  multiset in every window (overflow 0), distances bit-equal;
- ``ValueError`` where the JAX version raises: allowed lateness above 0,
  windows other than WindowBased, ``size % slide != 0``;
- ``state.join_pane_carry_from_jax``: a JAX ``query_panes`` run cut with
  ``flush_at_end=False`` continues in the port with the JAX carry, each
  JAX event one shared port object, yielding the uncut JAX run's later
  windows.
"""

from collections import Counter

import numpy as np
import pytest

from spatialflink_tpu.grid import UniformGrid as JGrid
from spatialflink_tpu.models.objects import Point as JPoint
from spatialflink_tpu.operators import PointPointJoinQuery as JJoin
from spatialflink_tpu.operators import QueryConfiguration as JConf
from spatialflink_tpu.operators import QueryType as JQT

from spatialflink_tpu_torch.grid import UniformGrid
from spatialflink_tpu_torch.models.objects import Point
from spatialflink_tpu_torch.operators import (
    PointPointJoinQuery,
    QueryConfiguration,
    QueryType,
)
from spatialflink_tpu_torch.state import (
    interner_from_jax,
    join_pane_carry_from_jax,
)

# A coarse grid over the Beijing extent (cells of 0.13125 deg) keeps the
# JAX interpret-mode join small; R is one candidate layer.
COARSE = dict(num_partitions=16, min_x=115.5, max_x=117.6, min_y=39.6,
              max_y=41.1)
R = 0.05
CAP = 32
PANES = dict(window_size=2.0, slide_step=1.0)


def _streams(seed, n=600, t_span=5000):
    """Two ``Point`` streams over ``t_span`` ms, in time order, ids over
    200 objects a side: (port left, port right, JAX left, JAX right)."""
    rng = np.random.default_rng(seed)
    out = ([], [], [], [])
    for side in range(2):
        ts = np.sort(rng.integers(0, t_span, n))
        xy = np.stack([rng.uniform(116.0, 117.0, n),
                       rng.uniform(40.0, 40.8, n)], axis=1)
        for i, (t, (x, y)) in enumerate(zip(ts.tolist(), xy.tolist())):
            meta = dict(obj_id=f"{'lr'[side]}{i % 200}", timestamp=t)
            out[side].append(Point(x=x, y=y, **meta))
            out[side + 2].append(JPoint(x=x, y=y, **meta))
    return out


def _ops(**conf_kw):
    conf = dict(PANES, **conf_kw)
    return (PointPointJoinQuery(QueryConfiguration(**conf),
                                UniformGrid(**COARSE), cap=CAP,
                                device="cpu"),
            JJoin(JConf(**conf), JGrid(**COARSE), cap=CAP,
                  join_backend="pallas_interpret"))


def _keys(res):
    return [(a.obj_id, a.timestamp, b.obj_id, b.timestamp)
            for a, b, _ in res.pairs]


def _within_ulp(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= ulp))


def _same_windows(got, want, counts=True):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.start, g.end, g.overflow) == (w.start, w.end, w.overflow)
        if counts:
            assert g.window_count == w.window_count
        assert _keys(g) == _keys(w)
        assert _within_ulp([d for *_, d in g.pairs],
                           [d for *_, d in w.pairs])


def test_query_panes_matches_jax_in_order():
    left, right, jleft, jright = _streams(41)
    op, jop = _ops()
    got = list(op.query_panes(iter(left), iter(right), R))
    want = list(jop.query_panes(iter(jleft), iter(jright), R,
                                dtype=np.float32))
    assert len(got) == 6  # [-1000, 1000) ... [4000, 6000)
    _same_windows(got, want)
    assert sum(len(w.pairs) for w in got) > 500
    assert all(w.overflow == 0 for w in got)
    carry = op._join_pane_carry
    assert sorted(carry) == ["blocks", "panes"]
    jcarry = jop._join_pane_carry
    assert sorted(carry["panes"]) == sorted(jcarry["panes"]) == [4000, 5000]
    assert sorted(carry["blocks"]) == sorted(jcarry["blocks"])


@pytest.mark.parametrize("seed,n", [(43, 600), (44, 150)])
def test_query_panes_equals_run_as_multisets(seed, n):
    left, right, _, _ = _streams(seed, n=n)
    op, _ = _ops()
    panes = list(op.query_panes(iter(left), iter(right), R))
    run_op, _ = _ops()
    runs = list(run_op.run(iter(left), iter(right), R))
    assert [(w.start, w.end, w.window_count, w.overflow) for w in panes] == \
        [(w.start, w.end, w.window_count, w.overflow) for w in runs]
    for p, r in zip(panes, runs):
        def multiset(res):
            return Counter((*k, np.float32(d).view(np.uint32).item())
                           for k, (*_, d) in zip(_keys(res), res.pairs))
        assert multiset(p) == multiset(r)
    assert sum(len(w.pairs) for w in panes) > 20


@pytest.mark.parametrize("conf_kw", [
    dict(allowed_lateness=0.5),
    dict(query_type="RealTime"),
    dict(window_size=2.5),
])
def test_query_panes_rejects_what_jax_rejects(conf_kw):
    kw = dict(conf_kw)
    qt = kw.pop("query_type", "WindowBased")
    op, jop = (
        PointPointJoinQuery(QueryConfiguration(**dict(PANES, **kw),
                                               query_type=QueryType[qt]),
                            UniformGrid(**COARSE), device="cpu"),
        JJoin(JConf(**dict(PANES, **kw), query_type=JQT[qt]),
              JGrid(**COARSE)))
    for o in (op, jop):
        with pytest.raises(ValueError):
            list(o.query_panes(iter([]), iter([]), R))


def test_join_pane_carry_from_jax_continues_the_jax_windows():
    """A JAX ``query_panes`` run cut at 3.2 s with ``flush_at_end=False``
    leaves its open panes and their blocks in ``_join_pane_carry``. Moved
    to a port operator with the interner, the carry is reused: fed the
    stream from the earliest open window's second pane, the port yields
    the windows the JAX run would have yielded (equal to the uncut JAX
    run), and their pairs from the carried panes are the carried
    objects."""
    left, right, jleft, jright = _streams(45)
    _, full_op = _ops()
    full = list(full_op.query_panes(iter(jleft), iter(jright), R,
                                    dtype=np.float32))
    _, jop = _ops()
    head = list(jop.query_panes(
        iter([p for p in jleft if p.timestamp < 3200]),
        iter([p for p in jright if p.timestamp < 3200]), R,
        dtype=np.float32, flush_at_end=False))
    assert [w.end for w in head] == [1000, 2000, 3000]
    assert sorted(jop._join_pane_carry["panes"]) == [1000, 2000]
    op, _ = _ops()
    op.interner = interner_from_jax(jop)
    op._join_pane_carry = join_pane_carry_from_jax(jop, op)
    panes, blocks = (op._join_pane_carry[k] for k in ("panes", "blocks"))
    assert sorted(blocks) == sorted(jop._join_pane_carry["blocks"])
    lev, rev, lb, rb = panes[1000]
    jlev, jrev, jlb, _ = jop._join_pane_carry["panes"][1000]
    assert [(p.obj_id, p.timestamp, p.x, p.y) for p in lev] == \
        [(p.obj_id, p.timestamp, p.x, p.y) for p in jlev]
    assert np.array_equal(lb.xy, jlb.xy) and np.array_equal(lb.oid, jlb.oid)
    carried = {id(ev) for pane in panes.values() for ev in pane[0] + pane[1]}
    # The blocks' pairs share the pane lists' objects.
    assert all(id(a) in carried and id(b) in carried
               for pairs, _ in blocks.values() for a, b, _ in pairs)
    got = list(op.query_panes(
        iter([p for p in left if p.timestamp >= 2000]),
        iter([p for p in right if p.timestamp >= 2000]), R))
    # The re-fired [1000, 3000) window: the JAX head emitted it already;
    # its pairs all come from the carried blocks.
    assert (got[0].start, got[0].end) == (1000, 3000)
    _same_windows(got[:1], [head[-1]], counts=False)
    tail = [w for w in full if w.start >= 2000]
    _same_windows(got[1:], tail)
    _same_windows(head, full[:3])
    assert any(id(a) in carried for a, _, _ in got[1].pairs)
