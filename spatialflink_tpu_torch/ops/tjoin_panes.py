"""Pane-carry tJoin: the extreme-overlap sliding trajectory join.

The reference's windowBased tJoin walks the whole window on every fire
(tJoin/PointPointTJoinQuery.java:183+). At 10 s windows sliding every
10 ms (Q2_BrakeMonitor's window style, ppw = 1000 panes a window) that
is 1000× redundant work a slide, and so is ``TJoinQuery.run_soa``. This
module, the port of the JAX package's ``ops/tjoin_panes.py`` under the
same names, keeps the window state on the device and joins only the new
pane on each slide:

- **Ring-buffer bucket planes**, one set a stream side: ``cap_w`` slots a
  cell of x, y, oid and pane tag, and a write cursor a cell. A pane is
  inserted with one scatter; expiry is lazy (a slot whose tag left the
  window is dead, and is reused when the cursor comes round).
- **Min-pane-indexed pair digests**: row ``m % ppw`` of the digest ring
  holds, for each (left id, right id), the least point-pair distance
  among pairs whose earlier point lies in pane ``m``. A pair whose
  earlier point is in pane i lives in the windows starting at or before
  i, so the window ending at pane t is the minimum over the rows of
  panes (t - ppw, t], reduced through a second level of ``ppw / bs``
  block minima (``block_size``).
- **Per slide**: expire pane t - ppw from both sides' live counts, probe
  the new left pane against the right window, insert it, probe the new
  right pane against the left window (which now holds pane t, so each
  new × new pair is found once), insert it, and reduce the window.
- **Live-slot compaction** (``cap_c > 0``): a ring row is a FIFO (points
  enter and expire in pane order), so a cell's live slots are the range
  ``[cursor - live, cursor)`` modulo ``cap_w``; the compacted probe reads
  ``cap_c`` lanes from each neighbour cell's head and masks by position.
  ``cap_c = 0`` keeps the full-ring probe, which reads all ``cap_w``
  slots and masks by tag.

Exact, and equal to ``run_soa``, iff the three counters are 0:
``cap_overflow`` (a live slot was overwritten: grow ``cap_w``),
``sel_overflow`` (a probe point matched more than ``pair_sel`` window
points: grow ``pair_sel``) and ``cmp_overflow`` (a probed cell held more
than ``cap_c`` live points: climb the capacity ladder,
``ops/compaction.py``).

The JAX engine is plain ``jnp`` inside one ``lax.scan``, with no Pallas
kernel, so this port is plain PyTorch on the carry's device: a Python
loop over the slides that launches each step's operations and never
waits for the device (the slide index is a host integer; the counters
stay on the device until the caller reads them once). The step updates
the carry's tensors in place. Scatters that JAX drops out of range
(``mode="drop"``) land in one spare trailing slot of each target, which
every read leaves out. Distances are ``sqrt_rn(dx·dx + dy·dy)`` in
float32, correctly rounded on every device; the radius test compares
d² with ``radius_sq_bound``, which gives the same mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.ops.distances import sqrt_rn
from spatialflink_tpu_torch.ops.select import first_k_prefix_indices

#: Pane tag of a slot never written (far below any live window).
EMPTY_TAG = -(1 << 30)


def pane_cell_ranks(pane: np.ndarray, cell: np.ndarray,
                    valid: Optional[np.ndarray] = None) -> np.ndarray:
    """Rank of each event among the events of its (pane, cell), in input
    order: the slot offset ``_insert`` gives it past the cell's cursor
    (host numpy).

    ``valid``: invalid (out-of-grid) events are ranked in a group of
    their own, not in the cell their placeholder id names. ``_insert``
    drops them and advances the cursor by the valid count only, so a
    valid event ranked after an invalid one would land past the cursor,
    outside the live range the compacted probe reads."""
    n = len(pane)
    if valid is not None:
        cell = np.where(valid, cell, -1)
    order = np.lexsort((cell, pane))
    ps, cs = pane[order], cell[order]
    newrun = np.ones(n, bool)
    if n > 1:
        newrun[1:] = (ps[1:] != ps[:-1]) | (cs[1:] != cs[:-1])
    run_id = np.cumsum(newrun) - 1
    pos = np.arange(n)
    rank = np.empty(n, np.int64)
    rank[order] = pos - pos[newrun][run_id]
    return rank


class TJoinPaneCarry(NamedTuple):
    """The engine's state, on one device. Each tensor is the JAX carry's,
    flattened, with one spare trailing slot that absorbs the scatters'
    dropped lanes: the planes have ``cells·cap_w + 1`` slots, the cursors
    and live counts ``cells + 1``, the digests ``ppw·K² + 1`` and the
    block digests ``(ppw / bs)·K² + 1``."""

    lwx: torch.Tensor  # left window planes, float32
    lwy: torch.Tensor
    lwoid: torch.Tensor  # int32
    lwtag: torch.Tensor  # int32 pane index, EMPTY_TAG when never written
    lwcur: torch.Tensor  # int32 ring cursor a cell
    lwlive: torch.Tensor  # int32 unexpired points a cell
    rwx: torch.Tensor
    rwy: torch.Tensor
    rwoid: torch.Tensor
    rwtag: torch.Tensor
    rwcur: torch.Tensor
    rwlive: torch.Tensor
    digests: torch.Tensor  # float32, rows m % ppw of K² pair minima
    block_digests: torch.Tensor  # float32, row b: min of digest rows of b
    cap_overflow: torch.Tensor  # () int32
    sel_overflow: torch.Tensor  # () int32
    cmp_overflow: torch.Tensor  # () int32: probed cell live > cap_c


def block_size(ppw: int) -> int:
    """Digest-ring block length: the divisor of ``ppw`` nearest below
    √ppw, so a slide's reduce (one block recomputed, bs·K², and the
    minimum over the ppw/bs block rows) costs ~2√ppw·K² instead of
    ppw·K². A prime ppw gives 1, the flat reduce."""
    best = 1
    for d in range(1, int(ppw ** 0.5) + 1):
        if ppw % d == 0:
            best = d
    return best


def tjoin_pane_init(num_cells: int, cap_w: int, ppw: int, num_ids: int,
                    dtype=None, device="cuda") -> TJoinPaneCarry:
    """A fresh carry on ``device``. ``num_ids``: the interned trajectory
    ids (K), shared by both sides. ``dtype`` is accepted for the JAX
    signature: the port computes in float32."""
    del dtype
    dev = torch.device(device)
    slots = num_cells * cap_w + 1
    p = num_ids * num_ids

    def zeros(n, dt):
        return torch.zeros(n, dtype=dt, device=dev)

    def side():
        return (zeros(slots, torch.float32), zeros(slots, torch.float32),
                zeros(slots, torch.int32),
                torch.full((slots,), EMPTY_TAG, dtype=torch.int32,
                           device=dev),
                zeros(num_cells + 1, torch.int32),
                zeros(num_cells + 1, torch.int32))

    inf = float("inf")
    return TJoinPaneCarry(
        *side(), *side(),
        torch.full((ppw * p + 1,), inf, device=dev),
        torch.full((ppw // block_size(ppw) * p + 1,), inf, device=dev),
        zeros((), torch.int32), zeros((), torch.int32),
        zeros((), torch.int32),
    )


def _cell_counts(live, pcell, pvalid, num_cells: int, sign: int):
    """``live[c] += sign`` for each valid point of a pane, in place: the
    live-count invariant ``live[c]`` = points of cell c in the window.
    Invalid points go to the spare slot ``num_cells``."""
    ones = torch.full(pcell.shape, sign, dtype=torch.int32,
                      device=pcell.device)
    return live.index_add_(0, torch.where(pvalid, pcell, num_cells), ones)


def _neighbour_rows(pxi, pyi, grid_n: int, layers: int):
    """Each probe point's span² neighbour cells, dx-major: (in_grid,
    rows), both (PC, span²), rows int64 (an index that torch would
    otherwise convert at every gather) clamped into the grid."""
    span = 2 * layers + 1
    offs = torch.arange(-layers, layers + 1, dtype=torch.int32,
                        device=pxi.device)
    nx = pxi[:, None, None] + offs[None, :, None]  # (PC, span, 1)
    ny = pyi[:, None, None] + offs[None, None, :]  # (PC, 1, span)
    in_grid = (((nx >= 0) & (nx < grid_n))
               & ((ny >= 0) & (ny < grid_n))).reshape(-1, span * span)
    rows = (nx * grid_n + ny).clamp_(0, grid_n * grid_n - 1).reshape(
        -1, span * span)
    return in_grid, rows.long()


def _ring_mod(x, cap_w: int):
    """``x`` floor-modulo ``cap_w``: a bit mask when ``cap_w`` is a power
    of two (two's complement makes it the floor modulo of negative ``x``
    too), which spares the integer division on the probe's largest
    tensor."""
    if cap_w & (cap_w - 1) == 0:
        return x & (cap_w - 1)
    return torch.remainder(x, cap_w)


def _digest_keys(st, so, poid, count, swap_pair: bool, ppw: int,
                 num_ids: int, pair_sel: int):
    """Flat digest keys ``(st mod ppw)·K² + lid·K + rid`` of the selected
    matches, int32; slots past a point's match count take the sentinel
    ``ppw·K²`` (the digests' spare slot). ``mod`` is floor modulo: the
    tag is a pane index, negative before pane 0."""
    p = num_ids * num_ids
    svalid = (torch.arange(pair_sel, dtype=torch.int32, device=st.device)
              [None, :] < count[:, None])
    a = poid[:, None]
    lid, rid = (so, a) if swap_pair else (a, so)
    flat = torch.remainder(st, ppw) * p + lid * num_ids + rid
    return torch.where(svalid, flat, ppw * p).reshape(-1)


def radius_sq_bound(radius) -> float:
    """The largest float32 d² whose correctly rounded root is at most the
    float32 radius. The rounded root is nondecreasing, so ``sqrt_rn(d2)
    <= r`` exactly when ``d2 <= radius_sq_bound(r)``: the probes test d²
    against it and take roots at the selected lanes only."""
    r = np.float32(radius)
    if not r >= 0:  # negative or NaN: no distance is within it
        return -1.0
    if np.isinf(r):
        return float("inf")
    up, down = np.float32(np.inf), np.float32(0)
    x = r * r
    while np.sqrt(x) > r:
        x = np.nextafter(x, down)
    while np.sqrt(np.nextafter(x, up)) <= r:
        x = np.nextafter(x, up)
    return float(x)


def _d2(gx, gy, px, py):
    """dx·dx + dy·dy in float32, one rounding an operation, in the
    gathered ``gx`` and ``gy`` (fresh tensors, overwritten)."""
    gx.sub_(px[:, None, None]).square_()
    return gx.add_(gy.sub_(py[:, None, None]).square_())


def _probe(wx, wy, woid, wtag, t: int, px, py, pxi, pyi, poid, pvalid,
           radius, swap_pair: bool, grid_n: int, cap_w: int, layers: int,
           ppw: int, num_ids: int, pair_sel: int):
    """Full-ring probe: the new pane's points against every slot of their
    neighbour cells' ring rows, alive by tag (panes (t - ppw, t]).
    Returns (flat digest keys, distances, sel_overflow), each point's
    first ``pair_sel`` matches in (cell, slot) order."""
    pc = px.shape[0]
    in_grid, rows = _neighbour_rows(pxi, pyi, grid_n, layers)
    cells = grid_n * grid_n

    def w2(a):
        return a[:-1].view(cells, cap_w)[rows]  # (PC, span², cap_w)

    gtag = w2(wtag)
    d2 = _d2(w2(wx), w2(wy), px, py)
    mask = d2 <= radius_sq_bound(radius)
    mask &= (gtag > t - ppw) & (gtag <= t)
    mask &= (pvalid[:, None] & in_grid)[:, :, None]
    ci, count, sel_over = first_k_prefix_indices(mask.reshape(pc, -1),
                                                 pair_sel)
    ci = ci.long()
    sd = sqrt_rn(torch.take_along_dim(d2.reshape(pc, -1), ci, dim=1))
    st = torch.take_along_dim(gtag.reshape(pc, -1), ci, dim=1)
    # The oid only of the selected slots: an element gather through the
    # global slot ids instead of a third (PC, span², cap_w) row gather.
    grows = torch.take_along_dim(rows, ci // cap_w, dim=1)
    so = woid[grows * cap_w + ci % cap_w]
    flat = _digest_keys(st, so, poid, count, swap_pair, ppw, num_ids,
                        pair_sel)
    return flat, sd.reshape(-1), sel_over


def _probe_compact(wx, wy, woid, wtag, wcur, wlive, px, py, pxi, pyi, poid,
                   pvalid, radius, swap_pair: bool, grid_n: int, cap_w: int,
                   cap_c: int, layers: int, ppw: int, num_ids: int,
                   pair_sel: int):
    """Compacted probe: ``cap_c`` lanes from each neighbour cell's live
    head, alive by position (lane < live), tags and oids gathered only at
    the selected lanes. The same selected sets and sel_overflow as
    ``_probe``, plus ``cmp_overflow``: live points past ``cap_c`` in a
    probed cell, which the probe could not see."""
    pc = px.shape[0]
    in_grid, rows = _neighbour_rows(pxi, pyi, grid_n, layers)
    live = wlive[rows]
    ghead = _ring_mod(wcur[rows] - live, cap_w)  # (PC, span²)
    glive = torch.where(pvalid[:, None] & in_grid, live, 0)
    cmp_over = (glive - cap_c).clamp_(min=0).sum(dtype=torch.int32)
    lane = torch.arange(cap_c, dtype=torch.int64, device=px.device)
    gidx = rows[:, :, None] * cap_w + _ring_mod(
        ghead[:, :, None] + lane, cap_w)  # (PC, span², cap_c)
    d2 = _d2(wx[gidx], wy[gidx], px, py)
    mask = d2 <= radius_sq_bound(radius)
    mask &= lane < glive[:, :, None]
    ci, count, sel_over = first_k_prefix_indices(mask.reshape(pc, -1),
                                                 pair_sel)
    ci = ci.long()
    sd = sqrt_rn(torch.take_along_dim(d2.reshape(pc, -1), ci, dim=1))
    gsel = torch.take_along_dim(gidx.reshape(pc, -1), ci, dim=1)
    flat = _digest_keys(wtag[gsel], woid[gsel], poid, count, swap_pair, ppw,
                        num_ids, pair_sel)
    return flat, sd.reshape(-1), sel_over, cmp_over


def _insert(wx, wy, woid, wtag, wcur, t: int, px, py, pcell, prank, poid,
            pvalid, cap_w: int, ppw: int):
    """Scatter one pane into a side's ring planes, in place; returns the
    count of live points lost (the ``cap_overflow`` term). Two ways to
    lose one: overwriting a slot whose point is still in the window, and
    more than ``cap_w`` points of one pane in one cell (ranks wrap and
    collide within this scatter, which the tag check cannot see).
    Invalid points go to the spare slot."""
    spare = wx.shape[0] - 1
    pcell = pcell.long()
    slot = _ring_mod(wcur[pcell] + prank, cap_w)
    fi = torch.where(pvalid, pcell * cap_w + slot, spare)
    lost = ((pvalid & (wtag[fi] > t - ppw)).sum(dtype=torch.int32)
            + (pvalid & (prank >= cap_w)).sum(dtype=torch.int32))
    wx[fi] = px
    wy[fi] = py
    woid[fi] = poid
    wtag.index_fill_(0, fi, t)
    _cell_counts(wcur, pcell, pvalid, wcur.shape[0] - 1, 1)
    return lost


def tjoin_pane_step(carry: TJoinPaneCarry, xs, radius, grid_n: int,
                    cap_w: int, layers: int, ppw: int, num_ids: int,
                    pair_sel: int, cap_c: int = 0, axis_name=None,
                    out: Optional[torch.Tensor] = None):
    """One slide, in place on ``carry``: probe and insert both sides, and
    reduce the window ending at pane t.

    ``xs`` = (t, left pane, right pane, left expiring, right expiring):
    t a host int; each pane the (x, y, xi, yi, cell, rank, oid, valid)
    tensors of one fixed capacity; each expiring pane the (cell, valid)
    of pane t - ppw, which keeps the live counts exact. ``cap_c`` > 0
    probes through ``_probe_compact``, 0 through ``_probe``: the same
    results whenever the counters are 0. Returns (carry, the window's
    (K²,) pair minima), written into ``out`` when given. ``axis_name``
    (the JAX probe-parallel mesh step) is not ported: ROADMAP A12."""
    if axis_name is not None:
        raise NotImplementedError(
            "axis_name= (probe-parallel multi-GPU tJoin) is not ported yet: "
            "ROADMAP A12")
    t, lp, rp, lxp, rxp = xs
    t = int(t)
    radius = float(np.float32(radius))
    cells = grid_n * grid_n
    p = num_ids * num_ids
    bs = block_size(ppw)
    # Expire pane t - ppw on both sides before any probe: the window is
    # (t - ppw, t], so its points are dead for every probe of this slide.
    _cell_counts(carry.lwlive, lxp[0], lxp[1], cells, -1)
    _cell_counts(carry.rwlive, rxp[0], rxp[1], cells, -1)
    dig = carry.digests[:-1].view(ppw, p)
    blk = carry.block_digests[:-1].view(ppw // bs, p)
    r = t % ppw
    # Ring row r held pane t - ppw: reset it, and recompute the one block
    # minimum it invalidated (every other block's carries over; the
    # scatter-mins below update both levels).
    dig[r].fill_(float("inf"))
    b = r // bs
    torch.amin(dig[b * bs:(b + 1) * bs], dim=0, out=blk[b])

    def probe(w, live, pane, swap):
        # w: (x, y, oid, tag, cursor) of the side probed.
        if cap_c > 0:
            return _probe_compact(
                w[0], w[1], w[2], w[3], w[4], live, pane[0], pane[1],
                pane[2], pane[3], pane[6], pane[7], radius, swap, grid_n,
                cap_w, cap_c, layers, ppw, num_ids, pair_sel)
        return (*_probe(w[0], w[1], w[2], w[3], t, pane[0], pane[1],
                        pane[2], pane[3], pane[6], pane[7], radius, swap,
                        grid_n, cap_w, layers, ppw, num_ids, pair_sel),
                None)

    def digest(flat, dist):
        # flat // P // bs · P + flat % P: the sentinel ppw·P maps to
        # (ppw / bs)·P, the block digests' spare slot.
        bflat = torch.div(flat, p * bs, rounding_mode="floor") * p + flat % p
        carry.digests.scatter_reduce_(0, flat.long(), dist, "amin")
        carry.block_digests.scatter_reduce_(0, bflat.long(), dist, "amin")

    left = (carry[0:5], carry.lwlive)
    right = (carry[6:11], carry.rwlive)
    # Direction A: the new left pane × the right window (panes < t), then
    # the left pane's insert; direction B: the new right pane × the left
    # window (panes ≤ t, the left pane just inserted included, so each
    # new × new pair is found once), then the right pane's insert.
    for pane, (probed, probed_live), (own, own_live), swap in (
            (lp, right, left, False), (rp, left, right, True)):
        flat, dist, sel, cmp = probe(probed, probed_live, pane, swap)
        digest(flat, dist)
        carry.cap_overflow.add_(_insert(
            *own, t, pane[0], pane[1], pane[4], pane[5], pane[6], pane[7],
            cap_w, ppw))
        _cell_counts(own_live, pane[4], pane[7], cells, 1)
        carry.sel_overflow.add_(sel)
        if cmp is not None:
            carry.cmp_overflow.add_(cmp)
    # The window ending at pane t: the minimum over every block (a min of
    # mins, exact).
    wmin = torch.amin(blk, dim=0, out=out)
    return carry, wmin


def expired_pane_fields(cells_arr: torch.Tensor, valid_arr: torch.Tensor,
                        ppw: int):
    """(cell, valid) of the pane expiring at each slide of a scan whose
    carry started empty: the same tensors shifted by ``ppw`` slides,
    nothing expiring in the first ``ppw``. A scan that continues a
    non-empty carry must pass the expiring panes of the earlier slides
    itself."""
    s = cells_arr.shape[0]
    pad = min(ppw, s)
    zc = cells_arr.new_zeros((pad,) + tuple(cells_arr.shape[1:]))
    zv = valid_arr.new_zeros((pad,) + tuple(valid_arr.shape[1:]))
    if s > ppw:
        return (torch.cat([zc, cells_arr[:s - ppw]]),
                torch.cat([zv, valid_arr[:s - ppw]]))
    return zc, zv


def tjoin_pane_scan(carry: TJoinPaneCarry, ts, lps: Sequence[torch.Tensor],
                    rps: Sequence[torch.Tensor], radius, grid_n: int,
                    cap_w: int, layers: int, ppw: int, num_ids: int,
                    pair_sel: int, cap_c: int = 0, lps_expire=None,
                    rps_expire=None, mesh=None):
    """``tjoin_pane_step`` over a batch of slides, in place on ``carry``.

    ``ts``: (S,) pane indices (host ints, or a tensor read once);
    ``lps``/``rps``: per-field (S, PC) tensors on the carry's device (x,
    y, xi, yi, cell, rank, oid, valid). Returns (carry, (S, K²) window
    pair minima). ``cap_c``: the live-slot probe capacity
    (``ops/compaction.py``; 0 = the full-ring probe).

    ``lps_expire``/``rps_expire``: the (cell, valid) tensors of the pane
    expiring at each slide, (S, PC) each, required when the carry already
    holds panes of an earlier scan; by default they come from this
    batch's own panes (``expired_pane_fields``: right iff the carry
    started empty). ``mesh`` (JAX's probe-parallel execution) is not
    ported: ROADMAP A12."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (probe-parallel multi-GPU tJoin) is not ported yet: "
            "ROADMAP A12")
    if torch.is_tensor(ts):
        ts = ts.tolist()
    if lps_expire is None:
        lps_expire = expired_pane_fields(lps[4], lps[7], ppw)
    if rps_expire is None:
        rps_expire = expired_pane_fields(rps[4], rps[7], ppw)
    s = len(ts)
    wmins = torch.empty((s, num_ids * num_ids), dtype=torch.float32,
                        device=carry.digests.device)
    rows = [tuple(zip(*(f.unbind(0) for f in fields)))
            for fields in (lps, rps, lps_expire, rps_expire)]
    for i, t in enumerate(ts):
        tjoin_pane_step(
            carry, (t, rows[0][i], rows[1][i], rows[2][i], rows[3][i]),
            radius, grid_n, cap_w, layers, ppw, num_ids, pair_sel, cap_c,
            out=wmins[i])
    return carry, wmins

