"""The CheckIn app's count-window pipeline as tensor operations.

The reference's CheckIn demo (apps/CheckIn.java:26-60) is two count
windows: a per-user count(2, 1) pass that synthesizes a missed opposite
door event between two consecutive same-door events (CheckIn.java:
251-321), then a per-room running occupancy counter (CheckIn.java:
208-249). ``apps/checkin.py:check_in_query`` walks the events one by one
on the host; ``check_in_kernel`` runs a whole batch as a few PyTorch
operations on the events' device, as the JAX package's ``ops/checkin.py``
runs it as one jitted program (plain ``jnp``, no Pallas kernel):

- consecutive events of a user: a stable sort by user (the stream order
  survives within a user) and a neighbour compare;
- the emission sequence is 2n slots (slot 2i the optional synthesized
  event, slot 2i+1 event i), masked, not compacted;
- each room's running occupancy: a stable sort of the slots by room, a
  cumulative sum, each room's segment rebased to its first slot, and
  the result scattered back to slot order.

Both sorts must be stable: the order of the stream inside a user and
inside a room is the result.
"""

from __future__ import annotations

import torch


def check_in_kernel(user: torch.Tensor, room: torch.Tensor,
                    dirn: torch.Tensor, ts: torch.Tensor,
                    valid: torch.Tensor, num_rooms: int):
    """(n,) interned event tensors → (2n,) emission-slot tensors.

    ``user``/``room``: dense int ids; ``dirn``: +1 ("-in") / -1
    ("-out"); ``ts``: int64 ms; ``valid``: the padding mask. Returns
    ``(out_room, out_dir, out_ts, out_valid, occupancy)``: slot 2i holds
    the opposite event synthesized before event i at the midpoint of its
    user's previous event and it (valid only when the two were of the
    same door), slot 2i+1 event i; ``occupancy`` (int32) is the room's
    running count after the slot's event. The emission order and values
    are the host walk's."""
    n = user.shape[0]
    dev = user.device
    big = torch.iinfo(torch.int32).max
    order = torch.sort(torch.where(valid, user.int(), big),
                       stable=True).indices
    u_s, r_s, d_s = user[order], room[order], dirn[order]
    t_s, v_s = ts[order], valid[order]
    samep = torch.zeros(n, dtype=torch.bool, device=dev)
    samep[1:] = ((u_s[1:] == u_s[:-1]) & (r_s[1:] == r_s[:-1])
                 & (d_s[1:] == d_s[:-1]) & v_s[1:] & v_s[:-1])
    prev_t = torch.cat([t_s[:1], t_s[:-1]])
    # Midpoint (CheckIn.java:286-305); floor division as Java's on
    # non-negative times and as the JAX ``//``.
    mid_s = torch.div(prev_t + t_s, 2, rounding_mode="floor")
    synth = torch.zeros(n, dtype=torch.bool, device=dev)
    synth[order] = samep
    mid = torch.zeros(n, dtype=ts.dtype, device=dev)
    mid[order] = mid_s

    out_room = torch.stack([room, room], dim=1).reshape(-1)
    out_dir = torch.stack([-dirn, dirn], dim=1).reshape(-1)
    out_ts = torch.stack([mid, ts], dim=1).reshape(-1)
    out_valid = torch.stack([synth & valid, valid], dim=1).reshape(-1)

    # Invalid slots key to the spare segment num_rooms, after every room.
    contrib = torch.where(out_valid, out_dir.long(), 0)
    key = torch.where(out_valid, out_room.long(), num_rooms)
    so = torch.sort(key, stable=True).indices
    c_s, k_s = contrib[so], key[so]
    cs = torch.cumsum(c_s, dim=0)
    seg_start = torch.ones(2 * n, dtype=torch.bool, device=dev)
    seg_start[1:] = k_s[1:] != k_s[:-1]
    segid = torch.cumsum(seg_start.long(), dim=0) - 1
    base = (cs - c_s)[seg_start]
    occupancy = torch.zeros(2 * n, dtype=torch.int32, device=dev)
    occupancy[so] = (cs - base[segid]).int()
    return out_room, out_dir, out_ts, out_valid, occupancy
