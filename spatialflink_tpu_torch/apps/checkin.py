"""CheckIn app: room-occupancy tracking (``GeoFlink/apps/CheckIn.java``),
as in the JAX package's ``apps/checkin.py``.

The pipeline of CheckIn.CheckInQuery (CheckIn.java:26-60):
  1. per-user count windows (2, 1): two consecutive events from the same
     door sensor (e.g. two "roomX-in" in a row) imply a missed opposite
     event — synthesize it at the midpoint timestamp
     (ProcessWinForInsertingMissingValues, CheckIn.java:251-321);
  2. per-room count window (1) with a running occupancy counter:
     "-in" increments, "-out" decrements; emit
     (room, capacity, occupancy, wallclock) per event
     (ProcessForCountingObjects, CheckIn.java:208-249).

``check_in_query`` walks the events on the host; ``check_in_query_soa``
computes the same emissions for a batch on a device
(``ops/checkin.py:check_in_kernel``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.ops.checkin import check_in_kernel
from spatialflink_tpu_torch.utils.padding import next_bucket


@dataclass
class CheckInEvent:
    """The reference's check-in Point variant (eventID, deviceID like
    "room1-in", userID, ts, x, y)."""

    event_id: str
    device_id: str  # "<room>-in" | "<room>-out"
    user_id: str
    timestamp: int
    x: float = 0.0
    y: float = 0.0

    @property
    def room(self) -> str:
        return self.device_id[: self.device_id.index("-")]

    @property
    def direction(self) -> str:
        return self.device_id[self.device_id.index("-") + 1:]


def _insert_missing(events: Iterable[CheckInEvent],
                    last: Optional[Dict[str, CheckInEvent]] = None,
                    ) -> Iterator[CheckInEvent]:
    """Per-user sliding count(2,1) pass inserting missing in/out events.
    Only the previous event per user is needed (bounded state — the
    reference's count window holds 2). ``last`` (mutated in place)
    carries that per-user state across calls (a caller that feeds one
    pane per call checkpoints the dict); the default, fresh state per
    call, is the batch contract of the standalone queries."""
    if last is None:
        last = {}
    for ev in events:
        prev = last.get(ev.user_id)
        last[ev.user_id] = ev
        if prev is None:
            # First window holds a single event → emit as-is
            # (CheckIn.java:272-276).
            yield ev
            continue
        if prev.device_id == ev.device_id:
            # Two consecutive same-door events → synthesize the opposite
            # event at the midpoint timestamp (CheckIn.java:286-305).
            mid_ts = (prev.timestamp + ev.timestamp) // 2
            flip = "out" if prev.direction == "in" else "in"
            yield CheckInEvent(
                ev.event_id, f"{prev.room}-{flip}", ev.user_id, mid_ts,
                ev.x, ev.y,
            )
        yield ev


def check_in_query(
    events: Iterable[CheckInEvent],
    room_capacities: Dict[str, int],
) -> Iterator[Tuple[str, Optional[int], int, float]]:
    """Yield (room, capacity, occupancy, wallclock) per processed event."""
    occupancy: Dict[str, int] = {}
    for ev in _insert_missing(events):
        room = ev.room
        occupancy[room] = occupancy.get(room, 0) + (
            1 if ev.direction == "in" else -1
        )
        yield (room, room_capacities.get(room), occupancy[room], time.time())


def check_in_query_soa(
    events: Iterable[CheckInEvent],
    room_capacities: Dict[str, int],
    device="cuda",
) -> Iterator[Tuple[str, Optional[int], int, float]]:
    """The same (room, capacity, occupancy, wallclock) stream as
    ``check_in_query``, computed for the whole batch by one
    ``check_in_kernel`` call on ``device`` (the card unless ``"cpu"``)
    instead of the per-event walk. The count-window state is two events
    deep, so a batch is exact on its own, as the host walk restarted per
    batch."""
    events = list(events)
    if not events:
        return
    dev = resolve_device(device)
    n = len(events)
    rooms: Dict[str, int] = {}
    users: Dict[str, int] = {}
    nb = next_bucket(n, minimum=8)
    room_id = np.zeros(nb, np.int32)
    user_id = np.zeros(nb, np.int32)
    dirn = np.zeros(nb, np.int32)
    ts = np.zeros(nb, np.int64)
    for i, ev in enumerate(events):
        room_id[i] = rooms.setdefault(ev.room, len(rooms))
        user_id[i] = users.setdefault(ev.user_id, len(users))
        dirn[i] = 1 if ev.direction == "in" else -1
        ts[i] = ev.timestamp
    valid = np.zeros(nb, bool)
    valid[:n] = True
    lanes = [torch.from_numpy(a).to(dev)
             for a in (user_id, room_id, dirn, ts, valid)]
    out_room, _d, _t, out_valid, occ = check_in_kernel(
        *lanes, num_rooms=len(rooms))
    names = {v: name for name, v in rooms.items()}
    ov = out_valid.cpu().numpy()
    orm = out_room.cpu().numpy()
    oc = occ.cpu().numpy()
    for s in np.nonzero(ov)[0]:
        room = names[int(orm[s])]
        yield (room, room_capacities.get(room), int(oc[s]), time.time())
