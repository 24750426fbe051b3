"""Checkpoint and resume for the stateful streaming operators.

Operator state is explicit host data: component states are plain dicts
of Python values and numpy arrays, and ``save_checkpoint`` /
``load_checkpoint`` persist them as one framed pickle with an atomic
publish, in the JAX package's format (``spatialflink_tpu/checkpoint.py``),
so either package reads the other's frame. A checkpoint never holds a
``torch.Tensor``: a carry on the card is pulled to numpy through
``telemetry.fetch`` when it is snapshotted, and a restored carry is a
copy moved to the restoring operator's device, so a checkpoint taken on
the card resumes on the CPU and the other way round. Checkpoints are
trusted local state (pickle): do not load files from untrusted sources.
``state.load_jax_checkpoint`` reads a checkpoint written by the JAX
package through an allow-list of classes.

Snapshottable components:
  - ``WindowAssembler``: open window buffers, fired flags, max event
    time, late-drop count;
  - the SoA sliding assemblers (``streams/soa.py``): buffered chunks (or
    ragged rows, vertices, edges) and the watermark state;
  - ``TAggregateQuery``'s sorted (cell, objID) min/max arrays and
    ``TStatsQuery``'s realtime running totals;
  - the kNN pane carries (``query_panes``, ``run_soa_panes``) and the
    headline ``run_wire_panes`` digest ring with its next pane index and
    per-pane event counts; the join's ``query_panes`` pane-block carry;
  - the objID ``Interner``, so dense ids stay stable on resume;
  - the overload controller's ``state()``, which the driver publishes as
    the ``overload`` component (the JAX frame's, value for value);
  - the qserve ``QueryRegistry`` (``qserve.py``): the standing-query set,
    the applied-command uids and the counters (the ``qserve`` component;
    its flag tables are derived data, rebuilt on restore).

  - the composed DAG (``dag.py``): every node's backend, counters and
    substate (the qserve registry, CheckIn's occupancy) as the ``dag``
    component, published with the ``MultiSink`` marker map;
  - the built-in Kafka consumer's offsets (``kafka_source_state``,
    ``restore_kafka_source_offsets``): with the wire pane assembler and
    the operator, a Kafka-fed pipeline resumes with no gap and no
    duplicate;
  - the grid-partitioned placement plan (``parallel/partition.py``) as
    the ``partition`` component, in the JAX frame's dict: a resume
    re-dispatches onto the checkpointed placement, and refuses a
    resuming operator planned for another shard count.

Every component of the JAX package's checkpoints has its counterpart:
``WAITING_COMPONENTS`` is empty.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from typing import Any, Dict

import numpy as np
import torch

from spatialflink_tpu_torch.streams.windows import WindowAssembler, WindowSpec
from spatialflink_tpu_torch.telemetry import telemetry
from spatialflink_tpu_torch.utils.interning import Interner

#: Components of the JAX package's checkpoints that the port cannot
#: snapshot or restore yet, with the ROADMAP item each waits for: none.
WAITING_COMPONENTS: Dict[str, str] = {}


def assembler_state(asm: WindowAssembler) -> Dict[str, Any]:
    return {
        "buffers": [
            ((spec.start, spec.end), events)
            for spec, events in asm._buffers.items()
        ],
        "fired": [
            ((spec.start, spec.end), fired) for spec, fired in asm._fired.items()
        ],
        "max_ts": asm._max_ts,
        "dropped_late": asm.dropped_late,
    }


def restore_assembler(asm: WindowAssembler, state: Dict[str, Any]) -> None:
    asm._buffers = {
        WindowSpec(s, e): list(events) for (s, e), events in state["buffers"]
    }
    asm._fired = {WindowSpec(s, e): f for (s, e), f in state["fired"]}
    asm._max_ts = state["max_ts"]
    asm.dropped_late = state["dropped_late"]


def soa_assembler_state(asm) -> Dict[str, Any]:
    """Snapshot a ``streams/soa.py`` sliding assembler: the point
    assembler (payload in ``_chunks``) or the ragged-geometry one
    (payload in ``_rows``/``_verts``/``_edges``)."""
    out: Dict[str, Any] = {
        "max_ts": asm._max_ts,
        "next_start": asm._next_start,
        "dropped_late": asm.dropped_late,
    }
    if hasattr(asm, "_chunks"):  # SoaWindowAssembler
        out["chunks"] = [
            {k: np.array(v, copy=True) for k, v in c.items()}
            for c in asm._chunks
        ]
    else:  # RaggedSoaWindowAssembler
        out["rows"] = [dict(r) for r in asm._rows]
        out["verts"] = list(asm._verts)
        out["edges"] = None if asm._edges is None else list(asm._edges)
        out["edge_mode"] = asm._edge_mode
    return out


def restore_soa_assembler(asm, state: Dict[str, Any]) -> None:
    asm._max_ts = state["max_ts"]
    asm._next_start = state["next_start"]
    asm.dropped_late = state["dropped_late"]
    if "chunks" in state:
        # Copies: the assembler slices and concatenates its chunks, and
        # the loaded arrays may be read-only views of the unpickled data.
        asm._chunks = [{k: np.array(v, copy=True) for k, v in c.items()}
                       for c in state["chunks"]]
    else:
        asm._rows = [dict(r) for r in state["rows"]]
        asm._verts = list(state["verts"])
        asm._edges = None if state["edges"] is None else list(state["edges"])
        asm._edge_mode = state["edge_mode"]


def interner_state(interner: Interner) -> Dict[str, Any]:
    return {"table": list(interner._to_key)}


def restore_interner(interner: Interner, state: Dict[str, Any]) -> None:
    interner._to_key = list(state["table"])
    interner._to_int = {k: i for i, k in enumerate(interner._to_key)}


def _host_copies(tree):
    """``telemetry.fetch`` of a list of tensor tuples, every array copied:
    a CPU tensor's ``.numpy()`` shares the live carry's memory."""
    return [tuple(np.array(a, copy=True) for a in t)
            for t in telemetry.fetch(tree)]


def _device_tensor(a, dtype, device) -> torch.Tensor:
    # Copy before the tensor exists: torch.from_numpy shares memory with
    # the unpickled array, and a restored carry must own its storage.
    return torch.from_numpy(np.array(a, dtype=dtype, copy=True)).to(device)


def _carry_dtype(a) -> type:
    """The distance dtype a restored kNN pane digest keeps: float64 for a
    float64 mode's carry, float32 otherwise."""
    return np.float64 if np.asarray(a).dtype == np.float64 else np.float32


def operator_state(op) -> Dict[str, Any]:
    """Snapshot the known stateful fields of an operator instance.

    Carries on the operator's device (the kNN pane digests and the wire
    digest ring) come to numpy through ``telemetry.fetch``, one fetch a
    carry: a checkpoint is a host artifact and never holds a tensor."""
    out: Dict[str, Any] = {"interner": interner_state(op.interner)}
    if hasattr(op, "_skeys"):  # TAggregateQuery MapState (sorted arrays)
        out["agg_state"] = {
            "keys": op._skeys.copy(),
            "min": op._smin.copy(),
            "max": op._smax.copy(),
        }
    if hasattr(op, "_running"):  # TStatsQuery ValueState
        out["running"] = dict(op._running)
    if getattr(op, "checkpoint_assembler", None) is not None:
        out["assembler"] = assembler_state(op.checkpoint_assembler)
    if getattr(op, "checkpoint_soa_assembler", None) is not None:
        out["soa_assembler"] = soa_assembler_state(op.checkpoint_soa_assembler)
    pane = getattr(op, "_pane_carry", None)
    if pane is not None:  # kNN query_panes digests
        live = [ps for ps, v in pane.items() if v is not None]
        host = _host_copies([(pane[ps][1], pane[ps][2]) for ps in live])
        fetched = dict(zip(live, host))
        out["knn_pane_carry"] = {
            ps: None if v is None else
            (int(v[0]), fetched[ps][0], fetched[ps][1], list(v[3]))
            for ps, v in pane.items()
        }
    soa_pane = getattr(op, "_pane_carry_soa", None)
    if soa_pane is not None:  # kNN run_soa_panes digests
        live = [ps for ps, v in soa_pane.items() if v is not None]
        host = _host_copies([tuple(soa_pane[ps]) for ps in live])
        fetched = dict(zip(live, host))
        out["knn_pane_carry_soa"] = {
            ps: None if v is None else tuple(fetched[ps])
            for ps, v in soa_pane.items()
        }
    wire_pane = getattr(op, "_wire_pane_carry", None)
    if wire_pane is not None:  # kNN run_wire_panes digest ring
        digests = _host_copies([tuple(d) for d in wire_pane["digests"]])
        out["knn_wire_pane_carry"] = {
            "next_pane": int(wire_pane["next_pane"]),
            "digests": [(s, r) for s, r in digests],
            # per-pane event counts: the gap-window suppression state
            "counts": [int(c) for c in wire_pane.get(
                "counts", [1] * len(wire_pane["digests"])
            )],
        }
    pplan = getattr(op, "partition_plan", None)
    if pplan is not None:  # the placement plan (parallel/partition.py)
        # The plan rides the same framed unit publish as the operator
        # state it placed; a resume checks the shard count against the
        # resuming operator's plan before any dispatch.
        out["partition"] = pplan.to_dict()
    qreg = getattr(op, "qserve_registry", None)
    if qreg is not None:  # qserve standing-query registry (qserve.py)
        out["qserve"] = qreg.state()
    if getattr(op, "dag_nodes", None) is not None:
        # The composed dataflow (dag.py): every node's backend, counters
        # and substate as ONE component, the node half of the atomic unit
        # checkpoint whose egress half is the MultiSink marker map.
        out["dag"] = op.dag_state()
    jcarry = getattr(op, "_join_pane_carry", None)
    if jcarry is not None:  # join query_panes pane events + pair blocks
        out["join_pane_carry"] = {
            "panes": {
                ps: (list(v[0]), list(v[1]))
                for ps, v in jcarry["panes"].items()
            },
            "blocks": {
                key: (list(pairs), over)
                for key, (pairs, over) in jcarry["blocks"].items()
            },
        }
    return out


def restore_operator(op, state: Dict[str, Any]) -> None:
    """Restore ``operator_state`` into ``op``; device carries move to
    ``op.device``. An assembler state is consumed by the operator's next
    run, before its first event (``SpatialOperator._adopt_assembler``)."""
    # The composed DAG has no device of its own (its nodes do) and no
    # device carry.
    dev = getattr(op, "device", None)
    restore_interner(op.interner, state["interner"])
    if "agg_state" in state and hasattr(op, "_skeys"):
        agg = state["agg_state"]
        if "keys" not in agg:
            # Round-1 checkpoint format: {(cell, oid_str): (min, max)}.
            # Convert to the sorted cell<<32|interned-oid key arrays (the
            # interner is already restored, so an oid seen at snapshot
            # time interns to its original dense id).
            rows = sorted(
                ((int(c) << 32) | op.interner.intern(o), int(mn), int(mx))
                for (c, o), (mn, mx) in agg.items()
            )
            agg = {
                "keys": [r[0] for r in rows],
                "min": [r[1] for r in rows],
                "max": [r[2] for r in rows],
            }
        op._skeys = np.array(agg["keys"], np.int64)
        op._smin = np.array(agg["min"], np.int64)
        op._smax = np.array(agg["max"], np.int64)
    if "running" in state and hasattr(op, "_running"):
        op._running = dict(state["running"])
    if "assembler" in state:
        op._restored_assembler = state["assembler"]
    if "soa_assembler" in state:
        op._restored_soa_assembler = state["soa_assembler"]
    if "knn_pane_carry" in state:
        op._pane_carry = {
            ps: None if v is None else (
                int(v[0]), _device_tensor(v[1], _carry_dtype(v[1]), dev),
                _device_tensor(v[2], np.int32, dev), list(v[3]))
            for ps, v in state["knn_pane_carry"].items()
        }
    if "knn_pane_carry_soa" in state:
        op._pane_carry_soa = {
            ps: None if v is None else (
                _device_tensor(v[0], _carry_dtype(v[0]), dev),
                _device_tensor(v[1], np.int32, dev))
            for ps, v in state["knn_pane_carry_soa"].items()
        }
    if "knn_wire_pane_carry" in state:
        wire = state["knn_wire_pane_carry"]
        # Consumed by the NEXT run_wire_panes call only: the index-based
        # carry must never leak into an ordinary fresh run.
        op.restore_wire_pane_carry({
            "next_pane": int(wire["next_pane"]),
            "digests": [(_device_tensor(s, np.float32, dev),
                         _device_tensor(r, np.int32, dev))
                        for s, r in wire["digests"]],
            "counts": [int(c) for c in wire.get(
                "counts", [1] * len(wire["digests"]))],
        })
    if "dag" in state and getattr(op, "dag_nodes", None) is not None:
        # Restored before the assembler state is consumed (the DAG's
        # _adopt_assembler), so resumed nodes hold their backend and
        # substate before the first replayed window fires.
        op.restore_dag(state["dag"])
    if "partition" in state:  # checkpoints before the halo layer carry none
        from spatialflink_tpu_torch.parallel.partition import PartitionPlan

        plan = PartitionPlan.from_dict(state["partition"])
        current = getattr(op, "partition_plan", None)
        if current is not None and current.n_shards != plan.n_shards:
            raise ValueError(
                f"checkpoint partition plan is for {plan.n_shards} "
                f"shard(s) but the resuming operator is configured for "
                f"{current.n_shards} — re-plan and re-checkpoint "
                f"instead of resuming across a shard-count change"
            )
        op.partition_plan = plan
    if "qserve" in state and getattr(op, "qserve_registry", None) \
            is not None:
        # Flag tables are derived (rebuilt from the grid inside restore);
        # the interner restored above keeps tenant and qid ids stable.
        op.qserve_registry.restore(state["qserve"])
    if "join_pane_carry" in state:
        # Pane batches are derived data: rebuilt through the operator's
        # own batcher (the interner restored above keeps ids stable).
        op._join_pane_carry = {
            "panes": {
                ps: (
                    list(lev), list(rev),
                    op.point_batch(lev) if lev else None,
                    op.point_batch(rev) if rev else None,
                )
                for ps, (lev, rev) in state["join_pane_carry"]["panes"].items()
            },
            "blocks": {
                key: (list(pairs), over)
                for key, (pairs, over)
                in state["join_pane_carry"]["blocks"].items()
            },
        }


def wire_pane_assembler_state(asm) -> Dict[str, Any]:
    """Snapshot a ``streams/wire.py:WirePaneAssembler``: the open pane's
    buffered events and position (slide and wire-format identity
    included; restore refuses a mismatched config). Take it with every
    completed pane drained."""
    return asm.state()


def restore_wire_pane_assembler(asm, state: Dict[str, Any]) -> None:
    asm.restore(state)


def kafka_source_state(src) -> Dict[str, Any]:
    """Snapshot a ``streams/kafka.py:WireKafkaSource``: the checkpointed
    consumer-offsets role of Flink's Kafka consumer
    (StreamingJob.java:255), the JAX package's frame value for value.
    Pass the saved mapping back as ``WireKafkaSource(start_offsets=...)``
    on resume; with the assembler and operator state above, a killed
    ingest replays the topic with no gap and no duplicate."""
    return {
        "topic": src.topic,
        "offsets": {int(p): int(o) for p, o in src.offsets.items()},
    }


def restore_kafka_source_offsets(state: Dict[str, Any],
                                 topic: str) -> Dict[int, int]:
    """Validate and extract ``start_offsets`` for a resumed source; a
    checkpoint of another topic raises ``ValueError``."""
    if state["topic"] != topic:
        raise ValueError(
            f"checkpoint is for topic {state['topic']!r}, not {topic!r}"
        )
    return {int(p): int(o) for p, o in state["offsets"].items()}


#: Framed-checkpoint magic. Format (big-endian):
#: ``MAGIC(8) | version u32 | crc32 u32 | payload_len u64 | payload``;
#: the payload is the pickled component dict. The header turns a raw
#: pickle's two silent corruption modes (truncation, bit rot) into
#: explicit :class:`CheckpointCorruptError`\ s naming the path and what
#: was expected.
CHECKPOINT_MAGIC = b"SFTCKPT\x01"
CHECKPOINT_VERSION = 2


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file failed its integrity check (magic / version /
    length / CRC / unpickle). Carries the path and what was expected."""

    def __init__(self, path: str, expected: str, found: str = ""):
        msg = f"corrupt checkpoint {path!r}: expected {expected}"
        if found:
            msg += f", found {found}"
        super().__init__(msg)
        self.path = path


def save_checkpoint(path: str, **components) -> None:
    """Persist named component states, e.g.
    ``save_checkpoint(p, op=operator_state(o))``.

    Durable publish: the framed payload (magic, version, CRC32, length)
    goes to a sibling temp file, is fsync'd, then renamed over ``path``
    atomically, so a crash at any instant leaves the old checkpoint or
    the new one, never a torn file; the directory is fsync'd too, so the
    rename survives power loss."""
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    payload = pickle.dumps(components, protocol=pickle.HIGHEST_PROTOCOL)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(CHECKPOINT_MAGIC)
        f.write(struct.pack(">IIQ", CHECKPOINT_VERSION,
                            zlib.crc32(payload) & 0xFFFFFFFF, len(payload)))
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)  # atomic publish
    try:
        dfd = os.open(dirname, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:  # pragma: no cover - platform without dir fsync
        pass


def read_checkpoint_payload(path: str):
    """``(payload bytes, framed)`` of a checkpoint file whose frame
    checks out: magic, then version, length and CRC, each failure a
    :class:`CheckpointCorruptError`. A headerless file starting with a
    pickle's protocol byte is a round-1 (legacy) checkpoint and returns
    whole with ``framed`` False."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(CHECKPOINT_MAGIC):
        if data[:1] == b"\x80":  # legacy raw-pickle checkpoint (pre-v2)
            return data, False
        raise CheckpointCorruptError(
            path, f"magic {CHECKPOINT_MAGIC!r}",
            f"{data[:8]!r} ({len(data)} bytes)",
        )
    header = data[len(CHECKPOINT_MAGIC):len(CHECKPOINT_MAGIC) + 16]
    if len(header) < 16:
        raise CheckpointCorruptError(
            path, "a 16-byte header after the magic",
            f"{len(header)} bytes (truncated)",
        )
    version, crc, length = struct.unpack(">IIQ", header)
    if version > CHECKPOINT_VERSION:
        raise CheckpointCorruptError(
            path,
            f"checkpoint version <= {CHECKPOINT_VERSION} (this build)",
            f"version {version} — written by a newer build; upgrade or "
            "re-checkpoint",
        )
    payload = data[len(CHECKPOINT_MAGIC) + 16:]
    if len(payload) != length:
        raise CheckpointCorruptError(
            path, f"{length} payload bytes",
            f"{len(payload)} (truncated or trailing garbage)",
        )
    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
        raise CheckpointCorruptError(
            path, f"payload CRC32 {crc:#010x}",
            f"{zlib.crc32(payload) & 0xFFFFFFFF:#010x} (bit rot or a "
            "partial overwrite)",
        )
    return payload, True


def unpickle_components(path: str, payload: bytes, framed: bool,
                        loads=pickle.loads) -> Dict[str, Any]:
    """The component dict of a checked payload; an unpickling failure or
    a payload that is not a dict raises :class:`CheckpointCorruptError`."""
    try:
        out = loads(payload)
    except CheckpointCorruptError:
        raise
    except Exception as e:  # CRC passed but unpickle failed: version skew
        raise CheckpointCorruptError(
            path, "a loadable pickle payload" if framed
            else "a loadable legacy (headerless) checkpoint",
            f"unpickling failed: {e!r}",
        ) from e
    if not framed and not isinstance(out, dict):
        raise CheckpointCorruptError(path, "a component dict",
                                     type(out).__name__)
    return out


def load_checkpoint(path: str) -> Dict[str, Any]:
    """Load and verify a checkpoint: framed (v2+) files are checked
    magic → version → length → CRC → unpickle, each failure raising
    :class:`CheckpointCorruptError` with the path and the expectation
    that failed; a round-1 (headerless) checkpoint still loads, its
    corruption wrapped in the same error."""
    payload, framed = read_checkpoint_payload(path)
    return unpickle_components(path, payload, framed)
