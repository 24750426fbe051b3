"""Kafka ingress/egress.

The reference's transport is Kafka (FlinkKafkaConsumer/Producer,
StreamingJob.java:188-191,255; producers in Serialization.java). The
record boundary — lines of GeoJSON/WKT/CSV — is identical to the file/
socket sources, so the transport layer only moves bytes.

Backends, in order of preference:

1. ``kafka-python`` / ``confluent_kafka`` if importable (full consumer-
   group support);
2. the BUILT-IN wire-protocol client (streams/kafka_wire.py — metadata/
   produce/fetch/list-offsets over a raw socket, no pip; brokers
   0.10–3.x, NOT 4.0+ whose KIP-896 removed these protocol versions —
   a 4.0 broker surfaces a clear UNSUPPORTED_VERSION KafkaError).
   Always available, so ``kafka_available()`` is unconditionally True;
   partition assignment is explicit (all partitions of the topic,
   timestamp-merged per fetch round) rather than group-coordinated — the
   reference likewise relies on Flink's own partition assignment, not
   group rebalancing. Offsets follow Flink's CHECKPOINTED-consumer model
   (StreamingJob.java:255): ``WireKafkaSource`` exposes per-partition
   positions that snapshot/restore through checkpoint.py, so a killed
   ingest resumes gap-free and dup-free.

The port's copy of the JAX package's module: the same backends in the
same order, the ``kafka.fetch`` fault point of the port's ``faults``,
and its offsets snapshot through the port's ``checkpoint.py``. This is
host code: the records it yields feed the operators on the card.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, TypeVar

from spatialflink_tpu_torch.faults import faults

T = TypeVar("T")


def _import_kafka():
    try:
        import kafka  # type: ignore

        return "kafka", kafka
    except ImportError:
        pass
    try:
        import confluent_kafka  # type: ignore

        return "confluent", confluent_kafka
    except ImportError:
        pass
    from spatialflink_tpu_torch.streams import kafka_wire

    return "wire", kafka_wire


def kafka_available() -> bool:
    """Always True: the built-in wire client needs no external library."""
    return _import_kafka()[0] is not None


def kafka_source(
    topic: str,
    bootstrap_servers: str,
    parser: Callable[[str], T],
    group_id: str = "spatialflink-tpu",
    from_earliest: bool = True,
) -> Iterator[T]:
    """Consume a topic as parsed records (FlinkKafkaConsumer analog).

    Unparseable records are skipped (the reference's deserializers drop
    malformed lines the same way). With the built-in backend ``group_id``
    only labels the client; partitions are explicitly assigned.
    """
    kind, mod = _import_kafka()
    return _kafka_iter(kind, mod, topic, bootstrap_servers, parser,
                       group_id, from_earliest)


def _kafka_iter(kind, mod, topic, bootstrap_servers, parser, group_id,
                from_earliest) -> Iterator[T]:
    if kind == "kafka":
        consumer = mod.KafkaConsumer(
            topic,
            bootstrap_servers=bootstrap_servers.split(","),
            group_id=group_id,
            auto_offset_reset="earliest" if from_earliest else "latest",
        )
        try:
            for msg in consumer:
                try:
                    yield parser(msg.value.decode())
                except (ValueError, IndexError):
                    continue
        finally:
            consumer.close()
    elif kind == "confluent":
        consumer = mod.Consumer(
            {
                "bootstrap.servers": bootstrap_servers,
                "group.id": group_id,
                "auto.offset.reset": "earliest" if from_earliest else "latest",
            }
        )
        consumer.subscribe([topic])
        try:
            while True:
                msg = consumer.poll(1.0)
                if msg is None:
                    continue
                err = msg.error()
                if err:
                    # Transient partition events are skippable; fatal broker/
                    # auth errors must surface, not spin forever.
                    if getattr(err, "fatal", lambda: True)():
                        raise RuntimeError(f"Kafka consumer error: {err}")
                    continue
                try:
                    yield parser(msg.value().decode())
                except (ValueError, IndexError):
                    continue
        finally:
            consumer.close()
    else:  # built-in wire client
        src = WireKafkaSource(topic, bootstrap_servers, parser,
                              group_id=group_id, from_earliest=from_earliest)
        try:
            yield from src
        finally:
            src.close()


class WireKafkaSource:
    """Resumable built-in consumer: the FlinkKafkaConsumer's
    checkpointed-offsets role (StreamingJob.java:255 — Flink snapshots
    the consumer's partition offsets with every checkpoint so a restart
    replays from exactly where it left off).

    ``offsets`` (partition → NEXT offset to fetch) advances per record
    AS IT IS YIELDED — every record below ``offsets[p]`` has been handed
    to the pipeline, everything at/after it has not. Snapshotting
    ``offsets`` together with the downstream operator state
    (checkpoint.py:kafka_source_state) therefore gives gap-free,
    dup-free kill-and-resume: restore the operator, pass the snapshot
    back as ``start_offsets``, and the stream continues mid-window
    (tests/test_kafka_wire.py::test_kill_and_resume_replays_no_gap_no_dup;
    tests/test_torch_kafka.py for the port).

    Log holes (compacted topics / retention): a fetched batch that
    STARTS past the requested position snaps the position to the
    batch's base offset, and within a batch the position advances along
    the offsets the broker actually delivered — deleted offsets are
    never waited for. The out-of-sequence parking below therefore
    guards only against the ts-sort reordering records of ONE fetched
    batch (the only case where an "earlier" record is still coming).

    Cross-partition timestamp ordering: within a fetch round, records
    from all partitions yield in event-time order (stable sort; the
    single-partition common case bypasses the buffer). Mid-round offset
    consistency assumes within-partition timestamps are monotone — the
    same in-order assumption the pane paths already make. Unparseable
    records and null tombstones advance their offset (they were
    consumed) without yielding.
    """

    #: Backpressure capability flag read by the dataflow driver's
    #: admission control (overload.py): a broker retains the log, so the
    #: consumer absorbs pressure by simply not issuing the next fetch
    #: round (the pull loop's natural pause) — it never needs the
    #: non-replayable shed path a live socket does.
    pausable = True

    def __init__(self, topic: str, bootstrap_servers: str,
                 parser: Callable[[str], T], group_id: str = "spatialflink-tpu",
                 from_earliest: bool = True,
                 start_offsets: Optional[dict] = None):
        from spatialflink_tpu_torch.streams import kafka_wire

        self._mod = kafka_wire
        self.topic = topic
        self._parser = parser
        self._from_earliest = from_earliest
        self._offsets: dict = dict(start_offsets or {})
        self._client = kafka_wire.KafkaWireClient(
            bootstrap_servers, client_id=group_id
        )

    @property
    def offsets(self) -> dict:
        """Per-partition next-fetch offsets (snapshot-safe copy)."""
        return dict(self._offsets)

    def close(self) -> None:
        self._client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __iter__(self) -> Iterator[T]:
        import time as _time

        client, topic, mod = self._client, self.topic, self._mod
        # A broker auto-creating the topic answers the first metadata
        # request with UNKNOWN_TOPIC_OR_PARTITION / LEADER_NOT_AVAILABLE
        # (dropped by metadata()); retry like the library consumers do.
        parts: list = []
        for _attempt in range(25):
            parts = client.metadata([topic]).get(topic, [])
            if parts:
                break
            _time.sleep(0.2)
        if not parts:
            raise RuntimeError(
                f"topic {topic!r} has no partitions (does it exist?)"
            )
        ts = mod.EARLIEST if self._from_earliest else mod.LATEST
        for p in parts:
            # Restored partitions keep their checkpointed position;
            # partitions unseen at snapshot time start per from_earliest.
            if p not in self._offsets:
                self._offsets[p] = client.list_offset(topic, p, ts)
        single = len(parts) == 1
        offsets = self._offsets  # mutated in place: `offsets` stays live
        while True:
            progressed = False
            # Merge each fetch round across partitions by message
            # timestamp: a fixed round-robin yield would interleave
            # partitions out of event-time order, and the pane paths
            # (query_panes rejects allowed_lateness) would silently
            # drop such records as late. Cost: a round's records are
            # held until every partition's fetch returns (idle
            # partitions long-poll max_wait_ms) — inherent to
            # cross-partition ordering. The sort key is timestamp ONLY
            # and the sort is stable, so a partition's producer order
            # survives for equal/monotone timestamps.
            round_msgs: list = []
            succ: dict = {}  # partition → offset → next fetch position
            for p in parts:
                if faults.armed:  # chaos injection point (faults.py)
                    faults.hit("kafka.fetch")
                msgs, _hw = client.fetch(topic, p, offsets[p])
                if msgs and msgs[0][0] > offsets[p]:
                    # The batch STARTS past our position: a log hole
                    # (compaction / retention deleted the offsets we
                    # asked for), not a reorder — the broker always
                    # serves the first available record at/after the
                    # requested offset. Snap the position to the fetch
                    # response's base offset so the contiguity rule
                    # below applies only WITHIN this fetched batch;
                    # without the snap, every record of a compacted
                    # topic past the first hole parks in `ahead`
                    # forever and each round re-fetches (and re-yields)
                    # the same records — a stall-plus-duplicate storm.
                    offsets[p] = msgs[0][0]
                if not single and msgs:
                    # Within-batch successor chain: the broker delivers
                    # a batch offset-ascending, so "contiguous" means
                    # the NEXT OFFSET PRESENT IN THE BATCH — holes the
                    # broker itself skipped (compacted-away records)
                    # are not missing data to wait for.
                    offs_p = [m[0] for m in msgs]
                    succ[p] = dict(
                        zip(offs_p, offs_p[1:] + [offs_p[-1] + 1])
                    )
                for off, ts_ms, _key, value in msgs:
                    progressed = True
                    if single:
                        offsets[p] = off + 1
                        if value is None:
                            continue
                        try:
                            rec = self._parser(value.decode())
                        except (ValueError, IndexError):
                            continue
                        yield rec
                    else:
                        round_msgs.append((ts_ms, p, off, value))
            round_msgs.sort(key=lambda m: m[0])
            # Positions advance CONTIGUOUSLY as records are handed over:
            # if within-partition timestamps are non-monotone (producer
            # retry / CreateTime skew) the ts sort can yield a later
            # offset first — advancing straight to it would make a
            # mid-round checkpoint SKIP the earlier, not-yet-yielded
            # record. Out-of-sequence yields park in `ahead` until the
            # gap closes; a mid-round resume then re-delivers them
            # (at-least-once under ts skew; exactly-once for the normal
            # monotone case — same degradation as any replaying source).
            ahead: dict = {}
            for _ts, p, off, value in round_msgs:
                if off == offsets[p]:
                    offsets[p] = succ[p][off]
                    parked = ahead.get(p)
                    while parked and offsets[p] in parked:
                        parked.remove(offsets[p])
                        offsets[p] = succ[p][offsets[p]]
                elif off > offsets[p]:
                    ahead.setdefault(p, set()).add(off)
                if value is None:
                    continue
                try:
                    rec = self._parser(value.decode())
                except (ValueError, IndexError):
                    continue
                yield rec
            if not progressed:
                # fetch() already long-polled max_wait_ms per partition;
                # loop again (a live stream source never terminates —
                # same contract as the library-backed branches).
                continue


class KafkaSink:
    """Produce rendered records to a topic (Serialization.java producers).

    The built-in backend buffers records and produces one message set per
    ``flush()`` (auto-flushes every ``batch`` records) — the analog of the
    library producers' internal batching.
    """

    def __init__(self, topic: str, bootstrap_servers: str,
                 formatter: Callable = str, partition: int = 0,
                 batch: int = 500):
        kind, mod = _import_kafka()
        self.topic = topic
        self.formatter = formatter
        self._kind = kind
        if kind == "kafka":
            self._producer = mod.KafkaProducer(
                bootstrap_servers=bootstrap_servers.split(",")
            )
            self._send = lambda v: self._producer.send(self.topic, v)
        elif kind == "confluent":
            self._producer = mod.Producer({"bootstrap.servers": bootstrap_servers})
            self._send = lambda v: self._producer.produce(self.topic, v)
        else:
            import weakref

            self._client = mod.KafkaWireClient(bootstrap_servers)
            self._partition = partition
            self._batch = batch
            self._buf: list = []
            self._send = self._buffer_send
            # The wire backend has no producer thread: records sit in
            # _buf until flush()/close(). Guarantee delivery even if the
            # owner drops the sink without closing (library backends
            # flush via their own threads) — the finalizer flushes at GC
            # or interpreter exit. close() detaches it.
            self._finalizer = weakref.finalize(
                self, KafkaSink._final_flush,
                self._client, self.topic, partition, self._buf,
            )

    @staticmethod
    def _final_flush(client, topic, partition, buf):
        # Bound object state only (weakref.finalize contract: no self).
        try:
            if buf:
                client.produce(topic, partition, list(buf))
                buf.clear()
            client.close()
        except Exception:
            pass  # interpreter teardown: sockets may already be gone

    def _buffer_send(self, value: bytes) -> None:
        import time as _time

        self._buf.append((value, None, int(_time.time() * 1000)))
        if len(self._buf) >= self._batch:
            self.flush()

    def __call__(self, record):
        self._send(self.formatter(record).encode())

    def flush(self):
        if self._kind in ("kafka", "confluent"):
            self._producer.flush()
        elif self._buf:
            self._client.produce(self.topic, self._partition, self._buf)
            self._buf.clear()  # in place: the finalizer holds this list

    def close(self):
        # The flush goes out here; detaching the finalizer after it
        # means a closed sink is never flushed a second time at GC.
        self.flush()
        if self._kind == "wire":
            self._finalizer.detach()
            self._client.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
