"""The port's Kafka modules (``spatialflink_tpu_torch/streams/
kafka_wire.py`` and ``kafka.py``) against the JAX package's, on the CPU,
with ``tests/test_kafka_wire.py`` and ``tests/test_kafka.py`` as the
oracle.

- Golden frames: the four request encoders byte for byte against frames
  packed by hand from the protocol spec, and equal to the JAX encoders on
  seeded inputs; message sets (v0/v1, gzip/snappy/lz4 wrappers, CRC,
  partial trailing message), the codecs and xxHash32 equal to the JAX
  module's on the same seeded bytes.
- Over a real TCP socket, against the JAX test's in-process broker
  (``FakeBroker``): produce/fetch with every broker-side codec, the
  partition merge in event-time order, the compacted topic, a mid-round
  checkpoint under timestamp skew, kill and resume through the port's
  checkpoint, the mid-fetch socket drop, a leader change, the leader
  retry budget, the sink and source feeding an operator, malformed
  records, and the headline wire pipeline (Kafka → ``WirePaneAssembler``
  → ``run_wire_panes``) killed and resumed, equal to the uninterrupted
  run and to the JAX pipeline's windows.
- The ``kafka.fetch`` and ``kafka.leader`` fault points fire at the hit
  the plan names, as in the JAX package, and are not retried; a JAX
  checkpoint's Kafka offsets resume a port source.
- The library backends are tried first, in the JAX order; the sink's
  final flush at GC delivers an unclosed sink's records once, and never
  a closed sink's twice.
- ``chip_smoke.MiniBroker`` (the card phase's broker) serves the port's
  client as ``FakeBroker`` does.

Every test bounds its own wait: an alarm fails it after ``BOUND_S``
seconds, and each client socket times out after 15 s.
"""

import gc
import importlib.util
import itertools
import random
import signal
import struct
import sys
import types
import zlib
from pathlib import Path

import numpy as np
import pytest
from test_kafka_wire import FakeBroker, _gzip_wrapper, _lz4_frame

from spatialflink_tpu import checkpoint as jck
from spatialflink_tpu.faults import faults as jfaults
from spatialflink_tpu.streams import kafka as jkafka
from spatialflink_tpu.streams import kafka_wire as jkw

from spatialflink_tpu_torch import checkpoint as ck
from spatialflink_tpu_torch.faults import InjectedFault, faults
from spatialflink_tpu_torch.streams import kafka as tkafka
from spatialflink_tpu_torch.streams import kafka_wire as kw

BOUND_S = 60


@pytest.fixture(autouse=True)
def bounded_and_disarmed():
    """Fail a test that waits past ``BOUND_S`` (a hung socket fails only
    its own test), and leave both packages' fault plans disarmed."""
    def expired(signum, frame):
        raise TimeoutError(f"Kafka test exceeded its {BOUND_S} s bound")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(BOUND_S)
    faults.disarm()
    jfaults.disarm()
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
        faults.disarm()
        jfaults.disarm()


@pytest.fixture
def broker():
    b = FakeBroker()
    yield b
    b.close()


def _no_libs(monkeypatch):
    """Force the built-in backend even if a Kafka library were
    importable."""
    import builtins

    real_import = builtins.__import__

    def guarded(name, *a, **kw_):
        if name in ("kafka", "confluent_kafka"):
            raise ImportError(name)
        return real_import(name, *a, **kw_)

    monkeypatch.setattr(builtins, "__import__", guarded)


# ---------------------------------------------------------------------------
# 1. golden frames and codecs


def test_metadata_request_golden_bytes():
    body = kw.encode_metadata_request(["gps"])
    frame = kw.encode_request(kw.API_METADATA, 0, 7, "c", body)
    expect = b"".join([
        struct.pack(">i", 2 + 2 + 4 + 2 + 1 + 4 + 2 + 3),
        struct.pack(">h", 3), struct.pack(">h", 0), struct.pack(">i", 7),
        struct.pack(">h", 1), b"c",
        struct.pack(">i", 1), struct.pack(">h", 3), b"gps",
    ])
    assert frame == expect
    assert frame == jkw.encode_request(jkw.API_METADATA, 0, 7, "c",
                                       jkw.encode_metadata_request(["gps"]))


def test_produce_request_golden_bytes():
    msg_body = b"".join([
        struct.pack(">b", 1), struct.pack(">b", 0), struct.pack(">q", 1234),
        struct.pack(">i", -1), struct.pack(">i", 2), b"hi",
    ])
    msg = struct.pack(">I", zlib.crc32(msg_body) & 0xFFFFFFFF) + msg_body
    mset = struct.pack(">qi", 0, len(msg)) + msg
    expect = b"".join([
        struct.pack(">h", 1), struct.pack(">i", 10_000),
        struct.pack(">i", 1), struct.pack(">h", 1), b"t",
        struct.pack(">i", 1), struct.pack(">i", 0),
        struct.pack(">i", len(mset)), mset,
    ])
    got = kw.encode_produce_request(
        "t", 0, kw.encode_message_set([(b"hi", None, 1234)]), acks=1)
    assert got == expect


def test_fetch_request_golden_bytes():
    expect = b"".join([
        struct.pack(">i", -1), struct.pack(">i", 500), struct.pack(">i", 1),
        struct.pack(">i", 1), struct.pack(">h", 3), b"gps",
        struct.pack(">i", 1), struct.pack(">i", 2), struct.pack(">q", 42),
        struct.pack(">i", 1 << 20),
    ])
    assert kw.encode_fetch_request("gps", 2, 42) == expect


def test_list_offsets_request_golden_bytes():
    expect = b"".join([
        struct.pack(">i", -1), struct.pack(">i", 1), struct.pack(">h", 1),
        b"t", struct.pack(">i", 1), struct.pack(">i", 0),
        struct.pack(">q", -2), struct.pack(">i", 1),
    ])
    assert kw.encode_list_offsets_request("t", 0, kw.EARLIEST) == expect


def _seeded_messages(seed, n=40):
    rng = random.Random(seed)
    out = []
    for i in range(n):
        value = None if rng.random() < 0.1 else bytes(
            rng.getrandbits(8) for _ in range(rng.randint(0, 300)))
        key = None if rng.random() < 0.5 else f"k{rng.randint(0, 9)}".encode()
        out.append((value, key, rng.randint(0, 1 << 40)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_encoders_equal_the_jax_encoders(seed):
    rng = random.Random(seed)
    msgs = _seeded_messages(seed)
    topic = "t" + str(rng.randint(0, 999))
    part, off = rng.randint(0, 64), rng.randint(0, 1 << 40)
    assert kw.encode_message_set(msgs) == jkw.encode_message_set(msgs)
    mset = kw.encode_message_set(msgs)
    for acks in (0, 1, -1):
        assert kw.encode_produce_request(topic, part, mset, acks=acks) == \
            jkw.encode_produce_request(topic, part, mset, acks=acks)
    assert kw.encode_fetch_request(topic, part, off, max_bytes=4096,
                                   max_wait_ms=7) == \
        jkw.encode_fetch_request(topic, part, off, max_bytes=4096,
                                 max_wait_ms=7)
    for ts in (kw.EARLIEST, kw.LATEST):
        assert kw.encode_list_offsets_request(topic, part, ts) == \
            jkw.encode_list_offsets_request(topic, part, ts)
    assert kw.encode_metadata_request([topic, "x"]) == \
        jkw.encode_metadata_request([topic, "x"])
    for v, k, t in msgs[:10]:
        assert kw.encode_message_v1(v, k, t) == jkw.encode_message_v1(v, k, t)


@pytest.mark.parametrize("seed", [4, 5])
def test_codecs_equal_the_jax_codecs(seed):
    rng = random.Random(seed)
    blobs = [b"", b"a", bytes(rng.getrandbits(8) for _ in range(5000)),
             b"abcd" * 20_000]
    for data in blobs:
        assert kw._xxh32(data) == jkw._xxh32(data)
        s = kw.snappy_compress_literal(data)
        assert s == jkw.snappy_compress_literal(data)
        assert kw.snappy_decompress(s) == jkw.snappy_decompress(s) == data
        for legacy in (False, True):
            z = kw.lz4_compress_literal(data, legacy_hc=legacy)
            assert z == jkw.lz4_compress_literal(data, legacy_hc=legacy)
            assert kw.lz4_decompress(z) == data
    frame = _lz4_frame([(b"xyz" * 100, False)], flg=0x64,
                       content=b"xyz" * 100)
    assert kw.lz4_decompress(frame) == jkw.lz4_decompress(frame)


@pytest.mark.parametrize("codec", ["plain", "gzip", "gzip_logappend",
                                   "snappy", "lz4", "magic0"])
def test_decode_message_set_equals_jax(codec):
    msgs = [m for m in _seeded_messages(7, 25) if m[0] is not None]
    inner = kw.encode_message_set(msgs)
    if codec == "plain":
        wire = inner
    elif codec.startswith("gzip"):
        attrs = 0x01 | (0x08 if codec == "gzip_logappend" else 0)
        wire = _gzip_wrapper(inner, wrapper_offset=100, wrapper_ts=999,
                             attrs=attrs)
    elif codec == "magic0":
        wire = _gzip_wrapper(inner, wrapper_offset=100, wrapper_ts=0,
                             magic=0)
    else:
        comp = {"snappy": kw.snappy_compress_literal,
                "lz4": kw.lz4_compress_literal}[codec](inner)
        attrs = {"snappy": 0x02, "lz4": 0x03}[codec]
        body = (struct.pack(">bbq", 1, attrs, 5) + kw.enc_bytes(None)
                + kw.enc_bytes(comp))
        msg = struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body
        wire = struct.pack(">qi", 60, len(msg)) + msg
    got, want = kw.decode_message_set(wire), jkw.decode_message_set(wire)
    assert got == want and len(got) == len(msgs)
    # A truncated tail drops only the partial message, in both.
    assert kw.decode_message_set(inner[:-3]) == \
        jkw.decode_message_set(inner[:-3])


def test_crc_and_codec_errors_equal_jax():
    wire = bytearray(kw.encode_message_set([(b"a", None, 1)]))
    wire[-1] ^= 0xFF
    for mod in (kw, jkw):
        with pytest.raises(ValueError, match="CRC"):
            mod.decode_message_set(bytes(wire))
        # A gzip payload flagged snappy fails loudly in both.
        garbage = _gzip_wrapper(mod.encode_message_set([(b"a", None, 1)]),
                                wrapper_offset=0, wrapper_ts=0, attrs=0x02)
        with pytest.raises((ValueError, IndexError)):
            mod.decode_message_set(garbage)
    zstd = _gzip_wrapper(kw.encode_message_set([(b"a", None, 1)]),
                         wrapper_offset=0, wrapper_ts=0, attrs=0x04)
    with pytest.raises(NotImplementedError, match="zstd"):
        kw.decode_message_set(zstd)
    assert str(kw.KafkaError(35, "fetch t/0")) == \
        str(jkw.KafkaError(35, "fetch t/0"))
    assert kw._RETRIABLE == jkw._RETRIABLE


def test_bootstrap_parsing_portless_and_ipv6():
    c = kw.KafkaWireClient("[::1]:9093, broker:1234, [fe80::2], localhost")
    assert c.bootstrap == [("::1", 9093), ("broker", 1234),
                           ("fe80::2", 9092), ("localhost", 9092)]
    assert c.client_id == jkw.KafkaWireClient("x").client_id


# ---------------------------------------------------------------------------
# 2. over a real socket


def test_wire_client_produce_fetch_roundtrip(broker):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    assert client.metadata(["t"]) == {"t": [0]}
    assert client.produce("t", 0, [(b"a", None, 1), (b"b", b"k", 2)]) == 0
    assert client.list_offset("t", 0, kw.EARLIEST) == 0
    assert client.list_offset("t", 0, kw.LATEST) == 2
    msgs, hw = client.fetch("t", 0, 0)
    assert hw == 2
    assert [(v, k) for _, _, k, v in msgs] == [(b"a", None), (b"b", b"k")]
    assert [v for *_, v in client.fetch("t", 0, 1)[0]] == [b"b"]
    assert broker.log("t") == [(1, None, b"a"), (2, b"k", b"b")]
    client.close()


@pytest.mark.parametrize("codec", ["gzip", "snappy", "lz4", "lz4-legacy"])
def test_wire_client_compressed_fetch_roundtrip(broker, codec):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("t", 0, [(b"a", None, 1), (b"b", b"k", 2),
                            (b"c", None, 3)])
    broker.fetch_codec = codec
    msgs, hw = client.fetch("t", 0, 0)
    assert hw == 3
    assert msgs == [(0, 1, None, b"a"), (1, 2, b"k", b"b"),
                    (2, 3, None, b"c")]
    assert [(o, v) for o, _, _, v in client.fetch("t", 0, 2)[0]] == \
        [(2, b"c")]
    client.close()


def _two_partitions(records0, records1):
    b = FakeBroker(num_partitions=2)
    client = kw.KafkaWireClient(f"127.0.0.1:{b.port}")
    client.produce("t", 0, records0)
    client.produce("t", 1, records1)
    client.close()
    return b


def test_multi_partition_timestamp_merge(monkeypatch):
    _no_libs(monkeypatch)
    b = _two_partitions([(f"r{t}".encode(), None, t) for t in range(0, 20, 2)],
                        [(f"r{t}".encode(), None, t) for t in range(1, 20, 2)])
    try:
        bs = f"127.0.0.1:{b.port}"
        got = list(itertools.islice(tkafka.kafka_source("t", bs, str), 20))
        want = list(itertools.islice(jkafka.kafka_source("t", bs, str), 20))
        assert got == want == [f"r{t}" for t in range(20)]
    finally:
        b.close()


def test_multi_partition_nonmonotone_ts_no_duplicates(monkeypatch):
    _no_libs(monkeypatch)
    b = _two_partitions([(b"p0a", None, 100), (b"p0b", None, 50)],
                        [(b"p1a", None, 60), (b"p1b", None, 70)])
    try:
        src = tkafka.WireKafkaSource("t", f"127.0.0.1:{b.port}", parser=str)
        got = list(itertools.islice(iter(src), 4))
        src.close()
        assert sorted(got) == ["p0a", "p0b", "p1a", "p1b"]
        assert len(set(got)) == 4
    finally:
        b.close()


def test_compacted_topic_offset_gap_no_stall_no_dupes(monkeypatch):
    _no_libs(monkeypatch)
    b = _two_partitions(
        [(f"p0-{i}".encode(), None, 10 * i) for i in range(6)],
        [(f"p1-{i}".encode(), None, 10 * i + 5) for i in range(3)])
    try:
        b.holes[("t", 0)] = {0, 2, 3}
        out = {}
        for name, mod in (("port", tkafka), ("jax", jkafka)):
            src = mod.WireKafkaSource("t", f"127.0.0.1:{b.port}", parser=str)
            out[name] = (list(itertools.islice(iter(src), 6)), src.offsets)
            src.close()
        assert out["port"] == out["jax"]
        got, offsets = out["port"]
        assert sorted(got) == ["p0-1", "p0-4", "p0-5", "p1-0", "p1-1",
                               "p1-2"]
        assert offsets == {0: 6, 1: 3}
    finally:
        b.close()


def test_mid_round_checkpoint_nonmonotone_ts_no_loss(monkeypatch):
    _no_libs(monkeypatch)
    b = _two_partitions([(b"late", None, 200), (b"early", None, 100)],
                        [(b"mid", None, 150)])
    try:
        bs = f"127.0.0.1:{b.port}"
        src1 = tkafka.WireKafkaSource("t", bs, parser=str)
        first = list(itertools.islice(iter(src1), 1))
        snap = src1.offsets
        src1.close()
        assert first == ["early"] and snap.get(0, 0) == 0
        src2 = tkafka.WireKafkaSource("t", bs, parser=str,
                                      start_offsets=snap)
        rest = list(itertools.islice(iter(src2), 3))
        src2.close()
        assert set(first) | set(rest) == {"late", "early", "mid"}
    finally:
        b.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_kill_and_resume_replays_no_gap_no_dup(monkeypatch, tmp_path,
                                               writer):
    """Killed mid fetch round, the source resumes from checkpointed
    offsets exactly after the last yielded record: from the port's own
    checkpoint, and from a JAX source's checkpoint read through
    ``state.load_jax_checkpoint``."""
    from spatialflink_tpu_torch.state import load_jax_checkpoint

    _no_libs(monkeypatch)
    b = _two_partitions([(f"r{t}".encode(), None, t) for t in range(0, 30, 2)],
                        [(f"r{t}".encode(), None, t) for t in range(1, 30, 2)])
    try:
        bs = f"127.0.0.1:{b.port}"
        path = str(tmp_path / "ckpt.bin")
        mod, cmod = (tkafka, ck) if writer == "port" else (jkafka, jck)
        src1 = mod.WireKafkaSource("t", bs, parser=str)
        first = list(itertools.islice(iter(src1), 13))
        assert first == [f"r{t}" for t in range(13)]
        cmod.save_checkpoint(path, source=cmod.kafka_source_state(src1))
        src1.close()  # kill
        load = ck.load_checkpoint if writer == "port" else load_jax_checkpoint
        state = load(path)["source"]
        with pytest.raises(ValueError, match="topic"):
            ck.restore_kafka_source_offsets(state, "other")
        src2 = tkafka.WireKafkaSource(
            "t", bs, parser=str,
            start_offsets=ck.restore_kafka_source_offsets(state, "t"))
        rest = list(itertools.islice(iter(src2), 17))
        src2.close()
        assert rest == [f"r{t}" for t in range(13, 30)]
    finally:
        b.close()


def test_sink_and_source_over_real_socket(broker, monkeypatch):
    """KafkaSink → broker → kafka_source → the port's range operator on
    the CPU, equal to the operator fed the original objects and to the
    JAX operator fed through the JAX source."""
    from spatialflink_tpu.grid import UniformGrid as JGrid
    from spatialflink_tpu.models.objects import Point as JPoint
    from spatialflink_tpu.operators import PointPointRangeQuery as JRange
    from spatialflink_tpu.operators import QueryConfiguration as JConf
    from spatialflink_tpu.operators import QueryType as JQT
    from spatialflink_tpu.streams.serde import parse_geojson as jparse

    from spatialflink_tpu_torch.grid import UniformGrid
    from spatialflink_tpu_torch.models.objects import Point
    from spatialflink_tpu_torch.operators import (
        PointPointRangeQuery,
        QueryConfiguration,
    )
    from spatialflink_tpu_torch.streams.serde import (
        parse_geojson,
        to_geojson,
    )

    _no_libs(monkeypatch)
    rng = np.random.default_rng(9)
    pts = [Point(obj_id=f"d{i % 7}", timestamp=int(i * 30),
                 x=float(rng.uniform(0, 10)), y=float(rng.uniform(0, 10)))
           for i in range(400)]
    bs = f"127.0.0.1:{broker.port}"
    sink = tkafka.KafkaSink("gps", bs, formatter=to_geojson, batch=64)
    for p in pts:
        sink(p)
    sink.close()
    assert broker.total("gps") == 400

    def results(stream):
        op = PointPointRangeQuery(
            QueryConfiguration(window_size=5, slide_step=5),
            UniformGrid(20, 0.0, 10.0, 0.0, 10.0), device="cpu")
        return [(r.start, r.end, sorted((o.obj_id, o.timestamp)
                                        for o in r.objects))
                for r in op.run(stream, [Point(x=5.0, y=5.0)], 2.0)]

    got = results(itertools.islice(
        tkafka.kafka_source("gps", bs, parser=parse_geojson), len(pts)))
    assert got == results(iter(pts)) and any(w[2] for w in got)
    jop = JRange(JConf(JQT.WindowBased, window_size=5, slide_step=5),
                 JGrid(20, 0.0, 10.0, 0.0, 10.0))
    want = [(r.start, r.end, sorted((o.obj_id, o.timestamp)
                                    for o in r.objects))
            for r in jop.run(itertools.islice(
                jkafka.kafka_source("gps", bs, parser=jparse), len(pts)),
                [JPoint(x=5.0, y=5.0)], 2.0)]
    assert got == want


def test_wire_source_skips_malformed(broker, monkeypatch):
    from spatialflink_tpu_torch.streams.serde import parse_csv_point

    _no_libs(monkeypatch)
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("csv", 0, [(b"a,100,1.0,2.0", None, 0),
                              (b"not,a,valid,record,###", None, 0),
                              (b"", None, 0), (None, None, 0),
                              (b"b,200,3.0,4.0", None, 0)])
    client.close()
    src = tkafka.WireKafkaSource("csv", f"127.0.0.1:{broker.port}",
                                 parser=parse_csv_point)
    got = list(itertools.islice(iter(src), 2))
    assert [p.obj_id for p in got] == ["a", "b"]
    assert src.offsets == {0: 5}  # skipped records were consumed
    src.close()


def test_mid_fetch_socket_drop_retries_at_same_offset_no_dup(broker):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("drop", 0, [(f"r{i}".encode(), None, i) for i in range(8)])
    broker.kill_after_bytes = 7
    msgs, hw = client.fetch("drop", 0, 0)
    assert hw == 8 and [m[0] for m in msgs] == list(range(8))
    assert [m[3] for m in msgs] == [f"r{i}".encode() for i in range(8)]
    client.close()


def test_mid_fetch_drop_through_source_yields_each_record_once(broker):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("dropsrc", 0,
                   [(f"a{i}".encode(), None, i) for i in range(5)])
    src = tkafka.WireKafkaSource("dropsrc", f"127.0.0.1:{broker.port}",
                                 parser=str)
    it = iter(src)
    got = [next(it) for _ in range(5)]
    broker.kill_after_bytes = 5
    client.produce("dropsrc", 0,
                   [(f"b{i}".encode(), None, 5 + i) for i in range(5)])
    got += [next(it) for _ in range(5)]
    assert got == [f"a{i}" for i in range(5)] + [f"b{i}" for i in range(5)]
    assert src.offsets == {0: 10}
    client.close()
    src.close()


def test_leader_change_refreshes_metadata_and_resumes(broker):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("lead", 0, [(f"x{i}".encode(), None, i) for i in range(6)])
    before = broker.metadata_requests
    broker.fetch_errors = [6]
    msgs, _ = client.fetch("lead", 0, 2)
    assert [m[0] for m in msgs] == [2, 3, 4, 5]
    assert broker.metadata_requests > before and broker.fetch_requests >= 2
    client.close()


def test_leader_retry_budget_exhausts_loudly(broker):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("dead", 0, [(b"v", None, 0)])
    broker.fetch_errors = [6, 6, 6, 6, 6]
    with pytest.raises(kw.KafkaError) as err:
        client.fetch("dead", 0, 0)
    assert err.value.code == 6
    client.close()


# ---------------------------------------------------------------------------
# 3. the fault points


@pytest.mark.parametrize("at", [1, 2])
def test_kafka_leader_fault_fires_as_in_jax_and_is_not_retried(broker, at):
    client = kw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    client.produce("chaos", 0, [(b"v", None, 0)])
    produced = broker.fetch_requests
    faults.arm([{"point": "kafka.leader", "at": at}])
    if at == 2:
        client.fetch("chaos", 0, 0)  # the first leader-routed attempt
    with pytest.raises(InjectedFault):
        client.fetch("chaos", 0, 0)
    assert broker.fetch_requests == produced + at - 1
    assert [f["point"] for f in faults.fired] == ["kafka.leader"]
    faults.disarm()
    client.close()
    # The JAX client fires at the same hit.
    jclient = jkw.KafkaWireClient(f"127.0.0.1:{broker.port}")
    jfaults.arm([{"point": "kafka.leader", "at": at}])
    if at == 2:
        jclient.fetch("chaos", 0, 0)
    with pytest.raises(Exception, match="kafka.leader"):
        jclient.fetch("chaos", 0, 0)
    jclient.close()


def test_kafka_fetch_fault_kills_the_source_at_the_armed_round(monkeypatch):
    """``kafka.fetch`` fires at the named fetch (one a partition a round):
    records already yielded stay yielded, the offsets stand where they
    were, and a source resumed from them continues with no gap, in both
    packages alike."""
    _no_libs(monkeypatch)
    b = _two_partitions([(f"r{t}".encode(), None, t) for t in range(0, 12, 2)],
                        [(f"r{t}".encode(), None, t) for t in range(1, 12, 2)])
    try:
        bs = f"127.0.0.1:{b.port}"
        # Each fetch returns what the partition holds: round 1 reads both
        # partitions whole, so the third fetch (round 2) is the kill.
        out = {}
        for name, mod, flt in (("port", tkafka, faults),
                               ("jax", jkafka, jfaults)):
            flt.arm([{"point": "kafka.fetch", "at": 3}])
            src = mod.WireKafkaSource("t", bs, parser=str)
            got = []
            with pytest.raises(Exception, match="kafka.fetch"):
                for rec in src:
                    got.append(rec)
            out[name] = (got, src.offsets)
            src.close()
            flt.disarm()
        assert out["port"] == out["jax"]
        got, offsets = out["port"]
        assert got == [f"r{t}" for t in range(12)]
        assert offsets == {0: 6, 1: 6}
    finally:
        b.close()


# ---------------------------------------------------------------------------
# 4. the headline wire pipeline, killed and resumed


def _wire_pipeline_windows(pkg, bs, conf_grid, parse, start=None, count=0,
                           snapshot=None):
    """One run of Kafka → ``WirePaneAssembler`` → ``run_wire_panes`` in
    ``pkg`` ("port" on the CPU, or "jax"): ``count`` windows, from
    ``start`` (a checkpoint) or the topic's start; ``snapshot`` receives
    the three components after the last window."""
    if pkg == "port":
        from spatialflink_tpu_torch.checkpoint import (
            operator_state,
            restore_operator,
            restore_wire_pane_assembler,
            wire_pane_assembler_state,
        )
        from spatialflink_tpu_torch.models.objects import Point
        from spatialflink_tpu_torch.operators import PointPointKNNQuery
        from spatialflink_tpu_torch.streams.wire import WirePaneAssembler
        mod, cmod = tkafka, ck
        make_op = lambda conf, grid: PointPointKNNQuery(conf, grid,  # noqa
                                                        device="cpu")
    else:
        from spatialflink_tpu.checkpoint import (
            operator_state,
            restore_operator,
            restore_wire_pane_assembler,
            wire_pane_assembler_state,
        )
        from spatialflink_tpu.models.objects import Point
        from spatialflink_tpu.operators import PointPointKNNQuery
        from spatialflink_tpu.streams.wire import WirePaneAssembler
        mod, cmod = jkafka, jck
        make_op = PointPointKNNQuery
    conf, grid, wf = conf_grid(pkg)
    slide_ms = conf.slide_step_ms
    offsets = None
    asm = WirePaneAssembler(wf, slide_ms, start_ms=0)
    op = make_op(conf, grid)
    if start is not None:
        offsets = cmod.restore_kafka_source_offsets(start["source"], "gps")
        restore_wire_pane_assembler(asm, start["panes"])
        restore_operator(op, start["op"])
    src = mod.WireKafkaSource("gps", bs, parser=parse, start_offsets=offsets)

    def panes():
        for t, x, y, o in iter(src):
            yield from asm.feed({"ts": [t], "x": [x], "y": [y], "oid": [o]})

    gen = op.run_wire_panes(panes(), Point(x=5.0, y=5.0), 2.0, 5, 32, wf,
                            start_ms=0, flush_at_end=False)
    out = [(s, e, [int(v) for v in oo], [float(d) for d in dd], int(nv))
           for s, e, oo, dd, nv in itertools.islice(gen, count)]
    if snapshot is not None:
        snapshot.update(source=cmod.kafka_source_state(src),
                        panes=wire_pane_assembler_state(asm),
                        op=operator_state(op))
    src.close()
    return out


def test_full_wire_pipeline_kill_and_resume(monkeypatch, tmp_path):
    """The JAX oracle's story (``test_kafka_wire.py::
    test_full_wire_pipeline_kill_and_resume``) through the port: a
    checkpoint of the source offsets, the assembler and the digest ring
    between two windows, a kill, a resume in fresh objects; the committed
    windows plus the resumed ones equal the uninterrupted run, which
    equals the JAX pipeline's windows (ids and counts exact, distances
    within 1 float32 ulp: the JAX digest may contract an FMA)."""
    _no_libs(monkeypatch)
    rng = np.random.default_rng(77)
    n = 1_200
    slide_ms = 2_000
    ts = np.cumsum(rng.integers(1, slide_ms // 2, n)).astype(np.int64)
    xy = np.stack([rng.uniform(0, 10, n), rng.uniform(0, 10, n)], axis=1)
    oid = rng.integers(0, 32, n).astype(np.int64)

    def conf_grid(pkg):
        if pkg == "port":
            from spatialflink_tpu_torch.grid import UniformGrid
            from spatialflink_tpu_torch.operators import QueryConfiguration
            from spatialflink_tpu_torch.streams.wire import WireFormat
            conf = QueryConfiguration(window_size=4, slide_step=2)
        else:
            from spatialflink_tpu.grid import UniformGrid
            from spatialflink_tpu.operators import (
                QueryConfiguration,
                QueryType,
            )
            from spatialflink_tpu.streams.wire import WireFormat
            conf = QueryConfiguration(QueryType.WindowBased, window_size=4,
                                      slide_step=2)
        grid = UniformGrid(20, 0.0, 10.0, 0.0, 10.0)
        return conf, grid, WireFormat.for_grid(grid)

    xyf = conf_grid("port")[2].dequantize_np(conf_grid("port")[2].quantize(xy))
    b = FakeBroker()
    try:
        bs = f"127.0.0.1:{b.port}"
        sink = tkafka.KafkaSink("gps", bs, batch=500)
        for i in range(n):
            sink(f"{ts[i]},{float(xyf[i, 0])!r},{float(xyf[i, 1])!r},"
                 f"{oid[i]}")
        sink.close()
        assert b.total("gps") == n

        def parse(line):
            t, x, y, o = line.split(",")
            return int(t), float(x), float(y), int(o)

        total = int(ts[-1] // slide_ms) - 2
        baseline = _wire_pipeline_windows("port", bs, conf_grid, parse,
                                          count=total)
        cut = total // 3
        snap = {}
        part1 = _wire_pipeline_windows("port", bs, conf_grid, parse,
                                       count=cut, snapshot=snap)
        path = str(tmp_path / "pipeline.ckpt")
        ck.save_checkpoint(path, **snap)
        part2 = _wire_pipeline_windows("port", bs, conf_grid, parse,
                                       start=ck.load_checkpoint(path),
                                       count=total - cut)
        assert part1 + part2 == baseline
        assert part1 and part2 and sum(len(w[2]) for w in baseline) > 0
        want = _wire_pipeline_windows("jax", bs, conf_grid, parse,
                                      count=total)
        assert len(want) == len(baseline)
        for g, w in zip(baseline, want):
            assert g[:3] == w[:3] and g[4] == w[4]
            d32 = np.float32(w[3])
            assert np.all(np.abs(np.float32(g[3]) - d32)
                          <= np.spacing(d32))
    finally:
        b.close()


# ---------------------------------------------------------------------------
# 5. backends, the sink's final flush, the card phase's broker


class _FakeConsumer:
    def __init__(self, topic, bootstrap_servers=None, group_id=None,
                 auto_offset_reset=None):
        self._msgs = list(_LIB_TOPICS.get(topic, []))

    def __iter__(self):
        return (types.SimpleNamespace(value=v) for v in self._msgs)

    def close(self):
        pass


class _FakeProducer:
    def __init__(self, bootstrap_servers=None):
        self.flushed = 0

    def send(self, topic, value):
        _LIB_TOPICS.setdefault(topic, []).append(value)

    def flush(self):
        self.flushed += 1


_LIB_TOPICS: dict = {}


def test_library_backends_first_in_the_jax_order(monkeypatch):
    from spatialflink_tpu_torch.streams.serde import (
        parse_csv_point,
        to_csv_point,
    )
    from spatialflink_tpu_torch.models.objects import Point

    fake = types.SimpleNamespace(KafkaConsumer=_FakeConsumer,
                                 KafkaProducer=_FakeProducer)
    confluent = types.SimpleNamespace()
    monkeypatch.setitem(sys.modules, "kafka", fake)
    monkeypatch.setitem(sys.modules, "confluent_kafka", confluent)
    _LIB_TOPICS.clear()
    assert tkafka._import_kafka()[0] == jkafka._import_kafka()[0] == "kafka"
    pts = [Point(obj_id=f"v{i % 3}", timestamp=i, x=float(i), y=2.0)
           for i in range(5)]
    sink = tkafka.KafkaSink("p", "fake:9092", formatter=to_csv_point)
    for p in pts:
        sink(p)
    sink.close()
    _LIB_TOPICS["p"].insert(2, b"not,a,point,###,at,all")
    got = list(tkafka.kafka_source("p", "fake:9092", parse_csv_point))
    assert [(p.obj_id, p.timestamp) for p in got] == \
        [(p.obj_id, p.timestamp) for p in pts]
    monkeypatch.delitem(sys.modules, "kafka")
    assert tkafka._import_kafka()[0] == jkafka._import_kafka()[0] == \
        "confluent"
    monkeypatch.delitem(sys.modules, "confluent_kafka")
    _no_libs(monkeypatch)
    assert tkafka._import_kafka()[0] == "wire" and tkafka.kafka_available()
    assert tkafka._import_kafka()[1] is kw


def test_sink_final_flush_once(broker, monkeypatch):
    """An unclosed sink's buffered records go out at GC; a closed sink's
    finalizer is detached, so nothing is produced a second time."""
    _no_libs(monkeypatch)
    bs = f"127.0.0.1:{broker.port}"
    sink = tkafka.KafkaSink("fin", bs, batch=1000)
    for i in range(7):
        sink(f"a{i}")
    assert broker.total("fin") == 0
    del sink
    gc.collect()
    assert broker.total("fin") == 7
    sink = tkafka.KafkaSink("fin", bs, batch=1000)
    for i in range(5):
        sink(f"b{i}")
    sink.close()
    sink.close()
    assert broker.total("fin") == 12
    del sink
    gc.collect()
    assert broker.total("fin") == 12
    assert [v for _, _, v in broker.log("fin")] == \
        [f"a{i}".encode() for i in range(7)] + \
        [f"b{i}".encode() for i in range(5)]


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_kafka", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_broker_serves_the_port_client(monkeypatch):
    """The card phase's in-process broker (Metadata, Produce, Fetch and
    ListOffsets over TCP) serves the port's sink and source as
    ``FakeBroker`` does: the same records, offsets and watermarks."""
    _no_libs(monkeypatch)
    cs = _chip_smoke()
    mini, fake = cs.MiniBroker(), FakeBroker()
    try:
        seen = {}
        for name, b in (("mini", mini), ("fake", fake)):
            bs = f"127.0.0.1:{b.port}"
            sink = tkafka.KafkaSink("gps", bs, batch=300)
            for i in range(1_000):
                sink(f"{i},{i * 0.5!r},{i * 0.25!r},{i % 7}")
            sink.close()
            client = kw.KafkaWireClient(bs)
            meta = client.metadata(["gps"])
            offs = (client.list_offset("gps", 0, kw.EARLIEST),
                    client.list_offset("gps", 0, kw.LATEST))
            msgs, hw = client.fetch("gps", 0, 990)
            client.close()
            src = tkafka.WireKafkaSource("gps", bs, parser=str)
            recs = list(itertools.islice(iter(src), 1_000))
            seen[name] = (meta, offs, [(o, v) for o, _, _, v in msgs], hw,
                          recs, src.offsets)
            src.close()
        assert seen["mini"] == seen["fake"]
        assert seen["mini"][1] == (0, 1_000) and len(seen["mini"][4]) == 1_000
    finally:
        mini.close()
        fake.close()
