"""Built-in Kafka wire-protocol client — no external library, no pip.

The port's own copy of the JAX package's client: the same frames byte
for byte (tests/test_torch_kafka.py holds both encoders to the golden
frames), with the ``kafka.leader`` fault point of the port's ``faults``.

The reference's default transport is Kafka (FlinkKafkaConsumer/Producer,
StreamingJob.java:188-191,255; producer schemas Serialization.java:17-726).
This module speaks the Kafka binary protocol directly over a TCP socket so
the transport is a REAL capability in any environment with a broker:

- Metadata    (api_key 3, v0) — brokers + partition leaders
- Produce     (api_key 0, v2) — message format v1 (magic 1, CRC32,
                                 create-time timestamps)
- Fetch       (api_key 1, v2) — message format v1, partial trailing
                                 message handling
- ListOffsets (api_key 2, v0) — earliest (-2) / latest (-1)

Version support: these request versions are accepted by brokers 0.10
through 3.x (newer 3.x brokers down-convert the message format). Kafka
4.0 REMOVED pre-2.1 protocol versions and message format v1 (KIP-896 /
KIP-724); against a 4.0+ broker requests fail with UNSUPPORTED_VERSION
(error 35), which this client surfaces as a non-retriable KafkaError
naming the incompatibility — install kafka-python for 4.0+ brokers.
Consumer-group coordination is intentionally out of scope: the reference
relies on Flink's own partition assignment, and here partitions are
likewise assigned explicitly by the caller (streams/kafka.py round-robins
all partitions of the topic).

Frame grammar (big-endian): every request/response is int32-size-prefixed;
requests carry (api_key int16, api_version int16, correlation_id int32,
client_id string); responses echo the correlation id. Strings are
int16-length-prefixed (-1 = null); byte blobs int32-length-prefixed
(-1 = null); arrays int32-count-prefixed. Golden-frame tests:
tests/test_kafka_wire.py and tests/test_torch_kafka.py.
"""

from __future__ import annotations

import socket
import struct
import time
import zlib
from typing import Dict, List, Optional, Tuple

from spatialflink_tpu_torch.faults import faults

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3

EARLIEST = -2
LATEST = -1


# ---------- encoding ----------

def snappy_decompress(data: bytes) -> bytes:
    """Pure-python snappy decode — raw block format AND the xerial
    ("snappy-java") framing Kafka producers actually emit
    (magic ``\\x82SNAPPY\\x00`` + version/compat ints + length-prefixed
    raw blocks). No external library (environment contract); the decode
    is branch-light enough for the message sizes Kafka fetches carry.

    Raw format (google/snappy format_description.txt): varint
    uncompressed length, then tagged elements — tag & 3: 0 literal
    (length from the upper 6 bits, or 1-4 extra LE bytes when 60-63),
    1 copy with 11-bit offset / 4-11 length, 2 copy with 2-byte LE
    offset, 3 copy with 4-byte LE offset. Copies may overlap forward
    (byte-at-a-time semantics)."""
    if data[:8] == b"\x82SNAPPY\x00":
        out = bytearray()
        pos = 16  # magic + version + min-compat version
        while pos < len(data):
            if pos + 4 > len(data):
                raise ValueError("corrupt xerial snappy frame: truncated "
                                 "block length")
            (blen,) = struct.unpack(">i", data[pos:pos + 4])
            pos += 4
            if blen <= 0 or pos + blen > len(data):
                raise ValueError("corrupt xerial snappy frame: bad block "
                                 f"length {blen}")
            out += snappy_decompress(data[pos:pos + blen])
            pos += blen
        return bytes(out)

    # varint preamble: uncompressed length
    ulen = 0
    shift = 0
    pos = 0
    while True:
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if kind == 1:
            ln = ((tag >> 2) & 0x07) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("corrupt snappy stream: bad copy offset")
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:  # overlapping copy: byte-at-a-time semantics
            for i in range(ln):
                out.append(out[start + i])
    if len(out) != ulen:
        raise ValueError(
            f"corrupt snappy stream: got {len(out)} bytes, header says {ulen}"
        )
    return bytes(out)


def snappy_compress_literal(data: bytes) -> bytes:
    """Minimal VALID snappy encoder: the whole payload as literals (the
    format permits arbitrary element splits; compression optional).
    Test/round-trip helper — real producers send real compressors'
    output, which the decoder above handles."""
    out = bytearray()
    ulen = len(data)
    while True:
        b = ulen & 0x7F
        ulen >>= 7
        out.append(b | (0x80 if ulen else 0))
        if not ulen:
            break
    pos = 0
    while pos < len(data):
        chunk = data[pos:pos + 65536]
        ln = len(chunk) - 1
        if ln < 60:
            out.append(ln << 2)
        else:
            out.append(61 << 2)  # 61 ⇒ 2-byte little-endian length
            out += ln.to_bytes(2, "little")
        out += chunk
        pos += len(chunk)
    return bytes(out)


def _xxh32(data: bytes, seed: int = 0) -> int:
    """Pure-python xxHash32 — the checksum LZ4 frames carry (header HC,
    optional block and content checksums). Reference: the xxHash spec's
    32-bit algorithm; vectors pinned in tests/test_kafka_wire.py."""
    P1, P2, P3, P4, P5 = (
        2654435761, 2246822519, 3266489917, 668265263, 374761393,
    )
    mask = 0xFFFFFFFF

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & mask

    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + P1 + P2) & mask
        v2 = (seed + P2) & mask
        v3 = seed & mask
        v4 = (seed - P1) & mask
        while pos + 16 <= n:
            for i, v in enumerate((v1, v2, v3, v4)):
                lane = int.from_bytes(data[pos + 4 * i:pos + 4 * i + 4],
                                      "little")
                v = (v + lane * P2) & mask
                v = (rotl(v, 13) * P1) & mask
                if i == 0:
                    v1 = v
                elif i == 1:
                    v2 = v
                elif i == 2:
                    v3 = v
                else:
                    v4 = v
            pos += 16
        h = (rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18)) & mask
    else:
        h = (seed + P5) & mask
    h = (h + n) & mask
    while pos + 4 <= n:
        h = (h + int.from_bytes(data[pos:pos + 4], "little") * P3) & mask
        h = (rotl(h, 17) * P4) & mask
        pos += 4
    while pos < n:
        h = (h + data[pos] * P5) & mask
        h = (rotl(h, 11) * P1) & mask
        pos += 1
    h ^= h >> 15
    h = (h * P2) & mask
    h ^= h >> 13
    h = (h * P3) & mask
    h ^= h >> 16
    return h


def lz4_block_decompress(data: bytes, out: bytearray) -> None:
    """LZ4 *block* format decode, appending into ``out`` in place.

    Sequences of [token | literal-length ext | literals | 2-byte LE
    match offset | match-length ext]; the final sequence carries
    literals only. Appending into the caller's rolling buffer lets
    block-DEPENDENT frames (Kafka's legacy Java producer default)
    reference matches across block boundaries."""
    n = len(data)
    pos = 0
    while pos < n:
        token = data[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if pos >= n:
                    raise ValueError("corrupt lz4 block: truncated literal "
                                     "length")
                b = data[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        if pos + lit > n:
            raise ValueError("corrupt lz4 block: literals past end")
        out += data[pos:pos + lit]
        pos += lit
        if pos >= n:
            break  # final sequence: literals only
        if pos + 2 > n:
            raise ValueError("corrupt lz4 block: truncated match offset")
        off = int.from_bytes(data[pos:pos + 2], "little")
        pos += 2
        if off == 0 or off > len(out):
            raise ValueError(f"corrupt lz4 block: bad match offset {off}")
        mlen = token & 0x0F
        if mlen == 15:
            while True:
                if pos >= n:
                    raise ValueError("corrupt lz4 block: truncated match "
                                     "length")
                b = data[pos]
                pos += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        start = len(out) - off
        if off >= mlen:
            out += out[start:start + mlen]
        else:  # overlapping copy: byte-at-a-time semantics
            for i in range(mlen):
                out.append(out[start + i])


def lz4_decompress(data: bytes) -> bytes:
    """Pure-python LZ4 *frame* decode — what Kafka codec 3 carries.

    Verifies the frame magic, version, block checksums and content
    checksum (xxHash32) when present. The header checksum accepts BOTH
    the spec value (over the descriptor) and the legacy Kafka value
    (over magic+descriptor): pre-KIP-57 Java producers wrote the broken
    form with message format v0/v1 — exactly the message versions this
    client speaks — and brokers accept both. Loud ValueError on
    anything corrupt."""
    if len(data) < 7:
        raise ValueError("corrupt lz4 frame: too short")
    if data[:4] != b"\x04\x22\x4d\x18":
        raise ValueError("corrupt lz4 frame: bad magic "
                         f"{data[:4].hex()}")
    pos = 4
    flg = data[pos]
    bd = data[pos + 1]
    if (flg >> 6) != 0b01:
        raise ValueError(f"corrupt lz4 frame: unsupported version {flg >> 6}")
    if flg & 0x02:
        raise ValueError("corrupt lz4 frame: FLG reserved bit set")
    # BD: bits 6-4 carry the block-max-size code (4-7); the rest reserved.
    if bd & 0x8F or not 4 <= (bd >> 4) & 0x7 <= 7:
        raise ValueError(f"corrupt lz4 frame: bad BD byte {bd:#04x}")
    has_b_checksum = bool(flg & 0x10)
    has_c_size = bool(flg & 0x08)
    has_c_checksum = bool(flg & 0x04)
    has_dict = bool(flg & 0x01)
    desc_start = pos
    pos += 2
    content_size = None
    if has_c_size:
        content_size = int.from_bytes(data[pos:pos + 8], "little")
        pos += 8
    if has_dict:
        pos += 4
    if pos >= len(data):
        raise ValueError("corrupt lz4 frame: truncated header")
    hc = data[pos]
    spec_hc = (_xxh32(data[desc_start:pos]) >> 8) & 0xFF
    legacy_hc = (_xxh32(data[:pos]) >> 8) & 0xFF  # pre-KIP-57 Kafka
    if hc not in (spec_hc, legacy_hc):
        raise ValueError(
            f"corrupt lz4 frame: header checksum {hc:#04x} matches "
            f"neither spec ({spec_hc:#04x}) nor legacy-Kafka "
            f"({legacy_hc:#04x})"
        )
    pos += 1
    out = bytearray()
    while True:
        if pos + 4 > len(data):
            raise ValueError("corrupt lz4 frame: missing EndMark")
        bsize = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
        if bsize == 0:  # EndMark
            break
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        if pos + bsize > len(data):
            raise ValueError("corrupt lz4 frame: block past end")
        block = data[pos:pos + bsize]
        pos += bsize
        if has_b_checksum:
            want = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
            got = _xxh32(block)
            if got != want:
                raise ValueError(
                    f"corrupt lz4 frame: block checksum {got:#010x} != "
                    f"{want:#010x}"
                )
        if uncompressed:
            out += block
        else:
            lz4_block_decompress(block, out)
    if has_c_checksum:
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = _xxh32(bytes(out))
        if got != want:
            raise ValueError(
                f"corrupt lz4 frame: content checksum {got:#010x} != "
                f"{want:#010x}"
            )
    if content_size is not None and len(out) != content_size:
        raise ValueError(
            f"corrupt lz4 frame: got {len(out)} bytes, header says "
            f"{content_size}"
        )
    return bytes(out)


def lz4_compress_literal(data: bytes, legacy_hc: bool = False,
                         block_checksum: bool = False) -> bytes:
    """Minimal VALID LZ4 frame encoder: literal-only compressed blocks,
    content checksum always present. Test/round-trip helper (real
    producers send real compressors' output — the decoder above handles
    matches, overlaps and uncompressed blocks). ``legacy_hc`` writes
    the pre-KIP-57 Kafka header checksum variant."""
    flg = 0x40 | 0x20 | 0x04  # v01, block-independent, content checksum
    if block_checksum:
        flg |= 0x10
    bd = 0x40  # 64 KB max block size
    header = bytes([flg, bd])
    magic = b"\x04\x22\x4d\x18"
    hc_src = magic + header if legacy_hc else header
    out = bytearray(magic + header)
    out.append((_xxh32(hc_src) >> 8) & 0xFF)
    pos = 0
    # Chunk so the STORED block (token + length ext + literals) stays
    # within the 64 KiB maximum the BD byte declares — a spec decoder
    # rejects oversized blocks (65200 literals need ≤ 257 header bytes).
    while pos < len(data):
        chunk = data[pos:pos + 65200]
        pos += len(chunk)
        block = bytearray()
        lit = len(chunk)
        token_lit = min(lit, 15)
        block.append(token_lit << 4)
        if token_lit == 15:
            rest = lit - 15
            while rest >= 255:
                block.append(255)
                rest -= 255
            block.append(rest)
        block += chunk
        out += len(block).to_bytes(4, "little")
        out += block
        if block_checksum:
            out += _xxh32(bytes(block)).to_bytes(4, "little")
    out += (0).to_bytes(4, "little")  # EndMark
    out += _xxh32(data).to_bytes(4, "little")
    return bytes(out)


def enc_string(s: Optional[str]) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def enc_bytes(b: Optional[bytes]) -> bytes:
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


def enc_array(items: List[bytes]) -> bytes:
    return struct.pack(">i", len(items)) + b"".join(items)


def encode_message_v1(value: Optional[bytes], key: Optional[bytes],
                      timestamp_ms: int) -> bytes:
    """One message (format v1): crc | magic=1 | attrs=0 | timestamp |
    key | value; crc covers everything after itself."""
    body = (
        struct.pack(">bbq", 1, 0, timestamp_ms)
        + enc_bytes(key)
        + enc_bytes(value)
    )
    return struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF) + body


def encode_message_set(messages: List[Tuple[Optional[bytes], Optional[bytes],
                                            int]]) -> bytes:
    """[(value, key, timestamp_ms)] → wire message set (offsets are
    producer-side placeholders; the broker assigns real ones)."""
    out = []
    for i, (value, key, ts) in enumerate(messages):
        msg = encode_message_v1(value, key, ts)
        out.append(struct.pack(">qi", i, len(msg)) + msg)
    return b"".join(out)


def encode_request(api_key: int, api_version: int, correlation_id: int,
                   client_id: str, body: bytes) -> bytes:
    payload = (
        struct.pack(">hhi", api_key, api_version, correlation_id)
        + enc_string(client_id)
        + body
    )
    return struct.pack(">i", len(payload)) + payload


def encode_metadata_request(topics: List[str]) -> bytes:
    return enc_array([enc_string(t) for t in topics])


def encode_produce_request(topic: str, partition: int, message_set: bytes,
                           acks: int = 1, timeout_ms: int = 10_000) -> bytes:
    part = (
        struct.pack(">i", partition)
        + struct.pack(">i", len(message_set))
        + message_set
    )
    topic_data = enc_string(topic) + enc_array([part])
    return struct.pack(">hi", acks, timeout_ms) + enc_array([topic_data])


def encode_fetch_request(topic: str, partition: int, offset: int,
                         max_bytes: int = 1 << 20, max_wait_ms: int = 500,
                         min_bytes: int = 1) -> bytes:
    part = struct.pack(">iqi", partition, offset, max_bytes)
    topic_data = enc_string(topic) + enc_array([part])
    return (
        struct.pack(">iii", -1, max_wait_ms, min_bytes)
        + enc_array([topic_data])
    )


def encode_list_offsets_request(topic: str, partition: int,
                                timestamp: int) -> bytes:
    part = struct.pack(">iqi", partition, timestamp, 1)  # max_offsets=1 (v0)
    topic_data = enc_string(topic) + enc_array([part])
    return struct.pack(">i", -1) + enc_array([topic_data])


# ---------- decoding ----------

class Reader:
    """Cursor over a response payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def _take(self, n: int) -> bytes:
        if self.remaining() < n:
            raise EOFError("short read in Kafka response")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def int8(self) -> int:
        return struct.unpack(">b", self._take(1))[0]

    def int16(self) -> int:
        return struct.unpack(">h", self._take(2))[0]

    def int32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def int64(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def uint32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def string(self) -> Optional[str]:
        n = self.int16()
        if n == -1:
            return None
        return self._take(n).decode()

    def bytes_(self) -> Optional[bytes]:
        n = self.int32()
        if n == -1:
            return None
        return self._take(n)


def decode_message_set(data: bytes) -> List[Tuple[int, int, Optional[bytes],
                                                  Optional[bytes]]]:
    """Wire message set → [(offset, timestamp_ms, key, value)].

    A fetch response may end with a PARTIAL message (the broker truncates
    at max_bytes) — stop cleanly there. Message format v0 (magic 0, no
    timestamp → -1) and v1 both decode.

    GZIP-compressed sets (attributes codec 1) decode transparently: the
    wrapper's value is itself a message set, recursively decoded. With
    magic v1 wrappers the inner offsets are RELATIVE (KIP-31: wrapper
    offset = absolute offset of the LAST inner message) and a
    LogAppendTime wrapper (attr bit 0x08) overrides every inner
    timestamp — both per the Kafka message-format spec. Snappy sets
    (codec 2, raw or xerial-framed) decode via the pure-python
    ``snappy_decompress``; lz4 sets (codec 3, LZ4 frames incl. the
    pre-KIP-57 legacy header checksum) via ``lz4_decompress``. zstd
    (codec 4, KIP-110) requires message format v2, which this
    pre-2.1-protocol client never negotiates — it still raises (the
    reference gets every codec via the Flink Kafka connector's client,
    pom.xml:81)."""
    out = []
    r = Reader(data)
    while r.remaining() >= 12:
        offset = r.int64()
        size = r.int32()
        if r.remaining() < size:
            break  # partial trailing message
        msg = Reader(r._take(size))
        crc = msg.uint32()
        rest = msg.data[msg.pos:]
        if zlib.crc32(rest) & 0xFFFFFFFF != crc:
            raise ValueError(f"Kafka message CRC mismatch at offset {offset}")
        magic = msg.int8()
        attrs = msg.int8()
        codec = attrs & 0x07
        ts = msg.int64() if magic >= 1 else -1
        key = msg.bytes_()
        value = msg.bytes_()
        if codec == 0:
            out.append((offset, ts, key, value))
            continue
        if value is None:
            raise ValueError(
                f"compressed Kafka wrapper at offset {offset} has a null "
                "value (corrupt message set)"
            )
        if codec not in (1, 2, 3):
            name = {4: "zstd"}.get(codec, str(codec))
            raise NotImplementedError(
                f"{name}-compressed Kafka message sets are not supported "
                "by the built-in client (gzip, snappy and lz4 decode "
                "natively; zstd needs the v2 record-batch protocol — "
                "produce uncompressed or install kafka-python)"
            )
        if codec == 2:
            inner = decode_message_set(snappy_decompress(value))
        elif codec == 3:
            inner = decode_message_set(lz4_decompress(value))
        else:
            # wbits=47: auto-detect gzip or zlib framing.
            inner = decode_message_set(zlib.decompress(value, 47))
        if magic >= 1 and inner:
            base = offset - inner[-1][0]
            inner = [(base + o, t, k, v) for o, t, k, v in inner]
        if magic >= 1 and (attrs & 0x08) and ts >= 0:
            inner = [(o, ts, k, v) for o, _, k, v in inner]
        out.extend(inner)
    return out


class KafkaError(RuntimeError):
    def __init__(self, code: int, where: str):
        detail = ""
        if code == 35:  # UNSUPPORTED_VERSION
            detail = (
                " (the broker rejected this protocol version — Kafka 4.0+"
                " removed the pre-2.1 versions this built-in client"
                " speaks, KIP-896; install kafka-python for 4.0+ brokers)"
            )
        super().__init__(f"Kafka error code {code} in {where}{detail}")
        self.code = code


_RETRIABLE = {3, 5, 6, 7, 14, 15, 16}  # unknown topic/partition (during
# auto-create), leader-not-available, not-leader, request-timeout,
# coordinator codes — metadata refresh + retry territory.


class KafkaWireClient:
    """Minimal leader-routed client over raw sockets (one per broker)."""

    def __init__(self, bootstrap_servers: str,
                 client_id: str = "spatialflink-tpu",
                 timeout_s: float = 15.0):
        self.bootstrap: List[Tuple[str, int]] = []
        for hp in bootstrap_servers.split(","):
            hp = hp.strip()
            if hp.startswith("["):  # bracketed IPv6: [::1]:9092 or [::1]
                host, _, rest = hp[1:].partition("]")
                port = rest.lstrip(":") or "9092"
            elif ":" in hp:
                host, _, port = hp.rpartition(":")
            else:  # bare hostname → Kafka's default port
                host, port = hp, "9092"
            self.bootstrap.append((host or "localhost", int(port)))
        self.client_id = client_id
        self.timeout_s = timeout_s
        self._socks: Dict[Tuple[str, int], socket.socket] = {}
        self._corr = 0
        self._brokers: Dict[int, Tuple[str, int]] = {}
        self._leaders: Dict[Tuple[str, int], int] = {}  # (topic, part) → node

    # -- transport --

    def _sock(self, addr: Tuple[str, int]) -> socket.socket:
        s = self._socks.get(addr)
        if s is None:
            s = socket.create_connection(addr, timeout=self.timeout_s)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._socks[addr] = s
        return s

    def _drop(self, addr: Tuple[str, int]) -> None:
        s = self._socks.pop(addr, None)
        if s is not None:
            try:
                s.close()
            except OSError:
                pass

    def _roundtrip(self, addr: Tuple[str, int], api_key: int,
                   api_version: int, body: bytes) -> Reader:
        self._corr += 1
        corr = self._corr
        frame = encode_request(api_key, api_version, corr, self.client_id,
                               body)
        try:
            s = self._sock(addr)
            s.sendall(frame)
            size = struct.unpack(">i", self._recv_exact(s, 4))[0]
            payload = self._recv_exact(s, size)
        except OSError:
            self._drop(addr)
            raise
        r = Reader(payload)
        got = r.int32()
        if got != corr:
            self._drop(addr)
            raise RuntimeError(
                f"Kafka correlation id mismatch: sent {corr}, got {got}"
            )
        return r

    @staticmethod
    def _recv_exact(s: socket.socket, n: int) -> bytes:
        chunks = []
        while n:
            chunk = s.recv(n)
            if not chunk:
                raise OSError("Kafka broker closed the connection")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def close(self) -> None:
        for addr in list(self._socks):
            self._drop(addr)

    # -- protocol --

    def metadata(self, topics: List[str]) -> Dict[str, List[int]]:
        """Refresh broker + leader tables; returns {topic: [partitions]}."""
        last_err: Optional[Exception] = None
        for addr in self.bootstrap or [("localhost", 9092)]:
            try:
                r = self._roundtrip(
                    addr, API_METADATA, 0, encode_metadata_request(topics)
                )
            except OSError as e:
                last_err = e
                continue
            n_brokers = r.int32()
            for _ in range(n_brokers):
                node = r.int32()
                host = r.string()
                port = r.int32()
                self._brokers[node] = (host or "localhost", port)
            out: Dict[str, List[int]] = {}
            n_topics = r.int32()
            for _ in range(n_topics):
                terr = r.int16()
                name = r.string() or ""
                parts = []
                n_parts = r.int32()
                for _ in range(n_parts):
                    perr = r.int16()
                    pid = r.int32()
                    leader = r.int32()
                    for _ in range(r.int32()):  # replicas
                        r.int32()
                    for _ in range(r.int32()):  # isr
                        r.int32()
                    if perr == 0 and leader >= 0:
                        self._leaders[(name, pid)] = leader
                    parts.append(pid)
                if terr == 0:
                    out[name] = sorted(parts)
            return out
        raise last_err or RuntimeError("no bootstrap broker reachable")

    def _leader_addr(self, topic: str, partition: int) -> Tuple[str, int]:
        key = (topic, partition)
        if key not in self._leaders:
            self.metadata([topic])
        if key not in self._leaders:
            raise KafkaError(3, f"metadata for {topic}/{partition}")
        return self._brokers[self._leaders[key]]

    def _with_leader_retry(self, topic, partition, fn):
        last: Optional[Exception] = None
        for attempt in range(3):
            try:
                if faults.armed:  # chaos injection point (faults.py)
                    faults.hit("kafka.leader")
                return fn(self._leader_addr(topic, partition))
            except KafkaError as e:
                if e.code not in _RETRIABLE:
                    raise
                last = e
            except OSError as e:
                last = e
            self._leaders.pop((topic, partition), None)
            time.sleep(0.2 * (attempt + 1))
        raise last  # type: ignore[misc]

    def produce(self, topic: str, partition: int,
                messages: List[Tuple[Optional[bytes], Optional[bytes], int]],
                acks: int = 1) -> int:
        """[(value, key, timestamp_ms)] → base offset assigned (acks!=0)."""
        mset = encode_message_set(messages)
        body = encode_produce_request(topic, partition, mset, acks=acks)

        def go(addr):
            r = self._roundtrip(addr, API_PRODUCE, 2, body)
            base = -1
            for _ in range(r.int32()):  # topics
                r.string()
                for _ in range(r.int32()):  # partitions
                    r.int32()  # partition id
                    err = r.int16()
                    base = r.int64()
                    r.int64()  # log_append_time
                    if err:
                        raise KafkaError(err, f"produce {topic}/{partition}")
            r.int32()  # throttle_time_ms
            return base

        if acks == 0:
            # Fire-and-forget: no response frame follows.
            addr = self._leader_addr(topic, partition)
            s = self._sock(addr)
            self._corr += 1
            s.sendall(encode_request(API_PRODUCE, 2, self._corr,
                                     self.client_id, body))
            return -1
        return self._with_leader_retry(topic, partition, go)

    def fetch(self, topic: str, partition: int, offset: int,
              max_bytes: int = 1 << 20, max_wait_ms: int = 500,
              ) -> Tuple[List[Tuple[int, int, Optional[bytes],
                                    Optional[bytes]]], int]:
        """→ ([(offset, ts, key, value)], high_watermark)."""
        body = encode_fetch_request(topic, partition, offset,
                                    max_bytes=max_bytes,
                                    max_wait_ms=max_wait_ms)

        def go(addr):
            r = self._roundtrip(addr, API_FETCH, 2, body)
            r.int32()  # throttle_time_ms
            msgs: List = []
            hw = -1
            for _ in range(r.int32()):  # topics
                r.string()
                for _ in range(r.int32()):  # partitions
                    r.int32()  # partition id
                    err = r.int16()
                    hw = r.int64()
                    mset = r.bytes_() or b""
                    if err:
                        raise KafkaError(err, f"fetch {topic}/{partition}")
                    msgs.extend(decode_message_set(mset))
            return msgs, hw

        return self._with_leader_retry(topic, partition, go)

    def list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        """EARLIEST (-2) or LATEST (-1) → offset."""
        body = encode_list_offsets_request(topic, partition, timestamp)

        def go(addr):
            r = self._roundtrip(addr, API_LIST_OFFSETS, 0, body)
            off = -1
            for _ in range(r.int32()):  # topics
                r.string()
                for _ in range(r.int32()):  # partitions
                    r.int32()
                    err = r.int16()
                    n_off = r.int32()
                    offs = [r.int64() for _ in range(n_off)]
                    if err:
                        raise KafkaError(
                            err, f"list_offsets {topic}/{partition}"
                        )
                    if offs:
                        off = offs[0]
            return off

        return self._with_leader_retry(topic, partition, go)
