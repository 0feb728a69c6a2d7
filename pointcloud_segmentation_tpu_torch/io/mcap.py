"""Offline MCAP (ROS2 bag) ingestion — the successor recording format,
read without a ROS2 installation.  The port's own copy of the JAX package's
io/mcap.py (same code, tests/test_torch_isolation.py).

The reference stack is ROS1 (`io/rosbag.py` reads its `rosbag record`
output); fleets that migrated to ROS2 record the same `/tof_pc`
PointCloud2 + pose topics into `.mcap` files (rosbag2's default storage
since Iron).  This module is a pure-Python linear-scan MCAP reader plus a
CDR deserializer for the three message types the pipeline consumes
(`sensor_msgs/msg/PointCloud2`, `geometry_msgs/msg/PoseStamped`,
`nav_msgs/msg/Odometry`), surfaced through the same `(clouds, poses)` /
`Frame` API as the ROS1 reader — `io.rosbag.read_bag`/`bag_to_frames`
sniff the file magic and route here, so `pcs-torch run --bag` accepts either
container.

Format notes (mcap.dev spec):
  * magic ``\\x89MCAP0\\r\\n`` at both ends; records are
    ``u8 opcode | u64 content_len | content``;
  * opcodes used: 0x03 Schema (id, name), 0x04 Channel (id, schema_id,
    topic, message_encoding), 0x05 Message (channel_id, seq, log_time,
    publish_time, data), 0x06 Chunk (nested records; compression ""/
    "lz4"/"zstd");  indexes/statistics/attachments are skipped — linear
    scan, so index-less or truncated files read fine;
  * message payloads are CDR: 4-byte encapsulation header (0x00 0x01 =
    little-endian), then primitives aligned to their size relative to the
    post-header offset; strings are u32 length INCLUDING the NUL.

A writer (`write_mcap`) produces minimal valid uncompressed MCAP from
frame streams — the synthetic-fixture source for the tests.
"""

from __future__ import annotations

import logging
import os
import struct
import zlib
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from . import rosbag

logger = logging.getLogger("pcs_torch.mcap")

MAGIC = b"\x89MCAP0\r\n"

_OP_HEADER = 0x01
_OP_FOOTER = 0x02
_OP_SCHEMA = 0x03
_OP_CHANNEL = 0x04
_OP_MESSAGE = 0x05
_OP_CHUNK = 0x06
_OP_DATA_END = 0x0F

CLOUD_TYPES = ("sensor_msgs/msg/PointCloud2", "sensor_msgs/PointCloud2")
POSE_TYPES = ("geometry_msgs/msg/PoseStamped", "geometry_msgs/PoseStamped",
              "nav_msgs/msg/Odometry", "nav_msgs/Odometry")


# ------------------------------------------------------------- container

def _read_str(buf: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    return buf[off:off + n].decode("utf-8", "replace"), off + n


def _decompress(blob: bytes, compression: str, size: int) -> bytes:
    if compression == "":
        return blob
    if compression == "zstd":
        try:
            import zstandard
        except ImportError as e:      # pragma: no cover - env-dependent
            raise IOError("mcap: zstd chunk but the zstandard module is "
                          "unavailable") from e
        try:
            return zstandard.ZstdDecompressor().decompress(
                blob, max_output_size=size)
        except Exception as e:        # ZstdError — corrupt payload
            raise IOError(f"mcap: corrupt zstd chunk ({e})") from e
    if compression == "lz4":
        try:
            import lz4.frame          # optional
        except ImportError as e:
            raise IOError("mcap: lz4 chunk but the lz4 module is "
                          "unavailable") from e
        try:
            return lz4.frame.decompress(blob)
        except Exception as e:
            raise IOError(f"mcap: corrupt lz4 chunk ({e})") from e
    raise IOError(f"mcap: unknown chunk compression {compression!r}")


def _records_in(blob: bytes) -> Iterator[Tuple[int, bytes]]:
    """Records nested in a chunk blob.  The blob length is exact (carried
    by the chunk record), so an overrun is corruption -> IOError."""
    off, n = 0, len(blob)
    while off + 9 <= n:
        op = blob[off]
        (clen,) = struct.unpack_from("<Q", blob, off + 1)
        off += 9
        if off + clen > n:
            raise IOError("mcap: corrupt chunk (nested record overruns "
                          "the chunk blob)")
        yield op, blob[off:off + clen]
        off += clen
    if off != n:
        raise IOError("mcap: corrupt chunk (trailing bytes after the last "
                      "nested record)")


def check_cdr(topic: str, encoding: str) -> None:
    """Only ``cdr``-encoded channels are decodable: `mcap convert
    flight.bag` keeps ROS1 serialization (message_encoding "ros1") under
    the SAME schema names this module accepts, and a ROS1 payload
    mis-parsed as CDR yields silently wrong stamps/points — so a non-cdr
    channel that is about to be DECODED is an error, not a guess.
    (Channels the caller filters out are never checked.)"""
    if encoding not in ("cdr", ""):
        raise IOError(
            f"mcap: channel {topic!r} is {encoding!r}-encoded; only 'cdr' "
            f"(rosbag2) is supported — a ros1-in-mcap capture must be "
            f"read from the original .bag (io/rosbag.py reads it directly)")


def read_messages(path: str, topics: Optional[Iterable[str]] = None,
                  ) -> Iterator[Tuple[str, str, float, bytes, str]]:
    """Linear scan: yields (topic, schema_name, log_time_seconds,
    raw_payload, message_encoding) in file order.  Indexes and the
    summary section are skipped; schemas/channels register as encountered
    (inside or outside chunks, as the spec allows).  Callers must
    check_cdr() before CDR-decoding a payload.

    Failure envelope (tests/test_bag_corruption.py): a file that ENDS
    mid-record (a recorder died mid-flight; rosbag2 also leaves no footer
    then) stops cleanly at the last complete record with a warning;
    structural corruption (a record too short for its own fixed fields, a
    nested record overrunning its chunk, an undecompressable chunk) raises
    a contextual IOError — never a bare struct.error/KeyError."""
    want = set(topics) if topics is not None else None
    schemas: Dict[int, str] = {}
    # channel id -> (topic, schema name, message_encoding)
    channels: Dict[int, Tuple[str, str, str]] = {}

    def handle(op: int, content: bytes):
        try:
            if op == _OP_SCHEMA:
                (sid,) = struct.unpack_from("<H", content, 0)
                name, _ = _read_str(content, 2)
                schemas[sid] = name
                return None
            if op == _OP_CHANNEL:
                sid_ch, sid_schema = struct.unpack_from("<HH", content, 0)
                topic, off = _read_str(content, 4)
                encoding, _ = _read_str(content, off)
                channels[sid_ch] = (topic, schemas.get(sid_schema, ""),
                                    encoding)
                return None
            if op == _OP_MESSAGE:
                (ch, _seq, log_t, _pub_t) = struct.unpack_from(
                    "<HIQQ", content, 0)
        except struct.error as e:
            raise IOError(f"mcap: corrupt record (opcode 0x{op:02x} too "
                          f"short for its fixed fields: {e})") from e
        if op == _OP_MESSAGE:
            if ch not in channels:
                raise IOError(f"mcap: message for unknown channel {ch}")
            topic, schema, encoding = channels[ch]
            if want is None or topic in want:
                return topic, schema, log_t * 1e-9, content[22:], encoding
        return None

    size = os.path.getsize(path)
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise IOError(f"{path}: not an MCAP file")
        # a spec-complete MCAP file ends with the magic again; remember
        # whether THIS file does, so an EOF-mid-record can be classified:
        # torn tail (no trailing magic — the recorder died) vs a corrupt
        # length field in a file that provably ran to completion
        if size >= 2 * len(MAGIC):
            f.seek(size - len(MAGIC))
            file_was_closed = f.read(len(MAGIC)) == MAGIC
        else:
            file_was_closed = False
        f.seek(len(MAGIC))

        def short_read(what):
            if file_was_closed:
                raise IOError(
                    f"{os.path.basename(path)}: {what}, but the file ends "
                    f"with the MCAP magic (a closed recording) — corrupt "
                    f"record length, not merely truncated")
            logger.warning(
                "%s: %s — truncated recording; stopping at the last "
                "complete record", os.path.basename(path), what)

        while True:
            head = f.read(9)
            if len(head) < 9:
                if head:
                    short_read("file ends mid-record header")
                return
            op = head[0]
            (clen,) = struct.unpack("<Q", head[1:9])
            content = f.read(clen)
            if len(content) < clen:
                short_read(f"file ends mid-record (opcode 0x{op:02x}, "
                           f"{len(content)} of {clen} bytes)")
                return
            if op == _OP_CHUNK:
                # u64 start, u64 end, u64 uncompressed_size, u32 crc,
                # string compression, u64 records_len, records
                try:
                    (_s, _e, usize, _crc) = struct.unpack_from(
                        "<QQQI", content, 0)
                    comp, off = _read_str(content, 28)
                    (rlen,) = struct.unpack_from("<Q", content, off)
                except struct.error as e:
                    raise IOError(f"mcap: corrupt chunk record header "
                                  f"({e})") from e
                if off + 8 + rlen > len(content):
                    raise IOError("mcap: corrupt chunk (records_len "
                                  "overruns the chunk record)")
                blob = _decompress(content[off + 8:off + 8 + rlen], comp,
                                   usize)
                # the chunk record carries its own integrity signals:
                # uncompressed_size always, uncompressed_crc when nonzero
                # — a flipped byte that still "decompresses" is caught here
                if comp and len(blob) != usize:
                    raise IOError(
                        f"mcap: corrupt chunk (decompressed to {len(blob)} "
                        f"bytes, header says {usize})")
                if _crc and zlib.crc32(blob) != _crc:
                    raise IOError("mcap: corrupt chunk (uncompressed CRC "
                                  "mismatch)")
                for sub_op, sub in _records_in(blob):
                    out = handle(sub_op, sub)
                    if out is not None:
                        yield out
            elif op in (_OP_FOOTER, _OP_DATA_END):
                # the summary section repeats schemas/channels + indexes;
                # the linear scan already has everything
                return
            else:
                out = handle(op, content)
                if out is not None:
                    yield out


# ------------------------------------------------------------------ CDR

class _Cdr:
    """Little-endian CDR reader.  Alignment is relative to the start of
    the serialized body (after the 4-byte encapsulation header), per the
    DDS XTypes rule rosbag2 writes with."""

    def __init__(self, payload: bytes):
        if len(payload) < 4:
            raise IOError("mcap: CDR payload shorter than its header")
        rep = payload[1]
        if rep not in (0x01, 0x03):   # CDR_LE / PL_CDR_LE
            raise IOError("mcap: big-endian CDR not supported")
        self.buf = payload[4:]
        self.off = 0

    def align(self, n: int) -> None:
        self.off += (-self.off) % n

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u16(self) -> int:
        self.align(2)
        (v,) = struct.unpack_from("<H", self.buf, self.off)
        self.off += 2
        return v

    def u32(self) -> int:
        self.align(4)
        (v,) = struct.unpack_from("<I", self.buf, self.off)
        self.off += 4
        return v

    def i32(self) -> int:
        self.align(4)
        (v,) = struct.unpack_from("<i", self.buf, self.off)
        self.off += 4
        return v

    def f64(self, count: int = 1):
        self.align(8)
        vals = struct.unpack_from(f"<{count}d", self.buf, self.off)
        self.off += 8 * count
        return vals if count > 1 else vals[0]

    def string(self) -> str:
        n = self.u32()                 # length INCLUDES the NUL terminator
        s = self.buf[self.off:self.off + max(n - 1, 0)]
        self.off += n
        return s.decode("utf-8", "replace")

    def bytes_seq(self) -> bytes:
        n = self.u32()
        b = self.buf[self.off:self.off + n]
        self.off += n
        return b

    def header_stamp(self) -> float:
        sec = self.i32()
        nanosec = self.u32()
        _frame_id = self.string()
        return sec + nanosec * 1e-9


def parse_pointcloud2_cdr(payload: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/msg/PointCloud2 (CDR) -> (header stamp, (N, 3) f32)."""
    c = _Cdr(payload)
    stamp = c.header_stamp()
    height, width = c.u32(), c.u32()
    nfields = c.u32()
    fields = []
    for _ in range(nfields):
        name = c.string()
        foff = c.u32()
        dtype = c.u8()
        count = c.u32()
        fields.append((name, foff, dtype, count))
    is_bigendian = c.u8()
    point_step = c.u32()
    row_step = c.u32()
    data = c.bytes_seq()
    # is_dense follows; NaNs are fine downstream
    pts = rosbag.xyz_from_pointcloud_fields(
        fields, is_bigendian, point_step, row_step, height, width, data,
        src="mcap")
    return stamp, pts


def parse_pose_cdr(payload: bytes, schema: str
                   ) -> Tuple[float, np.ndarray, np.ndarray]:
    """PoseStamped / Odometry (CDR) -> (stamp, position, quat WXYZ)."""
    c = _Cdr(payload)
    stamp = c.header_stamp()
    if "Odometry" in schema:
        _child = c.string()
    px, py, pz, qx, qy, qz, qw = c.f64(7)
    return stamp, np.array([px, py, pz]), np.array([qw, qx, qy, qz])


def read_bag_mcap(path: str, cloud_topic: Optional[str] = None,
                  pose_topic: Optional[str] = None,
                  ) -> Tuple[List[Tuple[float, np.ndarray]],
                             List[Tuple[float, np.ndarray, np.ndarray]]]:
    """(clouds, poses) from an MCAP file — same contract as
    io.rosbag.read_bag (which routes here on the MCAP magic), including
    the several-topics-match-the-type error (require_single_topic)."""
    clouds: Dict[str, List[Tuple[float, np.ndarray]]] = {}
    poses: Dict[str, List[Tuple[float, np.ndarray, np.ndarray]]] = {}
    for topic, schema, log_t, raw, encoding in read_messages(path):
        try:
            if schema in CLOUD_TYPES and cloud_topic in (None, topic):
                check_cdr(topic, encoding)
                stamp, pts = parse_pointcloud2_cdr(raw)
                clouds.setdefault(topic, []).append((stamp or log_t, pts))
            elif schema in POSE_TYPES and pose_topic in (None, topic):
                check_cdr(topic, encoding)
                stamp, pos, quat = parse_pose_cdr(raw, schema)
                poses.setdefault(topic, []).append((stamp or log_t,
                                                    pos, quat))
        except (struct.error, ValueError, IndexError) as e:
            # framing intact, payload not a decodable CDR message
            raise IOError(f"{os.path.basename(path)}: undecodable {schema} "
                          f"on {topic!r} at t={log_t:.3f}: {e}") from e
    return (rosbag.require_single_topic(clouds, "PointCloud2", path,
                                        "cloud_topic= (--cloud-topic)",
                                        requested=cloud_topic),
            rosbag.require_single_topic(poses, "pose", path,
                                        "pose_topic= (--pose-topic)",
                                        requested=pose_topic))


# ---------------------------------------------------------------- writer

class _CdrW:
    def __init__(self):
        self.parts = [b"\x00\x01\x00\x00"]   # CDR_LE encapsulation
        self.off = 0

    def align(self, n: int) -> None:
        pad = (-self.off) % n
        if pad:
            self.parts.append(b"\x00" * pad)
            self.off += pad

    def u8(self, v: int) -> None:
        self.parts.append(struct.pack("<B", v))
        self.off += 1

    def u32(self, v: int) -> None:
        self.align(4)
        self.parts.append(struct.pack("<I", v))
        self.off += 4

    def i32(self, v: int) -> None:
        self.align(4)
        self.parts.append(struct.pack("<i", v))
        self.off += 4

    def f64(self, *vals: float) -> None:
        self.align(8)
        self.parts.append(struct.pack(f"<{len(vals)}d", *vals))
        self.off += 8 * len(vals)

    def string(self, s: str) -> None:
        b = s.encode() + b"\x00"
        self.u32(len(b))
        self.parts.append(b)
        self.off += len(b)

    def bytes_seq(self, b: bytes) -> None:
        self.u32(len(b))
        self.parts.append(b)
        self.off += len(b)

    def header(self, t: float, frame_id: str) -> None:
        sec = int(t)
        self.i32(sec)
        self.u32(int(round((t - sec) * 1e9)))
        self.string(frame_id)

    def payload(self) -> bytes:
        return b"".join(self.parts)


def _cdr_pointcloud2(t: float, pts: np.ndarray) -> bytes:
    pts = np.ascontiguousarray(pts, np.float32).reshape(-1, 3)
    w = _CdrW()
    w.header(t, "drone")
    w.u32(1)                  # height
    w.u32(len(pts))           # width
    w.u32(3)                  # fields
    for i, name in enumerate(("x", "y", "z")):
        w.string(name)
        w.u32(4 * i)
        w.u8(7)               # FLOAT32
        w.u32(1)
    w.u8(0)                   # little-endian
    w.u32(12)                 # point_step
    w.u32(12 * len(pts))      # row_step
    w.bytes_seq(pts.tobytes())
    w.u8(0)                   # is_dense
    return w.payload()


def _cdr_posestamped(t: float, pos, quat_wxyz) -> bytes:
    w = _CdrW()
    w.header(t, "world")
    qw, qx, qy, qz = (float(v) for v in quat_wxyz)
    w.f64(*(float(v) for v in pos), qx, qy, qz, qw)
    return w.payload()


def _rec(op: int, content: bytes) -> bytes:
    return struct.pack("<BQ", op, len(content)) + content


def _mstr(s: str) -> bytes:
    b = s.encode()
    return struct.pack("<I", len(b)) + b


def write_mcap(path: str,
               clouds: Iterable[Tuple[float, np.ndarray]],
               poses: Iterable[Tuple[float, np.ndarray, np.ndarray]],
               cloud_topic: str = "/tof_pc",
               pose_topic: str = "/mavros/local_position/pose") -> int:
    """Minimal valid uncompressed MCAP (schemas + channels + messages in
    the data section, proper footer) — the test-fixture source and the
    ROS2 interop path out."""
    msgs = []
    for t, pts in clouds:
        msgs.append((float(t), 1, _cdr_pointcloud2(t, pts)))
    for t, pos, quat in poses:
        msgs.append((float(t), 2, _cdr_posestamped(t, pos, quat)))
    msgs.sort(key=lambda m: m[0])

    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(_rec(_OP_HEADER, _mstr("ros2") + _mstr("pcs-torch")))
        f.write(_rec(_OP_SCHEMA, struct.pack("<H", 1)
                     + _mstr("sensor_msgs/msg/PointCloud2")
                     + _mstr("ros2msg") + struct.pack("<I", 0)))
        f.write(_rec(_OP_SCHEMA, struct.pack("<H", 2)
                     + _mstr("geometry_msgs/msg/PoseStamped")
                     + _mstr("ros2msg") + struct.pack("<I", 0)))
        for ch, (topic, sid) in ((1, (cloud_topic, 1)),
                                 (2, (pose_topic, 2))):
            f.write(_rec(_OP_CHANNEL, struct.pack("<HH", ch, sid)
                         + _mstr(topic) + _mstr("cdr")
                         + struct.pack("<I", 0)))   # empty metadata map
        for seq, (t, ch, payload) in enumerate(msgs):
            ns = int(round(t * 1e9))
            f.write(_rec(_OP_MESSAGE,
                         struct.pack("<HIQQ", ch, seq, ns, ns) + payload))
        f.write(_rec(_OP_DATA_END, struct.pack("<I", 0)))
        f.write(_rec(_OP_FOOTER, struct.pack("<QQI", 0, 0, 0)))
        f.write(MAGIC)
    return len(msgs)


def frames_to_mcap(path: str, frames, **kw) -> int:
    frames = list(frames)
    return write_mcap(path,
                      [(fr.t, fr.points) for fr in frames],
                      [(fr.t, fr.position, fr.quat_wxyz) for fr in frames],
                      **kw)
