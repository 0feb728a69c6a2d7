"""Offline ROS1 bag (v2.0) ingestion — the reference's real recorded-data
format, without a ROS installation.  The port's own copy of the JAX package's
io/rosbag.py (same code, tests/test_torch_isolation.py), wired to the port's
Frame and PoseBuffer.

The reference's deployment surface is live ROS topics: the node subscribes
``/tof_pc`` (`sensor_msgs/PointCloud2`) and looks the drone pose up via TF
(`pointcloud_segmentation_node.cpp:64-67`,
`launch/all.launch:26-51`); flights are recorded with ``rosbag record``.
This module reads those bags directly — a pure-Python linear-scan parser
of the rosbag v2.0 container (chunks, none/bz2/lz4 compression) plus ROS1
message deserializers for `sensor_msgs/PointCloud2`,
`geometry_msgs/PoseStamped` and `nav_msgs/Odometry` — and associates each
cloud with an interpolated pose through the same TF2-analog PoseBuffer the
live runtime uses (slerp, 1 s timeout, runtime/posebuffer.py), yielding
`io.simulator.Frame`s the engine replays like any recorded log.

A writer (`write_bag`) produces valid, indexed, chunked v2.0 bags from
frame streams — the synthetic-fixture source for the tests and the
interop path back out to ROS tooling.

Format notes (the rosbag 2.0 on-disk container):
  * file magic ``#ROSBAG V2.0\\n``; then a sequence of records, each
    ``u32 header_len | header | u32 data_len | data`` with the header a
    list of ``u32 field_len | name=value`` fields;
  * record types by the ``op`` field: 0x03 bag header (index_pos,
    padded to 4 KiB), 0x05 chunk (compression + uncompressed size; data =
    nested connection/message records), 0x07 connection (topic + type
    metadata), 0x02 message data (conn id + time), 0x04/0x06 index
    records (skipped — the reader is a linear scan, so unindexed/
    "needs-reindex" bags read fine).
"""

from __future__ import annotations

import bz2
import logging
import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from .simulator import Frame

logger = logging.getLogger("pcs_torch.rosbag")

_MAGIC = b"#ROSBAG V2.0\n"

_OP_MSG_DATA = 0x02
_OP_BAG_HEADER = 0x03
_OP_INDEX_DATA = 0x04
_OP_CHUNK = 0x05
_OP_CHUNK_INFO = 0x06
_OP_CONNECTION = 0x07

# sensor_msgs/PointField datatype codes -> numpy dtypes (little-endian)
_PF_DTYPES = {1: "<i1", 2: "<u1", 3: "<i2", 4: "<u2",
              5: "<i4", 6: "<u4", 7: "<f4", 8: "<f8"}

CLOUD_TYPE = "sensor_msgs/PointCloud2"
POSE_TYPES = ("geometry_msgs/PoseStamped", "nav_msgs/Odometry")


# --------------------------------------------------------------- low level

class TruncatedBag(Exception):
    """The file ends in the middle of a record — the tail a recorder that
    died mid-flight leaves behind.  Internal: readers catch it, warn, and
    stop cleanly at the last complete record (never surfaced to callers,
    unlike corruption, which raises IOError)."""


def _parse_fields(header: bytes) -> Dict[str, bytes]:
    fields: Dict[str, bytes] = {}
    off = 0
    n = len(header)
    while off + 4 <= n:
        (flen,) = struct.unpack_from("<I", header, off)
        off += 4
        if off + flen > n:
            raise IOError("rosbag: corrupt record header (field overruns "
                          "the header block)")
        fld = header[off:off + flen]
        off += flen
        eq = fld.find(b"=")
        if eq < 0:
            raise IOError("rosbag: malformed header field (no '=')")
        fields[fld[:eq].decode("ascii", "replace")] = fld[eq + 1:]
    return fields


def _op(fields: Dict[str, bytes]) -> int:
    v = fields.get("op")
    if not v:
        raise IOError("rosbag: record missing the 'op' header field "
                      "(corrupt bag?)")
    return v[0]


def _read_exact(f, n: int, what: str) -> bytes:
    b = f.read(n)
    if len(b) < n:
        raise TruncatedBag(what)
    return b


def _read_record(f) -> Optional[Tuple[Dict[str, bytes], bytes]]:
    """One top-level record; None at a clean EOF (record boundary),
    TruncatedBag if the file ends mid-record."""
    head = f.read(4)
    if not head:
        return None
    if len(head) < 4:
        raise TruncatedBag("record header length")
    (hlen,) = struct.unpack("<I", head)
    fields = _parse_fields(_read_exact(f, hlen, "record header"))
    (dlen,) = struct.unpack("<I", _read_exact(f, 4, "record data length"))
    return fields, _read_exact(f, dlen, "record data")


def _records_in(blob: bytes) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    """Records nested inside an (uncompressed) chunk blob.  The blob's
    length is exact (the chunk record carried it), so a nested record
    overrunning it is CORRUPTION, not truncation -> IOError."""
    off, n = 0, len(blob)
    while off + 4 <= n:
        (hlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + hlen + 4 > n:
            raise IOError("rosbag: corrupt chunk (nested record header "
                          "overruns the chunk blob)")
        fields = _parse_fields(blob[off:off + hlen])
        off += hlen
        (dlen,) = struct.unpack_from("<I", blob, off)
        off += 4
        if off + dlen > n:
            raise IOError("rosbag: corrupt chunk (nested record data "
                          "overruns the chunk blob)")
        yield fields, blob[off:off + dlen]
        off += dlen
    if off != n:
        raise IOError("rosbag: corrupt chunk (trailing bytes after the "
                      "last nested record)")


def _decompress(data: bytes, compression: bytes, size: int) -> bytes:
    if compression in (b"none", b""):
        return data
    if compression == b"bz2":
        try:
            return bz2.decompress(data)
        except (OSError, ValueError, EOFError) as e:
            raise IOError(f"rosbag: corrupt bz2 chunk ({e})") from e
    if compression == b"lz4":
        try:
            import lz4.frame  # optional
        except ImportError as e:
            raise IOError("rosbag: lz4-compressed chunk but the lz4 module "
                          "is unavailable; re-record with --bz2 or none") \
                from e
        try:
            return lz4.frame.decompress(data)
        except Exception as e:
            raise IOError(f"rosbag: corrupt lz4 chunk ({e})") from e
    raise IOError(f"rosbag: unknown chunk compression {compression!r}")


def _u32(fields: Dict[str, bytes], name: str) -> int:
    try:
        return struct.unpack("<I", fields[name])[0]
    except (KeyError, struct.error) as e:
        raise IOError(f"rosbag: record missing/malformed u32 header "
                      f"field {name!r} (corrupt bag?)") from e


def _time(fields: Dict[str, bytes], name: str) -> float:
    try:
        secs, nsecs = struct.unpack("<II", fields[name])
    except (KeyError, struct.error) as e:
        raise IOError(f"rosbag: record missing/malformed time header "
                      f"field {name!r} (corrupt bag?)") from e
    return secs + nsecs * 1e-9


def read_messages(path: str, topics: Optional[Iterable[str]] = None,
                  ) -> Iterator[Tuple[str, str, float, bytes]]:
    """Linear scan of a ROS1 v2.0 bag: yields (topic, msg_type, record_time,
    raw_serialized_message) in file order.  ``topics`` filters by topic
    name; None yields everything.  Index records are skipped, so bags with
    index_pos=0 ("needs reindex", e.g. an interrupted recording) read fine.

    Failure envelope (tests/test_bag_corruption.py): a file that ENDS
    mid-record — the tail a recorder dying mid-flight leaves — stops
    cleanly at the last complete record with a warning; structural
    corruption (malformed header fields, a nested record overrunning its
    chunk, an undecompressable bz2 chunk) raises a contextual IOError —
    never a bare struct.error/KeyError.
    """
    want = set(topics) if topics is not None else None
    conns: Dict[int, Tuple[str, str]] = {}

    def handle(fields, data):
        op = _op(fields)
        if op == _OP_CONNECTION:
            conn = _u32(fields, "conn")
            meta = _parse_fields(data)
            # "replace", not strict: a flipped byte in a topic/type string
            # must not escape as a bare UnicodeDecodeError (the envelope
            # the corruption tests pin)
            conns[conn] = (meta.get("topic", fields.get("topic", b"")
                                    ).decode("utf-8", "replace"),
                           meta.get("type", b"").decode("utf-8", "replace"))
            return None
        if op == _OP_MSG_DATA:
            conn = _u32(fields, "conn")
            if conn not in conns:
                raise IOError(f"rosbag: message for unknown connection {conn}")
            topic, mtype = conns[conn]
            if want is None or topic in want:
                return topic, mtype, _time(fields, "time"), data
        return None

    closed_index_pos = 0    # nonzero once the bag header says "closed"
    with open(path, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            raise IOError(f"{path}: not a ROS1 v2.0 bag "
                          f"(v1.2 and ROS2/mcap are not supported)")
        while True:
            try:
                rec = _read_record(f)
            except TruncatedBag as e:
                if closed_index_pos:
                    # the bag header records a nonzero index_pos, so the
                    # recorder CLOSED this bag — the file provably did not
                    # end here.  A mid-file EOF is then a corrupt length
                    # field (or a storage-level cut of a finished file),
                    # not a torn tail: silently dropping the remainder
                    # would be the silently-sparse-map outcome.
                    raise IOError(
                        f"{os.path.basename(path)}: file ends mid-record "
                        f"({e}) but the bag header records index_pos="
                        f"{closed_index_pos} (a closed recording) — "
                        f"corrupt, not merely truncated") from None
                logger.warning(
                    "%s: file ends mid-record (%s) — truncated recording; "
                    "stopping at the last complete record",
                    os.path.basename(path), e)
                return
            if rec is None:
                return
            fields, data = rec
            op = _op(fields)
            if op == _OP_BAG_HEADER and "index_pos" in fields:
                try:
                    (closed_index_pos,) = struct.unpack(
                        "<Q", fields["index_pos"])
                except struct.error:
                    closed_index_pos = 0
            if op == _OP_CHUNK:
                blob = _decompress(data, fields.get("compression", b"none"),
                                   _u32(fields, "size"))
                for sub_fields, sub_data in _records_in(blob):
                    out = handle(sub_fields, sub_data)
                    if out is not None:
                        yield out
            elif op in (_OP_BAG_HEADER, _OP_INDEX_DATA, _OP_CHUNK_INFO):
                continue
            else:
                out = handle(fields, data)
                if out is not None:
                    yield out


# ------------------------------------------------- message deserialization

def _read_string(data: bytes, off: int) -> Tuple[str, int]:
    (n,) = struct.unpack_from("<I", data, off)
    off += 4
    return data[off:off + n].decode("utf-8", "replace"), off + n


def _read_header(data: bytes, off: int) -> Tuple[float, int]:
    """std_msgs/Header: seq u32, stamp (secs u32, nsecs u32), frame_id."""
    _seq, secs, nsecs = struct.unpack_from("<III", data, off)
    _frame_id, off = _read_string(data, off + 12)
    return secs + nsecs * 1e-9, off


def xyz_from_pointcloud_fields(fields, is_bigendian: int, point_step: int,
                               row_step: int, height: int, width: int,
                               data: bytes, src: str = "rosbag",
                               ) -> np.ndarray:
    """Common tail of the PointCloud2 decode, shared by the ROS1 (this
    module) and CDR (io/mcap.py) parsers: pick the x/y/z fields out of an
    arbitrary field layout -> (N, 3) float32.  Handles arbitrary field
    offsets/dtypes, organized clouds (height > 1), and row padding
    (row_step > width * point_step); extra fields (intensity, rgb, ...)
    are ignored.  Big-endian clouds are rejected (none of the supported
    sensors produce them).  ``fields`` is [(name, offset, datatype_code,
    count)]."""
    if is_bigendian:
        raise IOError(f"{src}: big-endian PointCloud2 not supported")
    by_name = {name: (foffset, dtype) for name, foffset, dtype, _ in fields}
    missing = [k for k in ("x", "y", "z") if k not in by_name]
    if missing:
        raise IOError(f"{src}: PointCloud2 lacks {missing} fields")
    offs = [by_name[k][0] for k in ("x", "y", "z")]
    fmts = []
    for k in ("x", "y", "z"):
        code = by_name[k][1]
        if code not in _PF_DTYPES:
            raise IOError(f"{src}: unsupported PointField datatype {code}")
        fmts.append(_PF_DTYPES[code])
    rec_dt = np.dtype({"names": ["x", "y", "z"], "formats": fmts,
                       "offsets": offs, "itemsize": point_step})
    if height > 1 and row_step != width * point_step:
        # row-padded organized cloud: strip the padding row by row
        rows = [data[r * row_step: r * row_step + width * point_step]
                for r in range(height)]
        data = b"".join(rows)
    n = height * width
    rec = np.frombuffer(data, dtype=rec_dt, count=n)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0] = rec["x"]
    pts[:, 1] = rec["y"]
    pts[:, 2] = rec["z"]
    return pts


def parse_pointcloud2(data: bytes) -> Tuple[float, np.ndarray]:
    """Deserialize sensor_msgs/PointCloud2 -> (header stamp, (N, 3) xyz
    float32) via xyz_from_pointcloud_fields."""
    stamp, off = _read_header(data, 0)
    height, width, nfields = struct.unpack_from("<III", data, off)
    off += 12
    fields = []
    for _ in range(nfields):
        name, off = _read_string(data, off)
        foffset, dtype, count = struct.unpack_from("<IBI", data, off)
        off += 9
        fields.append((name, foffset, dtype, count))
    is_bigendian, point_step, row_step = struct.unpack_from("<BII", data, off)
    off += 9
    (dlen,) = struct.unpack_from("<I", data, off)
    off += 4
    cloud = data[off:off + dlen]
    # is_dense (1 byte) follows; NaN points are handled by preproc anyway
    pts = xyz_from_pointcloud_fields(fields, is_bigendian, point_step,
                                     row_step, height, width, cloud)
    return stamp, pts


def parse_pose(data: bytes, msg_type: str
               ) -> Tuple[float, np.ndarray, np.ndarray]:
    """Deserialize a pose message -> (header stamp, position, quat WXYZ).

    geometry_msgs/PoseStamped: header + Pose.  nav_msgs/Odometry: header +
    child_frame_id + PoseWithCovariance (covariance + twist ignored).
    ROS quaternions are (x, y, z, w) on the wire; the pipeline convention
    is (w, x, y, z) (geometry.quat_to_rot)."""
    stamp, off = _read_header(data, 0)
    if msg_type == "nav_msgs/Odometry":
        _child, off = _read_string(data, off)
    px, py, pz, qx, qy, qz, qw = struct.unpack_from("<7d", data, off)
    return (stamp, np.array([px, py, pz]),
            np.array([qw, qx, qy, qz]))


# ----------------------------------------------------------- high level

def require_single_topic(by_topic: Dict[str, list], kind: str, path: str,
                         flag: str, requested: Optional[str] = None) -> list:
    """Shared (ROS1 + MCAP) ambiguity guard: a bag recorded with
    ``rosbag record -a`` while the reference node ran carries /tof_pc PLUS
    the node's own republished PointCloud2 topics (filtered_pointcloud,
    hough_pointcloud — node.cpp:417-420/823-841), and mavros publishes
    pose on several topics.  Silently merging them would feed
    already-filtered clouds back in as raw frames and interleave pose
    sources — a silently wrong world map — so more than one matching
    topic is an error naming the candidates.  The mirror hole is guarded
    too: an EXPLICITLY ``requested`` topic that matched nothing (typo, or
    a topic of a different message type) is an error, not a silent empty
    run producing an empty-but-exit-0 segments.csv."""
    if len(by_topic) > 1:
        raise IOError(
            f"{os.path.basename(path)}: {len(by_topic)} topics carry "
            f"{kind} messages ({sorted(by_topic)}); merging them would be "
            f"silently wrong — pick one with {flag}")
    if requested is not None and requested not in by_topic:
        raise IOError(
            f"{os.path.basename(path)}: requested topic {requested!r} "
            f"({flag}) carries no {kind} messages in this bag — check the "
            f"name and type with `pcs-torch bag-info`")
    return next(iter(by_topic.values()), [])


def bag_info(path: str) -> Dict[str, object]:
    """Per-topic summary of a recorded bag (ROS1 v2.0 or MCAP, dispatched
    on the file magic) — the `rosbag info` analog backing `pcs-torch
    bag-info`, and the companion to require_single_topic's "pick one"
    error: it shows what there is to pick.  Returns {"format", "topics":
    {topic: {"type", "count", "t_min", "t_max"[, "encoding"]}}} with
    times from the record/log clock (not header stamps — no payload
    decode, so this scans fast and works on unknown types too)."""
    from . import mcap

    with open(path, "rb") as f:
        is_mcap = f.read(len(mcap.MAGIC)) == mcap.MAGIC
    topics: Dict[str, Dict[str, object]] = {}

    def tally(topic, mtype, t, encoding=None):
        d = topics.setdefault(topic, {
            "type": mtype, "count": 0, "t_min": t, "t_max": t})
        d["count"] += 1
        d["t_min"] = min(d["t_min"], t)
        d["t_max"] = max(d["t_max"], t)
        if encoding is not None:
            d["encoding"] = encoding

    if is_mcap:
        for topic, schema, t, _raw, enc in mcap.read_messages(path):
            tally(topic, schema, t, enc)
    else:
        for topic, mtype, t, _raw in read_messages(path):
            tally(topic, mtype, t)
    return {"format": "mcap" if is_mcap else "rosbag", "topics": topics}


def read_bag(path: str, cloud_topic: Optional[str] = None,
             pose_topic: Optional[str] = None,
             ) -> Tuple[List[Tuple[float, np.ndarray]],
                        List[Tuple[float, np.ndarray, np.ndarray]]]:
    """Extract (clouds, poses) from a recorded bag — ROS1 v2.0 or MCAP
    (ROS2), dispatched on the file magic.

    clouds: [(t, (N, 3) float32 xyz)];  poses: [(t, position, quat_wxyz)].
    Each topic defaults to THE topic of the matching type (`/tof_pc` and
    the mocap/mavros pose in the reference's recordings); if several
    topics match — e.g. a ``rosbag record -a`` capture that also holds the
    node's republished clouds — the read errors and names them rather
    than silently merging (see require_single_topic).  Timestamps are the
    message header stamps (the value TF association uses), falling back to
    the bag record time when a producer left the stamp zero."""
    from . import mcap

    with open(path, "rb") as f:
        head = f.read(len(mcap.MAGIC))
    if head == mcap.MAGIC:
        return mcap.read_bag_mcap(path, cloud_topic, pose_topic)
    clouds: Dict[str, List[Tuple[float, np.ndarray]]] = {}
    poses: Dict[str, List[Tuple[float, np.ndarray, np.ndarray]]] = {}
    for topic, mtype, rec_t, raw in read_messages(path):
        try:
            if mtype == CLOUD_TYPE and cloud_topic in (None, topic):
                stamp, pts = parse_pointcloud2(raw)
                clouds.setdefault(topic, []).append((stamp or rec_t, pts))
            elif mtype in POSE_TYPES and pose_topic in (None, topic):
                stamp, pos, quat = parse_pose(raw, mtype)
                poses.setdefault(topic, []).append((stamp or rec_t,
                                                    pos, quat))
        except (struct.error, ValueError, IndexError) as e:
            # the record framing was intact but the payload is not a
            # decodable message — corruption, reported with context
            raise IOError(f"{os.path.basename(path)}: undecodable {mtype} "
                          f"on {topic!r} at t={rec_t:.3f}: {e}") from e
    return (require_single_topic(clouds, "PointCloud2", path,
                                 "cloud_topic= (--cloud-topic)",
                                 requested=cloud_topic),
            require_single_topic(poses, "pose", path,
                                 "pose_topic= (--pose-topic)",
                                 requested=pose_topic))


def bag_to_frames(path: str, cloud_topic: Optional[str] = None,
                  pose_topic: Optional[str] = None) -> List[Frame]:
    """Bag (ROS1 .bag or ROS2 .mcap) -> engine-replayable Frames: every
    cloud is paired with the pose interpolated at its timestamp through
    the SAME TF2-analog buffer the live runtime uses (slerp + 1 s timeout,
    runtime/posebuffer.py — node.cpp:357-376 semantics).  Clouds with no
    pose in range are skipped with a warning (D-POSE: skip, not die)."""
    from ..runtime.posebuffer import PoseBuffer

    clouds, poses = read_bag(path, cloud_topic, pose_topic)
    buf = PoseBuffer(capacity=max(len(poses), 16))
    for t, pos, quat in poses:
        buf.push(t, pos, quat)
    frames: List[Frame] = []
    skipped = 0
    for t, pts in sorted(clouds, key=lambda c: c[0]):
        pose = buf.lookup(t)
        if pose is None:
            skipped += 1
            continue
        position, quat = pose
        frames.append(Frame(t=t, position=position, quat_wxyz=quat,
                            points=pts))
    if skipped:
        logger.warning("bag %s: %d/%d clouds had no pose within the TF "
                       "timeout and were skipped (D-POSE)",
                       os.path.basename(path), skipped, len(clouds))
    return frames


# ----------------------------------------------------------------- writer

_POINTCLOUD2_MD5 = b"1158d486dd51d683ce2f1be655c3c181"
_POSESTAMPED_MD5 = b"d3812c3cbc69362b77dc0b19b345f8f5"

_POINTCLOUD2_DEF = b"""# sensor_msgs/PointCloud2
std_msgs/Header header
uint32 height
uint32 width
sensor_msgs/PointField[] fields
bool is_bigendian
uint32 point_step
uint32 row_step
uint8[] data
bool is_dense
"""
_POSESTAMPED_DEF = b"""# geometry_msgs/PoseStamped
std_msgs/Header header
geometry_msgs/Pose pose
"""


def _field(name: str, value: bytes) -> bytes:
    fld = name.encode("ascii") + b"=" + value
    return struct.pack("<I", len(fld)) + fld


def _record(fields: bytes, data: bytes) -> bytes:
    return (struct.pack("<I", len(fields)) + fields
            + struct.pack("<I", len(data)) + data)


def _enc_time(t: float) -> bytes:
    secs = int(t)
    nsecs = int(round((t - secs) * 1e9))
    if nsecs >= 10 ** 9:
        secs, nsecs = secs + 1, nsecs - 10 ** 9
    return struct.pack("<II", secs, nsecs)


def _ser_string(s: bytes) -> bytes:
    return struct.pack("<I", len(s)) + s


def _ser_header(t: float, frame_id: bytes, seq: int) -> bytes:
    return (struct.pack("<I", seq) + _enc_time(t) + _ser_string(frame_id))


def _ser_pointcloud2(t: float, pts: np.ndarray, seq: int) -> bytes:
    pts = np.ascontiguousarray(pts, np.float32).reshape(-1, 3)
    n = len(pts)
    out = [_ser_header(t, b"drone", seq),
           struct.pack("<II", 1, n),          # height=1, width=n
           struct.pack("<I", 3)]              # 3 PointFields
    for i, name in enumerate((b"x", b"y", b"z")):
        out.append(_ser_string(name)
                   + struct.pack("<IBI", 4 * i, 7, 1))   # FLOAT32, count 1
    body = pts.tobytes()
    out.append(struct.pack("<BII", 0, 12, 12 * n))  # LE, point/row step
    out.append(_ser_string(body))
    out.append(struct.pack("<B", 0))                # is_dense=false (NaNs ok)
    return b"".join(out)


def _ser_posestamped(t: float, pos, quat_wxyz, seq: int) -> bytes:
    w, x, y, z = (float(v) for v in quat_wxyz)
    px, py, pz = (float(v) for v in pos)
    return (_ser_header(t, b"world", seq)
            + struct.pack("<7d", px, py, pz, x, y, z, w))


def write_bag(path: str,
              clouds: Iterable[Tuple[float, np.ndarray]],
              poses: Iterable[Tuple[float, np.ndarray, np.ndarray]],
              cloud_topic: str = "/tof_pc",
              pose_topic: str = "/mavros/local_position/pose",
              compression: str = "none") -> int:
    """Write a valid, indexed, single-chunk ROS1 v2.0 bag (PointCloud2 on
    ``cloud_topic``, PoseStamped on ``pose_topic``, messages interleaved in
    time order).  The synthetic-fixture source for the reader tests and
    the interop path back to ROS tooling (`rosbag info/play` readable).
    Returns the message count."""
    if compression not in ("none", "bz2"):
        raise ValueError(f"write_bag: unsupported compression {compression!r}")
    msgs = []   # (t, conn, serialized)
    for seq, (t, pts) in enumerate(clouds):
        msgs.append((float(t), 0, _ser_pointcloud2(t, pts, seq)))
    for seq, (t, pos, quat) in enumerate(poses):
        msgs.append((float(t), 1, _ser_posestamped(t, pos, quat, seq)))
    msgs.sort(key=lambda m: m[0])

    conn_meta = []
    for conn, (topic, mtype, md5, mdef) in enumerate((
            (cloud_topic, b"sensor_msgs/PointCloud2", _POINTCLOUD2_MD5,
             _POINTCLOUD2_DEF),
            (pose_topic, b"geometry_msgs/PoseStamped", _POSESTAMPED_MD5,
             _POSESTAMPED_DEF))):
        header = (_field("op", bytes([_OP_CONNECTION]))
                  + _field("conn", struct.pack("<I", conn))
                  + _field("topic", topic.encode()))
        data = (_field("topic", topic.encode()) + _field("type", mtype)
                + _field("md5sum", md5)
                + _field("message_definition", mdef))
        conn_meta.append(_record(header, data))

    # chunk payload: connections first, then message records; remember each
    # message's offset into the UNCOMPRESSED blob for the index
    blob_parts = list(conn_meta)
    blob_off = sum(len(p) for p in blob_parts)
    index: Dict[int, List[Tuple[float, int]]] = {0: [], 1: []}
    for t, conn, ser in msgs:
        rec = _record(_field("op", bytes([_OP_MSG_DATA]))
                      + _field("conn", struct.pack("<I", conn))
                      + _field("time", _enc_time(t)), ser)
        index[conn].append((t, blob_off))
        blob_parts.append(rec)
        blob_off += len(rec)
    blob = b"".join(blob_parts)
    payload = bz2.compress(blob) if compression == "bz2" else blob

    t0 = msgs[0][0] if msgs else 0.0
    t1 = msgs[-1][0] if msgs else 0.0
    with open(path, "wb") as f:
        f.write(_MAGIC)
        bag_header_pos = f.tell()
        # placeholder bag header (rewritten with the real index_pos below);
        # the record is padded with ASCII spaces to a fixed 4096 bytes so
        # the rewrite is in-place
        def bag_header(index_pos: int) -> bytes:
            hdr = (_field("op", bytes([_OP_BAG_HEADER]))
                   + _field("index_pos", struct.pack("<Q", index_pos))
                   + _field("conn_count", struct.pack("<I", 2))
                   + _field("chunk_count", struct.pack("<I", 1)))
            pad = 4096 - 8 - len(hdr)
            return _record(hdr, b" " * pad)

        f.write(bag_header(0))
        chunk_pos = f.tell()
        f.write(_record(_field("op", bytes([_OP_CHUNK]))
                        + _field("compression", compression.encode())
                        + _field("size", struct.pack("<I", len(blob))),
                        payload))
        # per-connection INDEX_DATA (inside the file, right after the chunk)
        for conn in (0, 1):
            entries = index[conn]
            data = b"".join(_enc_time(t) + struct.pack("<I", off)
                            for t, off in entries)
            f.write(_record(_field("op", bytes([_OP_INDEX_DATA]))
                            + _field("ver", struct.pack("<I", 1))
                            + _field("conn", struct.pack("<I", conn))
                            + _field("count",
                                     struct.pack("<I", len(entries))),
                            data))
        index_pos = f.tell()
        for rec in conn_meta:
            f.write(rec)
        info_data = b"".join(struct.pack("<II", conn, len(index[conn]))
                             for conn in (0, 1))
        f.write(_record(_field("op", bytes([_OP_CHUNK_INFO]))
                        + _field("ver", struct.pack("<I", 1))
                        + _field("chunk_pos", struct.pack("<Q", chunk_pos))
                        + _field("start_time", _enc_time(t0))
                        + _field("end_time", _enc_time(t1))
                        + _field("count", struct.pack("<I", 2)),
                        info_data))
        f.seek(bag_header_pos)
        f.write(bag_header(index_pos))
    return len(msgs)


def frames_to_bag(path: str, frames: Iterable[Frame], **kw) -> int:
    """Convenience: a Frame stream (simulator/replay) -> bag, pose per
    frame timestamp."""
    frames = list(frames)
    return write_bag(path,
                     [(fr.t, fr.points) for fr in frames],
                     [(fr.t, fr.position, fr.quat_wxyz) for fr in frames],
                     **kw)
