"""The port's recorded-data readers and writers (io/rosbag.py, io/mcap.py)
against the JAX package's: a file written by either package is read by the
other bit for bit, in every container and compression installed; bag_info and
bag_to_frames agree; and every broken or ambiguous input gives the same
exception type and message (or the same prefix of messages) from both."""

import bz2
import logging
import struct
import types

import numpy as np
import pytest

from pointcloud_segmentation_tpu.io import mcap as JM
from pointcloud_segmentation_tpu.io import rosbag as JR

from pointcloud_segmentation_tpu_torch.io import mcap as TM
from pointcloud_segmentation_tpu_torch.io import rosbag as TR
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory

JAX = types.SimpleNamespace(name="jax", rosbag=JR, mcap=JM)
PORT = types.SimpleNamespace(name="torch", rosbag=TR, mcap=TM)
PACKAGES = {"jax": JAX, "torch": PORT}


def _has(module):
    try:
        __import__(module)
        return True
    except ImportError:
        return False


# container -> how `pkg` writes `frames` to `path`; returns the message count
CONTAINERS = {
    "bag-none": lambda pkg, path, frames: pkg.rosbag.frames_to_bag(path, frames),
    "bag-bz2": lambda pkg, path, frames: pkg.rosbag.frames_to_bag(
        path, frames, compression="bz2"),
    "mcap-none": lambda pkg, path, frames: pkg.mcap.frames_to_mcap(path, frames),
    "mcap-chunked": lambda pkg, path, frames: _chunked_mcap(pkg, path, frames, ""),
}
if _has("zstandard"):
    CONTAINERS["mcap-zstd"] = lambda pkg, path, frames: _chunked_mcap(pkg, path, frames, "zstd")


@pytest.fixture(scope="module")
def frames():
    """6 seeded simulator frames with times that do not sit on the
    nanosecond grid (secs/nsecs splitting then rounds them)."""
    poses = trajectory_poses(WP_TESTS, hz=3.0, velocity=0.4)[:6]
    return simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)


def _chunked_mcap(pkg, path, frames, compression):
    """rosbag2's default layout: the plain file's message records rewrapped
    into one CHUNK record ("" or zstd), with the chunk's CRC set."""
    import zlib

    M = pkg.mcap
    plain = path + ".plain"
    n = M.frames_to_mcap(plain, frames)
    keep, blob = [], b""
    src = open(plain, "rb").read()
    off = len(M.MAGIC)
    while off + 9 <= len(src):
        op = src[off]
        (clen,) = struct.unpack_from("<Q", src, off + 1)
        content = src[off + 9: off + 9 + clen]
        off += 9 + clen
        if op == M._OP_MESSAGE:
            blob += M._rec(op, content)
        elif op in (M._OP_HEADER, M._OP_SCHEMA, M._OP_CHANNEL):
            keep.append(M._rec(op, content))
    if compression == "zstd":
        import zstandard

        comp = zstandard.ZstdCompressor().compress(blob)
    else:
        comp = blob
    cname = compression.encode()
    chunk = (struct.pack("<QQQI", 0, 0, len(blob), zlib.crc32(blob))
             + struct.pack("<I", len(cname)) + cname
             + struct.pack("<Q", len(comp)) + comp)
    with open(path, "wb") as f:
        f.write(M.MAGIC)
        for r in keep:
            f.write(r)
        f.write(M._rec(M._OP_CHUNK, chunk))
        f.write(M._rec(M._OP_FOOTER, struct.pack("<QQI", 0, 0, 0)))
        f.write(M.MAGIC)
    return n


def canon(x):
    """A value that == compares bit for bit: arrays as (dtype, shape, bytes),
    Frames and tuples as tuples, recursively."""
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if hasattr(x, "quat_wxyz"):
        return ("Frame", x.t, canon(np.asarray(x.position)), canon(np.asarray(x.quat_wxyz)),
                canon(np.asarray(x.points)))
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(canon(v) for v in x)
    return x


def outcome(fn, *args, **kw):
    """("ok", canonical result) or (exception type, message), the message
    with the port's program name put back to the JAX package's."""
    try:
        return "ok", canon(fn(*args, **kw))
    except Exception as e:      # noqa: BLE001 - the type is what is compared
        return type(e).__name__, str(e).replace("pcs-torch", "pcs-tpu")


# ------------------------------------------------------------ cross reading

@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("container", sorted(CONTAINERS))
def test_a_file_of_either_package_reads_bit_for_bit_in_the_other(
        tmp_path, frames, writer, container):
    path = str(tmp_path / ("f." + container.split("-")[0]))
    n = CONTAINERS[container](PACKAGES[writer], path, frames)
    assert n == 2 * len(frames)
    reads = {name: pkg.rosbag.read_bag(path) for name, pkg in PACKAGES.items()}
    assert canon(reads["jax"]) == canon(reads["torch"])
    clouds, poses = reads["torch"]
    assert len(clouds) == len(poses) == len(frames)
    for (t, pts), (tp, pos, quat), fr in zip(clouds, poses, frames):
        assert abs(t - fr.t) < 1e-9 and tp == t
        assert pts.dtype == np.float32 and pts.tobytes() == fr.points.tobytes()
        assert pos.tobytes() == fr.position.tobytes()
        assert quat.tobytes() == fr.quat_wxyz.tobytes()
    assert PORT.rosbag.bag_info(path) == JAX.rosbag.bag_info(path)
    assert PORT.rosbag.bag_info(path)["format"] == (
        "rosbag" if container.startswith("bag") else "mcap")
    got, want = PORT.rosbag.bag_to_frames(path), JAX.rosbag.bag_to_frames(path)
    assert len(got) == len(frames) and canon(got) == canon(want)
    for a, fr in zip(got, frames):
        assert a.points.tobytes() == fr.points.tobytes()
        assert np.abs(a.position - fr.position).max() < 1e-8


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_both_writers_write_the_same_bag_bytes(tmp_path, frames, compression):
    pt, pj = str(tmp_path / "t.bag"), str(tmp_path / "j.bag")
    assert TR.frames_to_bag(pt, frames, compression=compression) == \
        JR.frames_to_bag(pj, frames, compression=compression)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="unsupported compression"):
        TR.frames_to_bag(pt, frames, compression="lz4")


def test_both_writers_write_the_same_mcap_messages(tmp_path, frames):
    """The MCAP files differ only in the header's library string."""
    pt, pj = str(tmp_path / "t.mcap"), str(tmp_path / "j.mcap")
    assert TM.frames_to_mcap(pt, frames) == JM.frames_to_mcap(pj, frames)
    a, b = open(pt, "rb").read(), open(pj, "rb").read()
    assert a.replace(b"\x09\x00\x00\x00pcs-torch", b"\x07\x00\x00\x00pcs-tpu").replace(
        struct.pack("<BQ", 1, 21), struct.pack("<BQ", 1, 19), 1) == b
    assert canon(list(TM.read_messages(pt))) == canon(list(JM.read_messages(pj)))


def test_pose_association_interpolates_and_skips_as_the_jax_reader(tmp_path, caplog):
    """Clouds between pose samples get the interpolated pose; a cloud past
    the 1 s timeout is skipped with a warning; clouds come out sorted."""
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(7, 3)).astype(np.float32)
    quats = rng.normal(size=(3, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    clouds = [(1.0, pts), (0.5, pts + 1), (9.0, pts), (0.25, pts + 2)]
    poses = [(0.0, rng.normal(size=3), quats[0]), (1.0, rng.normal(size=3), quats[1]),
             (2.0, rng.normal(size=3), quats[2])]
    for ext, write in ((".bag", TR.write_bag), (".mcap", TM.write_mcap)):
        path = str(tmp_path / ("assoc" + ext))
        write(path, clouds, poses)
        with caplog.at_level(logging.WARNING, logger="pcs_torch.rosbag"):
            got = TR.bag_to_frames(path)
        want = JR.bag_to_frames(path)
        assert [f.t for f in got] == [0.25, 0.5, 1.0]
        assert canon(got) == canon(want)
        assert any("no pose within the TF" in r.message for r in caplog.records)
        caplog.clear()


def test_message_codecs_equal_the_jax_package():
    """parse_pointcloud2 on padded rows and float64 fields, parse_pose on an
    Odometry message, the CDR reader after an odd-length string."""
    rng = np.random.default_rng(3)
    h, w = 2, 3
    xyz = rng.normal(size=(h * w, 3))
    point_step, pad = 8 * 3 + 4, 16
    row_step = w * point_step + pad
    body = b"".join(
        b"".join(xyz[r * w + c].astype("<f8").tobytes() + b"\0" * 4 for c in range(w))
        + b"\xff" * pad for r in range(h))
    msg = (struct.pack("<III", 0, 3, 250) + struct.pack("<I", 5) + b"drone"
           + struct.pack("<II", h, w) + struct.pack("<I", 3))
    for i, name in enumerate((b"x", b"y", b"z")):
        msg += struct.pack("<I", len(name)) + name + struct.pack("<IBI", 8 * i, 8, 1)
    msg += struct.pack("<BII", 0, point_step, row_step)
    msg += struct.pack("<I", len(body)) + body + struct.pack("<B", 1)
    got, want = TR.parse_pointcloud2(msg), JR.parse_pointcloud2(msg)
    assert canon(got) == canon(want)
    assert got[1].shape == (6, 3) and np.array_equal(got[1], xyz.astype(np.float32))

    odom = (struct.pack("<III", 7, 12, 500000000) + struct.pack("<I", 5) + b"world"
            + struct.pack("<I", 4) + b"base"
            + struct.pack("<7d", 1.0, 2.0, 3.0, 0.1, 0.2, 0.3, 0.9) + np.zeros(36).tobytes())
    assert canon(TR.parse_pose(odom, "nav_msgs/Odometry")) == canon(
        JR.parse_pose(odom, "nav_msgs/Odometry"))
    assert TR.parse_pose(odom, "nav_msgs/Odometry")[2].tolist() == [0.9, 0.1, 0.2, 0.3]

    payloads = []
    for M in (TM, JM):
        wr = M._CdrW()
        wr.header(12.5, "odom")
        wr.string("base_link7")         # 11 bytes with its NUL: forces padding
        wr.f64(1.0, 2.0, 3.0, 0.1, 0.2, 0.3, 0.9)
        payloads.append(wr.payload())
    assert payloads[0] == payloads[1]
    assert canon(TM.parse_pose_cdr(payloads[0], "nav_msgs/msg/Odometry")) == canon(
        JM.parse_pose_cdr(payloads[0], "nav_msgs/msg/Odometry"))
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    assert TM._cdr_pointcloud2(3.25, pts) == JM._cdr_pointcloud2(3.25, pts)
    assert canon(TM.parse_pointcloud2_cdr(TM._cdr_pointcloud2(3.25, pts))) == canon(
        JM.parse_pointcloud2_cdr(TM._cdr_pointcloud2(3.25, pts)))
    assert TR._enc_time(1.9999999999) == JR._enc_time(1.9999999999) == struct.pack("<II", 2, 0)
    assert (TR.CLOUD_TYPE, TR.POSE_TYPES, TM.CLOUD_TYPES, TM.POSE_TYPES, TM.MAGIC, TR._MAGIC) == (
        JR.CLOUD_TYPE, JR.POSE_TYPES, JM.CLOUD_TYPES, JM.POSE_TYPES, JM.MAGIC, JR._MAGIC)


# --------------------------------------------------- broken and ambiguous input

def _tiny(n=3):
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    clouds = [(float(i), pts + i) for i in range(n)]
    poses = [(float(i), np.array([0.0, 0.0, 0.1 * i]), np.array([1.0, 0.0, 0.0, 0.0]))
             for i in range(n)]
    return clouds, poses


def _write(path, data):
    with open(path, "wb") as f:
        f.write(data)
    return str(path)


def _unclose(src):
    """Zero the bag header's index_pos: what a recorder that died leaves."""
    j = src.index(b"index_pos=") + len(b"index_pos=")
    return src[:j] + b"\x00" * 8 + src[j + 8:]


def _tiny_bag(tmp, compression="none"):
    path = str(tmp / "full.bag")
    TR.write_bag(path, *_tiny(), compression=compression)
    return open(path, "rb").read()


def _tiny_mcap(tmp):
    path = str(tmp / "full.mcap")
    TM.write_mcap(path, *_tiny())
    return open(path, "rb").read()


def _mid_chunk(src):
    # 13 bytes of magic, a bag-header record padded to 4096: the chunk starts
    # at 4109
    return 4109 + (len(src) - 4109) // 2


def _chunk_payload_span(src):
    off = len(TR._MAGIC)
    while True:
        (hlen,) = struct.unpack_from("<I", src, off)
        hdr = bytes(src[off + 4: off + 4 + hlen])
        (dlen,) = struct.unpack_from("<I", src, off + 4 + hlen)
        data_off = off + 4 + hlen + 4
        if TR._parse_fields(hdr).get("op", b"\x00")[0] == 0x05:
            return data_off, dlen
        off = data_off + dlen


def _mcap_messages(src):
    off, out = len(TM.MAGIC), []
    while off + 9 <= len(src):
        (clen,) = struct.unpack_from("<Q", src, off + 1)
        if src[off] == TM._OP_MESSAGE:
            out.append((off, clen))
        off += 9 + clen
    return out


def _mcap_chunk(blob, usize=None, crc=0, compression=b"", rlen=None, payload=None):
    payload = blob if payload is None else payload
    return TM.MAGIC + TM._rec(TM._OP_CHUNK, (
        struct.pack("<QQQI", 0, 0, len(blob) if usize is None else usize, crc)
        + struct.pack("<I", len(compression)) + compression
        + struct.pack("<Q", len(payload) if rlen is None else rlen) + payload))


def _schema_blob():
    return TM._rec(TM._OP_SCHEMA, struct.pack("<H", 1) + TM._mstr("x") + TM._mstr("ros2msg")
                   + struct.pack("<I", 0))


def _cloud_conn(conn, topic):
    hdr = (TR._field("op", bytes([0x07])) + TR._field("conn", struct.pack("<I", conn))
           + TR._field("topic", topic))
    return TR._record(hdr, TR._field("topic", topic)
                      + TR._field("type", b"sensor_msgs/PointCloud2"))


def _msg(conn, t, payload):
    return TR._record(TR._field("op", bytes([0x02]))
                      + TR._field("conn", struct.pack("<I", conn))
                      + TR._field("time", TR._enc_time(t)), payload)


def two_cloud_topic_bag(path, chunked=True):
    """A record-everything ROS1 capture: /tof_pc and the node's republished
    filtered cloud, both PointCloud2, in one chunk."""
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    blob = _cloud_conn(0, b"/tof_pc") + _cloud_conn(1, b"/filtered_pointcloud")
    for i in range(2):
        for conn in (0, 1):
            blob += _msg(conn, float(i), TR._ser_pointcloud2(float(i), pts + i, i))
    body = TR._record(TR._field("op", bytes([0x05])) + TR._field("compression", b"none")
                      + TR._field("size", struct.pack("<I", len(blob))), blob) if chunked else blob
    return _write(path, TR._MAGIC + body)


def two_cloud_topic_mcap(path, enc1="cdr", enc2="cdr"):
    pts = np.arange(12, dtype=np.float32).reshape(4, 3)
    out = TM.MAGIC + TM._rec(TM._OP_HEADER, TM._mstr("ros2") + TM._mstr("test"))
    out += TM._rec(TM._OP_SCHEMA, struct.pack("<H", 1) + TM._mstr("sensor_msgs/msg/PointCloud2")
                   + TM._mstr("ros2msg") + struct.pack("<I", 0))
    for ch, (topic, enc) in ((1, ("/tof_pc", enc1)), (2, ("/filtered_pointcloud", enc2))):
        out += TM._rec(TM._OP_CHANNEL, struct.pack("<HH", ch, 1) + TM._mstr(topic)
                       + TM._mstr(enc) + struct.pack("<I", 0))
    for seq in range(2):
        ns = seq * 10 ** 9
        for ch in (1, 2):
            out += TM._rec(TM._OP_MESSAGE, struct.pack("<HIQQ", ch, seq, ns, ns)
                           + TM._cdr_pointcloud2(float(seq), pts + seq))
    out += TM._rec(TM._OP_DATA_END, struct.pack("<I", 0))
    out += TM._rec(TM._OP_FOOTER, struct.pack("<QQI", 0, 0, 0)) + TM.MAGIC
    return _write(path, out)


def _flip(src, at):
    out = bytearray(src)
    out[at] ^= 0xFF
    return bytes(out)


def _case_bag_closed_cut_midfile(tmp):
    src = _tiny_bag(tmp)
    return "read_bag", _write(tmp / "cut.bag", src[:_mid_chunk(src)]), {}, \
        ("OSError", "corrupt, not merely truncated")


def _case_bag_unclosed_cut_mid_chunk(tmp):
    src = _unclose(_tiny_bag(tmp))
    return "read_bag", _write(tmp / "cut.bag", src[:_mid_chunk(src)]), {}, ("ok", None)


def _case_bag_cut_after_chunk(tmp):
    src = _unclose(_tiny_bag(tmp))
    return "read_bag", _write(tmp / "cut.bag", src[:-10]), {}, ("ok", None)


def _case_bag_bz2_flipped_byte(tmp):
    src = _tiny_bag(tmp, "bz2")
    off, n = _chunk_payload_span(src)
    return "read_bag", _write(tmp / "c.bag", _flip(src, off + n // 2)), {}, ("OSError", "bz2")


def _case_bag_garbage_header_field(tmp):
    data = TR._MAGIC + TR._record(struct.pack("<I", 5) + b"nopqr", b"")
    return "read_messages", _write(tmp / "g.bag", data), {}, ("OSError", "no '='")


def _case_bag_nested_record_overrun(tmp):
    blob = struct.pack("<I", 7) + struct.pack("<I", 3) + b"a=b" + struct.pack("<I", 999)
    data = TR._MAGIC + TR._record(
        TR._field("op", bytes([0x05])) + TR._field("compression", b"none")
        + TR._field("size", struct.pack("<I", len(blob))), blob)
    return "read_messages", _write(tmp / "o.bag", data), {}, ("OSError", "corrupt chunk")


def _case_bag_record_missing_op(tmp):
    data = TR._MAGIC + TR._record(TR._field("conn", struct.pack("<I", 0)), b"")
    return "read_messages", _write(tmp / "noop.bag", data), {}, ("OSError", "'op'")


def _case_bag_undecodable_payload(tmp):
    data = TR._MAGIC + _cloud_conn(0, b"/tof_pc") + _msg(0, 1.5, b"\x01\x02")
    return "read_bag", _write(tmp / "u.bag", data), {}, \
        ("OSError", "undecodable sensor_msgs/PointCloud2 on '/tof_pc' at t=1.500")


def _case_bag_message_for_unknown_connection(tmp):
    data = TR._MAGIC + _msg(4, 1.5, b"")
    return "read_messages", _write(tmp / "k.bag", data), {}, ("OSError", "unknown connection 4")


def _case_bag_unknown_compression(tmp):
    data = TR._MAGIC + TR._record(
        TR._field("op", bytes([0x05])) + TR._field("compression", b"xz")
        + TR._field("size", struct.pack("<I", 0)), b"")
    return "read_messages", _write(tmp / "x.bag", data), {}, ("OSError", "unknown chunk compression")


def _case_bag_bz2_chunk_of_an_unclosed_bag(tmp):
    blob = _cloud_conn(0, b"/tof_pc")
    data = TR._MAGIC + TR._record(
        TR._field("op", bytes([0x05])) + TR._field("compression", b"bz2")
        + TR._field("size", struct.pack("<I", len(blob))), bz2.compress(blob))
    return "read_messages", _write(tmp / "b.bag", data), {}, ("ok", None)


def _case_not_a_bag(tmp):
    return "read_messages", _write(tmp / "n.bag", b"#ROSBAG V1.2\n" + b"\0" * 64), {}, \
        ("OSError", "not a ROS1 v2.0 bag")


def _case_bag_two_cloud_topics(tmp):
    return "read_bag", two_cloud_topic_bag(tmp / "two.bag"), {}, \
        ("OSError", "2 topics carry PointCloud2 messages (['/filtered_pointcloud', '/tof_pc'])")


def _case_bag_two_cloud_topics_unchunked_to_frames(tmp):
    return "bag_to_frames", two_cloud_topic_bag(tmp / "two.bag", chunked=False), {}, \
        ("OSError", "pick one with cloud_topic= (--cloud-topic)")


def _case_bag_two_cloud_topics_one_picked(tmp):
    return "read_bag", two_cloud_topic_bag(tmp / "two.bag"), {"cloud_topic": "/tof_pc"}, \
        ("ok", None)


def _case_bag_requested_cloud_topic_matches_nothing(tmp):
    _tiny_bag(tmp)
    return "read_bag", str(tmp / "full.bag"), {"cloud_topic": "/tof_pc2"}, \
        ("OSError", "requested topic '/tof_pc2' (cloud_topic= (--cloud-topic)) carries no "
                    "PointCloud2 messages in this bag")


def _case_bag_requested_pose_topic_matches_nothing(tmp):
    _tiny_bag(tmp)
    return "read_bag", str(tmp / "full.bag"), {"pose_topic": "/typo"}, \
        ("OSError", "carries no pose messages")


def _case_bag_cloud_topic_of_the_pose_type(tmp):
    _tiny_bag(tmp)
    return "read_bag", str(tmp / "full.bag"), {"cloud_topic": "/mavros/local_position/pose"}, \
        ("OSError", "no PointCloud2")


def _case_mcap_truncated_mid_message(tmp):
    src = _tiny_mcap(tmp)
    off, n = _mcap_messages(src)[-1]
    return "read_bag", _write(tmp / "cut.mcap", src[:off + 9 + n // 2]), {}, ("ok", None)


def _case_mcap_closed_file_bad_length(tmp):
    src = bytearray(_tiny_mcap(tmp))
    struct.pack_into("<Q", src, _mcap_messages(bytes(src))[0][0] + 1, 10 ** 9)
    return "mcap.read_messages", _write(tmp / "bad.mcap", bytes(src)), {}, \
        ("OSError", "corrupt record length, not merely truncated")


def _case_mcap_corrupt_chunk_header(tmp):
    data = TM.MAGIC + TM._rec(TM._OP_CHUNK, b"way too short")
    return "mcap.read_messages", _write(tmp / "c.mcap", data), {}, ("OSError", "corrupt chunk")


def _case_mcap_chunk_records_len_overrun(tmp):
    data = _mcap_chunk(b"", usize=16, rlen=10 ** 6)
    return "mcap.read_messages", _write(tmp / "r.mcap", data), {}, ("OSError", "records_len overruns")


def _case_mcap_nested_record_overrun(tmp):
    blob = struct.pack("<BQ", TM._OP_MESSAGE, 10 ** 6) + b"\x00" * 8
    return "mcap.read_messages", _write(tmp / "n.mcap", _mcap_chunk(blob)), {}, \
        ("OSError", "overruns the chunk blob")


def _case_mcap_short_schema_record(tmp):
    data = TM.MAGIC + TM._rec(TM._OP_SCHEMA, b"\x01")
    return "mcap.read_messages", _write(tmp / "s.mcap", data), {}, ("OSError", "too short")


def _case_mcap_undecodable_cdr_payload(tmp):
    data = (TM.MAGIC
            + TM._rec(TM._OP_SCHEMA, struct.pack("<H", 1)
                      + TM._mstr("sensor_msgs/msg/PointCloud2") + TM._mstr("ros2msg")
                      + struct.pack("<I", 0))
            + TM._rec(TM._OP_CHANNEL, struct.pack("<HH", 1, 1) + TM._mstr("/tof_pc")
                      + TM._mstr("cdr") + struct.pack("<I", 0))
            + TM._rec(TM._OP_MESSAGE, struct.pack("<HIQQ", 1, 0, 10 ** 9, 10 ** 9)
                      + b"\x00\x01\x00\x00"))
    return "read_bag", _write(tmp / "u.mcap", data), {}, \
        ("OSError", "undecodable sensor_msgs/msg/PointCloud2 on '/tof_pc' at t=1.000")


def _case_mcap_flipped_byte_in_zstd_chunk(tmp):
    zstandard = pytest.importorskip("zstandard")
    blob = _schema_blob()
    comp = zstandard.ZstdCompressor(write_checksum=True).compress(blob)
    data = _mcap_chunk(blob, compression=b"zstd", payload=_flip(comp, len(comp) // 2))
    return "mcap.read_messages", _write(tmp / "z.mcap", data), {}, ("OSError", "zstd")


def _case_mcap_uncompressed_chunk_crc_mismatch(tmp):
    import zlib

    blob = _schema_blob()
    data = _mcap_chunk(blob, crc=zlib.crc32(blob), payload=_flip(blob, len(blob) - 1))
    return "mcap.read_messages", _write(tmp / "crc.mcap", data), {}, ("OSError", "CRC mismatch")


def _case_mcap_unknown_compression(tmp):
    return "mcap.read_messages", _write(tmp / "x.mcap", _mcap_chunk(b"", compression=b"xz")), {}, \
        ("OSError", "unknown chunk compression 'xz'")


def _case_mcap_message_for_unknown_channel(tmp):
    data = TM.MAGIC + TM._rec(TM._OP_MESSAGE, struct.pack("<HIQQ", 9, 0, 0, 0))
    return "mcap.read_messages", _write(tmp / "k.mcap", data), {}, ("OSError", "unknown channel 9")


def _case_not_an_mcap(tmp):
    return "mcap.read_messages", _write(tmp / "n.mcap", b"\x89MCAP1\r\n" + b"\0" * 64), {}, \
        ("OSError", "not an MCAP file")


def _case_mcap_two_cloud_topics(tmp):
    return "read_bag", two_cloud_topic_mcap(tmp / "two.mcap"), {}, \
        ("OSError", "2 topics carry PointCloud2 messages (['/filtered_pointcloud', '/tof_pc'])")


def _case_mcap_two_cloud_topics_one_picked(tmp):
    return "read_bag", two_cloud_topic_mcap(tmp / "two.mcap"), \
        {"cloud_topic": "/filtered_pointcloud"}, ("ok", None)


def _case_mcap_ros1_encoded_channel(tmp):
    return "read_bag", two_cloud_topic_mcap(tmp / "r1.mcap", enc1="ros1"), \
        {"cloud_topic": "/tof_pc"}, ("OSError", "channel '/tof_pc' is 'ros1'-encoded")


def _case_mcap_ros1_encoded_channel_filtered_out(tmp):
    return "read_bag", two_cloud_topic_mcap(tmp / "r1.mcap", enc1="ros1"), \
        {"cloud_topic": "/filtered_pointcloud"}, ("ok", None)


def _case_mcap_requested_topic_matches_nothing(tmp):
    _tiny_mcap(tmp)
    return "read_bag", str(tmp / "full.mcap"), {"cloud_topic": "/typo"}, \
        ("OSError", "requested topic '/typo'")


CASES = {name[len("_case_"):]: fn for name, fn in sorted(globals().items())
         if name.startswith("_case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_broken_and_ambiguous_input_fails_as_in_the_jax_package(case, tmp_path):
    """Same exception type and message from both packages (the same file, so
    the same basename in the message), or the same messages read."""
    entry, path, kw, (kind, text) = CASES[case](tmp_path)
    results = {}
    for name, pkg in PACKAGES.items():
        mod, _, fn = entry.rpartition(".")
        f = getattr(getattr(pkg, mod or "rosbag"), fn)
        call = (lambda *a, **k: list(f(*a, **k))) if fn == "read_messages" else f
        results[name] = outcome(call, path, **kw)
    assert results["torch"] == results["jax"]
    got_kind, got = results["torch"]
    assert got_kind == kind, got
    if text is not None:
        assert text in got, got


def test_the_expected_outcomes_of_the_cases_that_read():
    """What the cases with an ("ok", None) expectation must have read."""
    import tempfile
    from pathlib import Path

    want = {"bag_unclosed_cut_mid_chunk": (0, 0), "bag_cut_after_chunk": (3, 3),
            "bag_two_cloud_topics_one_picked": (2, 0), "mcap_truncated_mid_message": (3, 2),
            "mcap_two_cloud_topics_one_picked": (2, 0),
            "mcap_ros1_encoded_channel_filtered_out": (2, 0)}
    for case, lens in want.items():
        with tempfile.TemporaryDirectory() as tmp:
            entry, path, kw, _ = CASES[case](Path(tmp))
            clouds, poses = TR.read_bag(path, **kw)
            assert (len(clouds), len(poses)) == lens, case


@pytest.mark.parametrize("container", ["bag", "mcap"])
def test_truncation_at_any_offset_reads_the_same_prefix_in_both(tmp_path, container):
    """An unclosed file cut at every 5th byte: never a bare struct.error,
    and the same clouds and poses from both packages."""
    src = _unclose(_tiny_bag(tmp_path)) if container == "bag" else _tiny_mcap(tmp_path)
    cut = tmp_path / ("cut." + container)
    start = len(TR._MAGIC if container == "bag" else TM.MAGIC)
    seen = set()
    for n in list(range(start, len(src), 5)) + [len(src) - 1]:
        path = _write(cut, src[:n])
        got, want = outcome(TR.read_bag, path), outcome(JR.read_bag, path)
        assert got == want and got[0] == "ok", n
        seen.add((len(got[1][0]), len(got[1][1])))
    assert (0, 0) in seen and max(seen) >= (2, 2)


def test_truncated_tail_warns_on_the_ports_logger(tmp_path, caplog):
    src = _unclose(_tiny_bag(tmp_path))
    with caplog.at_level(logging.WARNING, logger="pcs_torch.rosbag"):
        out = TR.bag_to_frames(_write(tmp_path / "cut.bag", src[:-10]))
    assert len(out) == 3 and all(isinstance(fr.points, np.ndarray) for fr in out)
    assert any("truncated recording" in r.message for r in caplog.records)
    with pytest.raises(TR.TruncatedBag):
        with open(tmp_path / "cut.bag", "rb") as f:
            f.seek(len(TR._MAGIC))
            while TR._read_record(f) is not None:
                pass
    assert issubclass(TR.TruncatedBag, Exception) and not issubclass(TR.TruncatedBag, IOError)


def test_require_single_topic_and_decoder_refusals_equal_the_jax_package():
    two = {"/tof_pc": [1], "/filtered_pointcloud": [2]}
    for args in (({"/tof_pc": [1, 2]}, "PointCloud2", "f.bag", "--cloud-topic"),
                 ({}, "pose", "f.bag", "--pose-topic"),
                 (two, "PointCloud2", "dir/f.bag", "--cloud-topic"),
                 ({"/a": [1]}, "pose", "f.bag", "--pose-topic", "/b")):
        assert outcome(TR.require_single_topic, *args) == outcome(JR.require_single_topic, *args)
    big = (struct.pack("<III", 0, 0, 0) + struct.pack("<I", 0) + struct.pack("<II", 1, 1)
           + struct.pack("<I", 1) + struct.pack("<I", 1) + b"x" + struct.pack("<IBI", 0, 7, 1)
           + struct.pack("<BII", 1, 4, 4) + struct.pack("<I", 4) + b"\0" * 4
           + struct.pack("<B", 1))
    little = big.replace(struct.pack("<BII", 1, 4, 4), struct.pack("<BII", 0, 4, 4))
    for msg, text in ((big, "big-endian"), (little, "lacks ['y', 'z']")):
        got = outcome(TR.parse_pointcloud2, msg)
        assert got == outcome(JR.parse_pointcloud2, msg) and got[0] == "OSError"
        assert text in got[1]
    fields = [("x", 0, 9, 1), ("y", 4, 7, 1), ("z", 8, 7, 1)]
    args = (fields, 0, 12, 12, 1, 1, b"\0" * 12)
    got = outcome(TR.xyz_from_pointcloud_fields, *args, src="mcap")
    assert got == outcome(JR.xyz_from_pointcloud_fields, *args, src="mcap")
    assert got == ("OSError", "mcap: unsupported PointField datatype 9")
    for payload in (b"\x00\x00\x00\x00" + b"\x00" * 16, b"\x00\x01"):
        got = outcome(TM._Cdr, payload)
        assert got[0] == "OSError" and got == outcome(JM._Cdr, payload)
    for args in (("/t", "ros1"), ("/t", "cdr"), ("/t", "")):
        assert outcome(TM.check_cdr, *args) == outcome(JM.check_cdr, *args)
    for mod_t, mod_j, comp in ((TR, JR, b"lz4"), (TM, JM, "lz4")):
        got = outcome(mod_t._decompress, b"not lz4", comp, 7)
        assert got == outcome(mod_j._decompress, b"not lz4", comp, 7) and got[0] == "OSError"
