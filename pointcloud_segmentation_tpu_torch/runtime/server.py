"""Network serving mode: the segmentation engine behind a TCP endpoint.

The deployable analog of the reference node's ROS loop (node.cpp:64-67:
subscribe `/tof_pc`, publish segments/markers) without a ROS stack: clients
stream binary frames over a socket, the engine consumes them through the
SAME latest-wins mailbox + worker thread as the live node (frames are
dropped, not queued, under overload), and any client can query the current
world map or ask for the CSV flush at any time.

Wire protocol (little-endian, length-prefixed):

    message   := type:u8 len:u32 payload[len]
    'F' frame := t:f64 pos:3xf64 quat_wxyz:4xf64 n:u32 pts:n*3*f32
                 (the payload layout is exactly one PCSL record —
                 io/replay.py's on-disk format — so log records convert
                 1:1 into messages; note a .pcsl FILE additionally has a
                 magic+version header and no per-record type/len framing,
                 so cat-ing a log to the socket is NOT a valid stream)
    'Q' query := empty; server replies 'S' with a JSON world snapshot
                 {world_segments, intersections, frames_processed,
                  frames_dropped, frames_skipped_no_pose}
    'X' final := empty; server flushes the CSVs (engine.finalize), replies
                 'S' with {"outputs": {...paths}}, and shuts down
    'S' snap  := JSON payload (server -> client only)

Frames are fire-and-forget (topic semantics); only 'Q'/'X' get replies.
The protocol is the JAX package's ``runtime/server.py``, byte for byte, so a
client of either package talks to a server of either.
"""

from __future__ import annotations

import json
import logging
import socket
import struct
import threading
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("pointcloud_segmentation_tpu_torch")

MSG_FRAME = ord("F")
MSG_QUERY = ord("Q")
MSG_FINAL = ord("X")
MSG_SNAP = ord("S")

_HDR = struct.Struct("<BI")
_FRAME_FIXED = struct.Struct("<d3d4dI")


def pack_frame(t: float, position, quat_wxyz, points) -> bytes:
    pts = np.ascontiguousarray(points, np.float32).reshape(-1, 3)
    pos = np.asarray(position, np.float64)
    quat = np.asarray(quat_wxyz, np.float64)
    payload = (_FRAME_FIXED.pack(float(t), *pos.tolist(), *quat.tolist(),
                                 len(pts)) + pts.tobytes())
    return _HDR.pack(MSG_FRAME, len(payload)) + payload


def _unpack_frame(payload: bytes):
    fixed = _FRAME_FIXED.unpack_from(payload, 0)
    t, pos, quat, n = fixed[0], np.array(fixed[1:4]), np.array(fixed[4:8]), fixed[8]
    pts = np.frombuffer(payload, np.float32, count=n * 3,
                        offset=_FRAME_FIXED.size).reshape(n, 3).copy()
    return t, pos, quat, pts


_IDLE = object()          # sentinel: no bytes yet, client merely quiet


def _recv_exact(conn: socket.socket, n: int, idle_ok: bool = False,
                stall_ticks: int = 60):
    """Read exactly n bytes.  Returns None on EOF.  With idle_ok, a
    timeout BEFORE any byte arrives returns _IDLE (a quiet client is not
    an error); a timeout mid-message keeps waiting up to ``stall_ticks``
    socket-timeout periods, then gives up (None) — a half-sent message
    means a broken peer."""
    buf = b""
    stalls = 0
    while len(buf) < n:
        try:
            chunk = conn.recv(n - len(buf))
        except socket.timeout:
            if idle_ok and not buf:
                return _IDLE
            stalls += 1
            if stalls >= stall_ticks:
                return None
            continue
        if not chunk:
            return None
        buf += chunk
        stalls = 0
    return buf


def _send_msg(conn: socket.socket, mtype: int, payload: bytes) -> None:
    conn.sendall(_HDR.pack(mtype, len(payload)) + payload)


class SegmentationServer:
    """Serve one engine over TCP.  Each connection gets a handler thread
    (idle monitors don't block feeders; the engine's state lock keeps
    concurrent queries safe); one engine = one world map = one consumer;
    scale-out is one server per card behind any TCP balancer."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 outdir: str = "."):
        self.engine = engine
        self.outdir = outdir
        # Sanity cap on a single message: one malformed/hostile u32 length
        # header (the class docstring notes cat-ing a .pcsl file at the
        # socket is an easy way to produce garbage framing) must not make
        # the server buffer gigabytes.  Generous headroom over the largest
        # legitimate frame (engine truncates oversized clouds anyway).
        self._max_msg = max(1 << 20,
                            engine.cfg.shapes.max_raw_points * 48 + 4096)
        self._sock = socket.create_server((host, port))
        self._sock.settimeout(0.2)
        self.host, self.port = self._sock.getsockname()[:2]
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._conn_threads: list = []
        self._final_lock = threading.Lock()
        self.finalized: Optional[dict] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "SegmentationServer":
        self.engine.start()          # consumer thread + mailbox
        self._running = True
        self._thread = threading.Thread(target=self._accept_loop, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Idempotent: always closes the socket, joins threads, and stops
        the engine — including after a client-initiated finalize."""
        self._running = False
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None
        for t in self._conn_threads:
            t.join(timeout=5.0)
        self._conn_threads = []
        try:
            self._sock.close()
        except OSError:
            pass
        self.engine.stop()

    def serve_forever(self) -> dict:
        """Run until a client sends the finalize message; returns the
        finalize snapshot (CSV paths).  Always cleans up (socket closed,
        threads joined) on exit."""
        self.start()
        try:
            while self._running and self.finalized is None:
                self._thread.join(timeout=0.2)
        finally:
            self.stop()
        return self.finalized or {}

    # --------------------------------------------------------------- serving
    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, addr = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            th = threading.Thread(target=self._serve_conn_safe,
                                  args=(conn, addr), daemon=True)
            th.start()
            self._conn_threads = [t for t in self._conn_threads
                                  if t.is_alive()] + [th]

    def _serve_conn_safe(self, conn: socket.socket, addr) -> None:
        with conn:
            try:
                self._serve_conn(conn)
            except Exception:
                logger.exception("client %s failed; server continues", addr)

    def _serve_conn(self, conn: socket.socket) -> None:
        # short socket timeout = a liveness tick, NOT a disconnect: idle
        # clients (slow-polling monitors) stay connected; only EOF, a
        # half-sent message, or server shutdown ends the session
        conn.settimeout(1.0)
        while self._running:
            hdr = _recv_exact(conn, _HDR.size, idle_ok=True)
            if hdr is _IDLE:
                continue
            if hdr is None:
                return
            mtype, length = _HDR.unpack(hdr)
            if length > self._max_msg:
                raise IOError(
                    f"message length {length} exceeds cap {self._max_msg} "
                    f"(desynced or hostile client)")
            payload = _recv_exact(conn, length) if length else b""
            if payload is None:
                return
            if mtype == MSG_FRAME:
                t, pos, quat, pts = _unpack_frame(payload)
                self.engine.push_pose(t, pos, quat)
                self.engine.submit_cloud(t, pts)
            elif mtype == MSG_QUERY:
                _send_msg(conn, MSG_SNAP,
                          json.dumps(self._snapshot()).encode())
            elif mtype == MSG_FINAL:
                with self._final_lock:      # one finalizer wins
                    if self.finalized is None:
                        # account for every submitted frame before the
                        # flush: without the drain, stop() drops the last
                        # in-flight frame(s) from the CSVs silently
                        drained = self.engine.drain()
                        if not drained:
                            logger.warning(
                                "finalize: drain timed out — in-flight "
                                "frames may be missing from the CSVs")
                        self.engine.stop()
                        paths = self.engine.finalize(self.outdir)
                        self.finalized = {"outputs": paths,
                                          "drained": bool(drained)}
                _send_msg(conn, MSG_SNAP, json.dumps(self.finalized).encode())
                self._running = False
                return
            else:
                raise IOError(f"unknown message type {mtype}")

    def _snapshot(self) -> dict:
        segs, inter = self.engine.world_snapshot()   # one consistent pair
        return {
            "world_segments": [
                {"a": [float(v) for v in s["a"]],
                 "b": [float(v) for v in s["b"]],
                 "t_min": s["t_min"], "t_max": s["t_max"],
                 "radius": s["radius"], "points_size": s["points_size"],
                 "pca_coeff": s["pca_coeff"]}
                for s in segs],
            "intersections": [list(r) for r in inter],
            "frames_processed": int(self.engine.frames_processed),
            "frames_dropped": int(self.engine.dropped_frames),
            "frames_skipped_no_pose": int(self.engine.frames_skipped_no_pose),
        }


# ------------------------------------------------------------------ client
class SegmentationClient:
    """Minimal client for SegmentationServer (tests, tools, examples)."""

    def __init__(self, host: str, port: int, timeout: float = 30.0):
        self._conn = socket.create_connection((host, port), timeout=timeout)

    def send_frame(self, t: float, position, quat_wxyz, points) -> None:
        self._conn.sendall(pack_frame(t, position, quat_wxyz, points))

    def _roundtrip(self, mtype: int) -> dict:
        _send_msg(self._conn, mtype, b"")
        hdr = _recv_exact(self._conn, _HDR.size)
        if hdr is None:
            raise IOError("server closed the connection")
        rtype, length = _HDR.unpack(hdr)
        payload = _recv_exact(self._conn, length)
        if rtype != MSG_SNAP or payload is None:
            raise IOError(f"unexpected reply type {rtype}")
        return json.loads(payload.decode())

    def query(self) -> dict:
        return self._roundtrip(MSG_QUERY)

    def finalize(self) -> dict:
        return self._roundtrip(MSG_FINAL)

    def close(self) -> None:
        self._conn.close()
