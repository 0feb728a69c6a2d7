"""Offline visualization — the RViz marker / analysis-plot analog.

The reference visualizes live in RViz (cylinder + text markers, intersection
spheres; node.cpp:676-842) and offline via the supervisor's matplotlib plots
(tests_structure.py:89-154).  This module renders the same content from the
engine's structured outputs, headless (Agg), so runs produce inspectable
artifacts without a sim in the loop.  The port's own copy of the JAX package's
viz.py (same code, tests/test_torch_isolation.py): it reads the JSONL that the
port's engine writes, whose records have the JAX engine's keys.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _draw_segment(ax, a, b, endpoints, color="b", linestyle="-", label=None):
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    pts = [a + b * t for t in endpoints]
    xs, ys, zs = zip(*pts)
    ax.plot(xs, ys, zs, color=color, linestyle=linestyle, label=label)


def plot_world(segments: Sequence[dict], truth: Optional[Sequence[dict]] = None,
               matches: Optional[Sequence[tuple]] = None,
               intersections: Optional[Sequence[dict]] = None,
               out_path: Optional[str] = None):
    """3D overlay of extracted segments (dotted) vs ground truth (solid),
    matched pairs highlighted — tests_structure.py:89-131's figure."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")

    if truth:
        for idx, seg in enumerate(truth):
            _draw_segment(ax, seg["a"], seg["b"], seg["endpoints"], color="b",
                          label="Ground truth" if idx == 0 else None)
    for idx, seg in enumerate(segments):
        e = seg.get("endpoints", [seg.get("t_min"), seg.get("t_max")])
        _draw_segment(ax, seg["a"], seg["b"], e, color="b", linestyle=":",
                      label="Extracted" if idx == 0 else None)
    if matches and truth:
        colors = ["g", "r", "c", "m", "y", "k"]
        for ci, (i, j, *_rest) in enumerate(matches):
            col = colors[ci % len(colors)]
            _draw_segment(ax, truth[i]["a"], truth[i]["b"], truth[i]["endpoints"],
                          color=col)
            sj = segments[j]
            e = sj.get("endpoints", [sj.get("t_min"), sj.get("t_max")])
            _draw_segment(ax, sj["a"], sj["b"], e, color=col, linestyle=":")
    if intersections:
        pts = np.array([p["position"] for p in intersections])
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], color="g", s=40,
                   label="Intersections")
    ax.set_xlabel("X axis [m]")
    ax.set_ylabel("Y axis [m]")
    ax.set_zlabel("Z axis [m]")
    ax.legend(loc="upper right")
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def plot_distance_vs_angle(matches: Sequence[tuple],
                           out_path: Optional[str] = None):
    """Error scatter (tests_structure.py:133-154)."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    d = [m[2] for m in matches]
    a = [m[3] for m in matches]
    plt.scatter(d, a, color="red", label="Extracted Segments")
    for i, (x, y) in enumerate(zip(d, a)):
        plt.text(x, y, str(i + 1), fontsize=12)
    plt.xlabel("Distance Error [m]")
    plt.ylabel("Angle Error [rad]")
    plt.grid(True)
    plt.legend(loc="upper right")
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def plot_cloud_and_segments(points: np.ndarray, segments: Sequence[dict],
                            out_path: Optional[str] = None):
    """Debug view: a frame's (filtered) cloud + extracted segments —
    the filtered_pointcloud / hough_pointcloud topics' offline analog."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    pts = np.asarray(points)
    pts = pts[np.isfinite(pts).all(axis=1)]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=1, alpha=0.4)
    for seg in segments:
        e = seg.get("endpoints", [seg.get("t_min"), seg.get("t_max")])
        _draw_segment(ax, seg["a"], seg["b"], e, color="r")
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    ax.set_zlabel("Z [m]")
    if out_path:
        fig.savefig(out_path, dpi=120)
    return fig


def render_viz_stream_html(jsonl_path: str, out_html: str,
                           title: str = "pointcloud_segmentation_tpu_torch") -> int:
    """Render a per-frame viz stream (engine ``viz_stream`` JSONL) into a
    self-contained interactive HTML player — the offline stand-in for the
    reference's live RViz view (node.cpp:676-842): world-segment cylinders
    and intersection spheres, per frame, with playback + orbit controls.

    No external assets or libraries; one file, opens anywhere.  Returns the
    number of frames embedded.
    """
    import json as _json

    frames = []
    with open(jsonl_path) as f:
        for line in f:
            line = line.strip()
            if line:
                frames.append(_json.loads(line))
    data = _json.dumps(frames)
    html = _VIZ_HTML_TEMPLATE.replace("__TITLE__", title).replace(
        "__DATA__", data).replace("__LIVE__", "")
    with open(out_html, "w") as f:
        f.write(html)
    return len(frames)


class VizStreamServer:
    """LIVE viewing of a growing viz-stream JSONL — the missing half of the
    RViz loop (the reference is watched live while the node maps,
    node.cpp:676-842 + rviz/drone_pc.rviz).  A tiny HTTP server pairs the
    HTML player with a ``/stream?from=N&gen=G`` endpoint that tails the
    JSONL.  Responses are ``{"gen", "next", "frames"}``: ``next`` is the
    server-side line cursor the client echoes back (so torn/unparseable
    lines are never re-served), and a ``gen`` bump tells a follower the
    producer file was truncated/recreated — it resyncs from line 0
    instead of silently mixing two runs.  The
    player polls it and follows the newest frame, so a concurrent
    ``pcs-torch run/stream/serve --viz-stream f.jsonl`` process can be watched
    as it maps: ``pcs-torch viz f.jsonl --follow``.

    No dependencies beyond the stdlib; the JSONL file may not exist yet at
    startup (served as zero frames until the producer creates it).
    """

    def __init__(self, jsonl_path: str, host: str = "127.0.0.1",
                 port: int = 0, poll_ms: int = 500,
                 title: str = "pointcloud_segmentation_tpu_torch (live)"):
        import http.server
        import json as _json

        path = jsonl_path
        page = (_VIZ_HTML_TEMPLATE
                .replace("__TITLE__", title)
                .replace("__DATA__", "[]")
                .replace("__LIVE__", _VIZ_LIVE_SNIPPET)
                .replace("__POLL_MS__", str(int(poll_ms)))).encode()

        import os as _os
        import threading as _threading

        # Incremental tail index: offsets[i] = byte offset where line i
        # starts; offsets[nlines] = resume point after the last COMPLETE
        # (newline-terminated) line.  Re-reading the whole JSONL on every
        # 500 ms poll made long --viz-points streams O(file) per poll
        # (multi-GB after an hour at 30 Hz); each poll is now O(new data)
        # and the common follow-up poll (start == nlines) touches nothing.
        cache_lock = _threading.Lock()
        # gen increments whenever the file is detected truncated/recreated;
        # it is the follower's resync token (see read_frames)
        cache = {"seen": 0, "offsets": [0], "nlines": 0, "gen": 0}

        def _reset_index():
            cache.update(seen=0, offsets=[0], nlines=0, gen=cache["gen"] + 1)

        def _index_new_lines():
            try:
                size = _os.stat(path).st_size
            except OSError:
                return
            if size < cache["seen"]:        # truncated/recreated producer
                _reset_index()
            tail = cache["offsets"][cache["nlines"]]
            if size <= cache["seen"]:
                return
            try:
                with open(path, "rb") as f:
                    if tail > 0:
                        # a rewrite that already outgrew the old size
                        # defeats the shrink check above; verify the last
                        # indexed line boundary is still a newline
                        f.seek(tail - 1)
                        if f.read(1) != b"\n":
                            _reset_index()
                            tail = 0
                            f.seek(0)
                    data = f.read()
            except OSError:
                return
            cache["seen"] = tail + len(data)
            idx = 0
            while True:
                nl = data.find(b"\n", idx)
                if nl < 0:                  # torn tail line; next poll
                    break
                cache["nlines"] += 1
                cache["offsets"].append(tail + nl + 1)
                idx = nl + 1

        def read_frames(start: int, client_gen=None):
            """Tail protocol: returns {"gen", "next", "frames"}.  `next` is
            the SERVER's line count after the returned frames — the client
            passes it back verbatim, so unparseable (torn) lines are never
            re-served as duplicates.  A `gen` mismatch (producer restarted
            with a truncated file) restarts the client from line 0."""
            start = max(int(start), 0)
            with cache_lock:
                _index_new_lines()
                gen = cache["gen"]
                if client_gen is not None and client_gen != gen:
                    start = 0               # stale follower: full resync
                nlines = cache["nlines"]
                start = min(start, nlines)
                off0 = cache["offsets"][start]
                end = cache["offsets"][nlines]
            out = []
            if end > off0:
                try:
                    with open(path, "rb") as f:
                        f.seek(off0)
                        data = f.read(end - off0)
                except OSError:
                    return {"gen": gen, "next": start, "frames": []}
                for line in data.split(b"\n"):
                    if line.strip():
                        try:
                            out.append(_json.loads(line))
                        except ValueError:
                            pass            # torn mid-write; next poll
            return {"gen": gen, "next": nlines, "frames": out}

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API name)
                if self.path.startswith("/stream"):
                    start, client_gen = 0, None
                    if "from=" in self.path:
                        try:
                            start = int(self.path.split("from=")[1]
                                        .split("&")[0])
                        except ValueError:
                            pass
                    if "gen=" in self.path:
                        try:
                            client_gen = int(self.path.split("gen=")[1]
                                             .split("&")[0])
                        except ValueError:
                            pass
                    body = _json.dumps(read_frames(start, client_gen)).encode()
                    ctype = "application/json"
                elif self.path in ("/", "/index.html"):
                    body, ctype = page, "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self.httpd = http.server.ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self.httpd.server_address[:2]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def serve_forever(self):
        try:
            self.httpd.serve_forever()
        finally:
            self.httpd.server_close()

    def start_background(self):
        import threading

        th = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        th.start()
        return th

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


_VIZ_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px 12px;
      border-radius:6px}
 #bar{position:fixed;bottom:8px;left:8px;right:8px;display:flex;gap:8px;
      align-items:center;background:#000a;padding:8px;border-radius:6px}
 #slider{flex:1}
 button{background:#333;color:#ddd;border:1px solid #555;border-radius:4px;
        padding:4px 10px;cursor:pointer}
 canvas{display:block}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar"><button id="play">&#9654;</button>
 <input id="slider" type="range" min="0" value="0">
 <span id="lbl"></span></div>
<script>
const FRAMES = __DATA__;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const hud = document.getElementById('hud'), lbl = document.getElementById('lbl');
const slider = document.getElementById('slider'), playBtn = document.getElementById('play');
slider.max = Math.max(FRAMES.length - 1, 0);
let cur = 0, playing = false, yaw = 0.8, pitch = 0.45, zoom = 120, cxo = 0, czo = 1.0;
function resize(){ cv.width = innerWidth; cv.height = innerHeight; draw(); }
addEventListener('resize', resize);
function proj(p){
  const cy = Math.cos(yaw), sy = Math.sin(yaw), cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x = p[0]-cxo, y = p[1], z = p[2]-czo;
  const xr = cy*x + sy*y, yr = -sy*x + cy*y;
  const zr = cp*z - sp*yr, yr2 = sp*z + cp*yr;
  return [cv.width/2 + xr*zoom, cv.height/2 - zr*zoom, yr2];
}
function line3(a, b, w, col){
  const pa = proj(a), pb = proj(b);
  ctx.strokeStyle = col; ctx.lineWidth = w;
  ctx.beginPath(); ctx.moveTo(pa[0], pa[1]); ctx.lineTo(pb[0], pb[1]); ctx.stroke();
}
function draw(){
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, cv.width, cv.height);
  // ground grid
  for (let i = -3; i <= 3; i++){
    line3([i, -3, 0], [i, 3, 0], 1, '#222');
    line3([-3, i, 0], [3, i, 0], 1, '#222');
  }
  line3([0,0,0],[0.5,0,0],2,'#a33'); line3([0,0,0],[0,0.5,0],2,'#3a3');
  line3([0,0,0],[0,0,0.5],2,'#33a');
  const fr = FRAMES[cur]; if (!fr) return;
  // drone flight path + current pose (the RViz Path / Pose displays)
  ctx.strokeStyle = '#59f'; ctx.lineWidth = 1.5; ctx.beginPath();
  let onPath = false;
  for (let i = 0; i <= cur; i++){
    const d = FRAMES[i] && FRAMES[i].drone; if (!d) continue;
    const q = proj(d.position);
    if (onPath) ctx.lineTo(q[0], q[1]);
    else { ctx.moveTo(q[0], q[1]); onPath = true; }
  }
  ctx.stroke();
  if (fr.drone){
    const dp = fr.drone.position, q = fr.drone.quat_wxyz;
    // body +x (sensor boresight) in world frame: R(q) @ [1,0,0]
    const fwd = [1 - 2*(q[2]*q[2] + q[3]*q[3]),
                 2*(q[1]*q[2] + q[0]*q[3]),
                 2*(q[1]*q[3] - q[0]*q[2])];
    line3(dp, [dp[0] + 0.3*fwd[0], dp[1] + 0.3*fwd[1], dp[2] + 0.3*fwd[2]],
          2, '#59f');
    const pp = proj(dp);
    ctx.fillStyle = '#59f';
    ctx.beginPath(); ctx.arc(pp[0], pp[1], 4, 0, 6.283); ctx.fill();
  }
  if (fr.filtered_points){ ctx.fillStyle = '#667';
    for (const p of fr.filtered_points){ const q = proj(p);
      ctx.fillRect(q[0], q[1], 2, 2); } }
  if (fr.hough_points){ ctx.fillStyle = '#fa0';
    for (const p of fr.hough_points){ const q = proj(p);
      ctx.fillRect(q[0]-1, q[1]-1, 3, 3); } }
  for (const c of fr.cylinders){
    const w = Math.max(2, c.radius * 2 * zoom);
    line3(c.p1, c.p2, w, 'hsl(' + (c.id * 47 % 360) + ',70%,55%)');
    const m = proj([(c.p1[0]+c.p2[0])/2,(c.p1[1]+c.p2[1])/2,(c.p1[2]+c.p2[2])/2]);
    ctx.fillStyle = '#fff'; ctx.fillText(String(c.id), m[0] + 6, m[1] - 6);
  }
  for (const s of fr.intersections){
    const p = proj(s.position);
    ctx.fillStyle = '#ff0';
    ctx.beginPath(); ctx.arc(p[0], p[1], 5, 0, 6.283); ctx.fill();
  }
  hud.innerHTML = 'frame <b>' + fr.frame + '</b> &nbsp; t=' + fr.t.toFixed(3)
    + ' &nbsp; nlines=' + fr.nlines + ' &nbsp; world segments=<b>'
    + fr.world_count + '</b> &nbsp; intersections=' + fr.intersections.length;
  lbl.textContent = (cur + 1) + '/' + FRAMES.length;
  slider.value = cur;
}
slider.oninput = () => { cur = +slider.value; draw(); };
playBtn.onclick = () => { playing = !playing; playBtn.innerHTML = playing ? '&#10074;&#10074;' : '&#9654;'; };
setInterval(() => { if (playing && FRAMES.length){ cur = (cur + 1) % FRAMES.length; draw(); } }, 120);
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY];
cv.onmousemove = e => { if (drag){ yaw += (e.clientX - drag[0]) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch + (e.clientY - drag[1]) * 0.008));
  drag = [e.clientX, e.clientY]; draw(); } };
cv.onmouseup = () => drag = null;
cv.onwheel = e => { zoom = Math.max(20, Math.min(600, zoom * (e.deltaY < 0 ? 1.1 : 0.9))); draw(); e.preventDefault(); };
resize();
__LIVE__
</script></body></html>
"""

# Injected in --follow mode: poll the server for new frames and track the
# latest one (dragging the slider pauses following; the ⏭ button resumes).
_VIZ_LIVE_SNIPPET = """
let follow = true;
let nextFrom = 0, gen = null;
const fbtn = document.createElement('button');
fbtn.innerHTML = '&#9197;'; fbtn.title = 'follow live';
document.getElementById('bar').appendChild(fbtn);
fbtn.onclick = () => { follow = true; if (FRAMES.length){ cur = FRAMES.length - 1; draw(); } };
slider.addEventListener('input', () => follow = false);
async function poll(){
  try {
    const r = await fetch('/stream?from=' + nextFrom + (gen === null ? '' : '&gen=' + gen));
    const resp = await r.json();
    if (gen !== null && resp.gen !== gen){
      // producer restarted with a truncated file: resync from scratch
      FRAMES.length = 0; cur = 0;
    }
    gen = resp.gen; nextFrom = resp.next;
    if (resp.frames.length){
      FRAMES.push(...resp.frames);
      slider.max = Math.max(FRAMES.length - 1, 0);
      if (follow) cur = FRAMES.length - 1;
      draw();
    }
  } catch (e) {}
  setTimeout(poll, __POLL_MS__);
}
poll();
"""
