"""The port's display surface (viz.py): the HTML player rendered from the
port engine's viz stream and from the JAX engine's, the live server on a
growing, torn and recreated JSONL beside the JAX package's server, and the
matplotlib plots."""

import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu import viz as JV
from pointcloud_segmentation_tpu.runtime import SegmentationEngine as JaxEngine

from pointcloud_segmentation_tpu_torch import SegmentationEngine
from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import viz as TV
from pointcloud_segmentation_tpu_torch.eval import match_report
from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS, scene_truth,
                                                        trajectory_poses)
from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory

torch.set_num_threads(2)

SHAPES = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
CFG = TC.default_config(granularity=2, shapes=TC.StaticShapes(**SHAPES))
JCFG = JC.default_config(granularity=2, shapes=JC.StaticShapes(**SHAPES))
TITLE = "pointcloud_segmentation_tpu_torch"


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    """The same 6 frames through both engines, each writing its viz stream
    (with the frame's point clouds); the port's world segments too."""
    base = tmp_path_factory.mktemp("viz")
    poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[:6]
    frames = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=1)
    t_path, j_path = str(base / "torch.jsonl"), str(base / "jax.jsonl")
    eng = SegmentationEngine(CFG, device="cpu", viz_stream=t_path, viz_points=True)
    eng.run_replay(frames)
    eng.finalize(str(base / "t_out"))
    jeng = JaxEngine(JCFG, backend="jax", viz_stream=j_path, viz_points=True)
    jeng.run_replay(frames)
    jeng.finalize(str(base / "j_out"))
    return {"torch": t_path, "jax": j_path, "segments": eng.world_segments(),
            "frames": frames, "base": base}


def _frames_of(html):
    line = next(ln for ln in html.splitlines() if ln.startswith("const FRAMES = "))
    return json.loads(line[len("const FRAMES = "):-1])


@pytest.mark.parametrize("source", ["torch", "jax"])
def test_html_player_equals_the_jax_render_of_the_same_stream(streams, tmp_path, source):
    mine, theirs = str(tmp_path / "t.html"), str(tmp_path / "j.html")
    n = TV.render_viz_stream_html(streams[source], mine)
    assert n == JV.render_viz_stream_html(streams[source], theirs, title=TITLE) == 6
    html = open(mine).read()
    assert html == open(theirs).read()
    assert f"<title>{TITLE}</title>" in html and "__LIVE__" not in html
    assert "__DATA__" not in html and "poll()" not in html
    embedded = _frames_of(html)
    assert [r["frame"] for r in embedded] == [1, 2, 3, 4, 5, 6]
    assert embedded == [json.loads(ln) for ln in open(streams[source])]


def test_the_ports_stream_holds_the_jax_streams_records(streams):
    mine = [json.loads(ln) for ln in open(streams["torch"])]
    theirs = [json.loads(ln) for ln in open(streams["jax"])]
    assert len(mine) == len(theirs) == 6
    for a, b in zip(mine, theirs):
        assert set(a) == set(b)
        assert (a["frame"], a["t"], a["nlines"], a["status"], a["world_count"]) == (
            b["frame"], b["t"], b["nlines"], b["status"], b["world_count"])
        assert a["drone"] == b["drone"]
        assert len(a["cylinders"]) == len(b["cylinders"]) == a["world_count"]
        for c, d in zip(a["cylinders"], b["cylinders"]):
            assert np.abs(np.array(c["p1"] + c["p2"]) - np.array(d["p1"] + d["p2"])).max() < 2e-2
        assert len(a["filtered_points"]) == len(b["filtered_points"])


def test_render_skips_blank_lines_and_takes_a_title(tmp_path):
    path, out = str(tmp_path / "s.jsonl"), str(tmp_path / "s.html")
    with open(path, "w") as f:
        f.write('{"frame": 1}\n\n   \n{"frame": 2}\n')
    assert TV.render_viz_stream_html(path, out, title="a flight") == 2
    assert "<title>a flight</title>" in open(out).read()


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def _stream(srv, frm, gen=None):
    url = srv.url + f"stream?from={frm}" + ("" if gen is None else f"&gen={gen}")
    return json.loads(_get(url))


def _rec(i):
    return {"frame": i + 1, "t": 0.1 * i, "nlines": 1, "status": 0, "world_count": i + 1,
            "cylinders": [], "intersections": []}


@pytest.fixture
def servers(tmp_path):
    """The port's and the JAX package's server on one JSONL path."""
    path = str(tmp_path / "viz.jsonl")
    pair = [TV.VizStreamServer(path, poll_ms=250), JV.VizStreamServer(path, poll_ms=250)]
    threads = [s.start_background() for s in pair]
    yield path, pair
    for s, th in zip(pair, threads):
        s.shutdown()
        th.join(timeout=10)
        assert not th.is_alive()


def test_live_server_follows_a_growing_stream_as_the_jax_server(servers):
    path, (srv, jsrv) = servers
    assert _stream(srv, 0) == _stream(jsrv, 0) == {"gen": 0, "next": 0, "frames": []}
    page = _get(srv.url).decode()
    assert "poll()" in page and "setTimeout(poll, 250)" in page and "const FRAMES = [];" in page
    assert page == _get(jsrv.url).decode().replace(
        "pointcloud_segmentation_tpu (live)", "pointcloud_segmentation_tpu_torch (live)")
    with open(path, "w") as f:
        for i in range(2):
            f.write(json.dumps(_rec(i)) + "\n")
    first = _stream(srv, 0)
    assert first == _stream(jsrv, 0)
    assert [r["frame"] for r in first["frames"]] == [1, 2] and first["next"] == 2
    with open(path, "a") as f:
        f.write(json.dumps(_rec(2)) + "\n")
    more = _stream(srv, first["next"], first["gen"])
    assert more == _stream(jsrv, first["next"], first["gen"])
    assert [r["frame"] for r in more["frames"]] == [3] and more["next"] == 3
    assert _stream(srv, 3, more["gen"])["frames"] == []
    with pytest.raises(urllib.error.HTTPError):
        _get(srv.url + "nothing-here")


def test_live_server_holds_back_a_torn_line_and_resyncs_on_a_new_file(servers):
    path, (srv, jsrv) = servers
    whole = json.dumps(_rec(0)) + "\n"
    torn = json.dumps(_rec(1))
    with open(path, "w") as f:
        f.write(whole + torn[:20])
    got = _stream(srv, 0)
    assert got == _stream(jsrv, 0)
    assert [r["frame"] for r in got["frames"]] == [1] and got["next"] == 1
    with open(path, "a") as f:
        f.write(torn[20:] + "\n" + "not json\n")
    got = _stream(srv, 1, got["gen"])
    assert got == _stream(jsrv, 1, 0)
    assert [r["frame"] for r in got["frames"]] == [2] and got["next"] == 3
    # the producer starts over with a shorter file: a new generation, and a
    # follower holding the old one is sent everything from line 0
    with open(path, "w") as f:
        f.write(json.dumps(_rec(7)) + "\n")
    again = _stream(srv, 3, got["gen"])
    assert again == _stream(jsrv, 3, 0)
    assert again["gen"] == got["gen"] + 1 and again["next"] == 1
    assert [r["frame"] for r in again["frames"]] == [8]


def test_live_server_follows_the_ports_engine_while_it_maps(streams, tmp_path):
    """A VizStreamServer on the JSONL that a replay is writing: polled after
    every frame, it returns that frame's record alone."""
    path = str(tmp_path / "live.jsonl")
    srv = TV.VizStreamServer(path)
    th = srv.start_background()
    try:
        eng = SegmentationEngine(CFG, device="cpu", viz_stream=path)
        nxt, gen, seen = 0, None, []
        for fr in streams["frames"][:4]:
            eng.run_replay([fr])
            resp = _stream(srv, nxt, gen)
            nxt, gen = resp["next"], resp["gen"]
            seen.append([r["frame"] for r in resp["frames"]])
        assert seen == [[1], [2], [3], [4]] and nxt == 4
        eng.finalize(str(tmp_path / "out"))
    finally:
        srv.shutdown()
        th.join(timeout=10)
    assert not th.is_alive()


@pytest.mark.parametrize("plot", ["world", "distance_vs_angle", "cloud_and_segments"])
def test_plots_write_png_files(streams, tmp_path, plot):
    pytest.importorskip("matplotlib")
    truth = scene_truth(OBS_TESTS_SCENE)
    segs = streams["segments"]
    proc = [dict(s, endpoints=[s["t_min"], s["t_max"]]) for s in segs]
    rep = match_report(truth, proc)
    assert rep["matches"]
    out = str(tmp_path / (plot + ".png"))
    if plot == "world":
        inter = [{"position": [0.0, 0.0, 1.0]}]
        fig = TV.plot_world(proc, truth, rep["matches"], intersections=inter, out_path=out)
    elif plot == "distance_vs_angle":
        fig = TV.plot_distance_vs_angle(rep["matches"], out_path=out)
    else:
        pts = np.asarray(json.loads(open(streams["torch"]).readline())["filtered_points"])
        pts = np.concatenate([pts, [[np.nan, 0.0, 0.0]]])
        fig = TV.plot_cloud_and_segments(pts, segs, out_path=out)
    assert fig is not None
    with open(out, "rb") as f:
        head = f.read(8)
    assert head == b"\x89PNG\r\n\x1a\n" and os.path.getsize(out) > 5000
    import matplotlib.pyplot as plt

    plt.close(fig)
