"""The PyTorch port stands alone: it imports nothing of the JAX package, and
its copies of the JAX package's framework-free code (config, sphere,
quat_to_rot, the scenes and the simulator, the replay codec, the mailbox,
the pose buffer, the CSV writers, the intersection rows, the viz point
helpers, eval, the server's wire format, the numpy oracle with its geometry
helpers, the parity soak's draws and bookkeeping, the ROS1 bag and MCAP
readers and writers, the ROS bridge, viz and the malloc arena cap) give the
same values as the originals.  Its C++ host runtime is the JAX package's
source but for comments, built into a library of its own."""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from pointcloud_segmentation_tpu import config as JC
from pointcloud_segmentation_tpu import geometry as JG
from pointcloud_segmentation_tpu import sphere as JS
from pointcloud_segmentation_tpu.io import scene as JSC
from pointcloud_segmentation_tpu.io import simulator as JSIM
from pointcloud_segmentation_tpu.io import replay as JREP
from pointcloud_segmentation_tpu import eval as JEVAL
from pointcloud_segmentation_tpu import oracle as JORACLE
from pointcloud_segmentation_tpu.runtime import csvio as JCSV
from pointcloud_segmentation_tpu.runtime import engine as JENG
from pointcloud_segmentation_tpu.runtime import server as JSRV
from pointcloud_segmentation_tpu.runtime.engine import SegmentationEngine as JaxEngine
from pointcloud_segmentation_tpu.runtime.mailbox import LatestWinsMailbox as JMailbox
from pointcloud_segmentation_tpu.runtime.posebuffer import PoseBuffer as JPoseBuffer

from pointcloud_segmentation_tpu_torch import config as TC
from pointcloud_segmentation_tpu_torch import geometry as TG
from pointcloud_segmentation_tpu_torch import sphere as TS
from pointcloud_segmentation_tpu_torch.io import scene as TSC
from pointcloud_segmentation_tpu_torch.io import simulator as TSIM
from pointcloud_segmentation_tpu_torch.io import replay as TREP
from pointcloud_segmentation_tpu_torch import eval as TEVAL
from pointcloud_segmentation_tpu_torch import oracle as TORACLE
from pointcloud_segmentation_tpu_torch.oracle import _geometry as TOG
from pointcloud_segmentation_tpu_torch.runtime import csvio as TCSV
from pointcloud_segmentation_tpu_torch.runtime import engine as TENG
from pointcloud_segmentation_tpu_torch.runtime import server as TSRV
from pointcloud_segmentation_tpu_torch.runtime.engine import intersection_pairs
from pointcloud_segmentation_tpu_torch.runtime.mailbox import LatestWinsMailbox as TMailbox
from pointcloud_segmentation_tpu_torch.runtime.posebuffer import PoseBuffer as TPoseBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "pointcloud_segmentation_tpu_torch")
JAX_PKG = "pointcloud_segmentation_tpu"


def test_importing_the_port_loads_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pointcloud_segmentation_tpu_torch as P\n"
        "mods = [m.name for m in pkgutil.walk_packages(P.__path__, P.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'pointcloud_segmentation_tpu')\n"
        "       or m.startswith(('jax.', 'pointcloud_segmentation_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 31        # parallel and parallel.sharding among them


def _forbidden(name: str) -> bool:
    """The JAX package, or jax itself."""
    return any(name == root or name.startswith(root + ".") for root in (JAX_PKG, "jax"))


def jax_package_imports(src: str, rel_path: str) -> list:
    """Every import of the JAX package or of jax in one source file at
    rel_path (from the repo's root): absolute, relative that climbs out to
    the repo's root, or by name through importlib.import_module /
    __import__."""
    depth = rel_path.count("/")      # packages between the root and the file
    hits = []
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            hits += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            if node.level == 0 and _forbidden(mod):
                hits.append(mod)
            elif node.level > depth:
                hits.append("." * node.level + mod)
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _forbidden(arg.value)):
                hits.append(arg.value)
    return hits


def test_no_source_of_the_port_imports_the_jax_package():
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "parity_soak_torch.py"),
             os.path.join(REPO, "tools", "endurance_torch.py"),
             os.path.join(REPO, "tools", "structure_torch.py"),
             os.path.join(REPO, "examples", "map_a_structure_torch.py"),
             os.path.join(REPO, "examples", "serve_and_query_torch.py")]
    for root, _, files in os.walk(PORT):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) >= 42
    rels = {os.path.relpath(p, PORT).replace(os.sep, "/") for p in paths}
    assert {"oracle/__init__.py", "oracle/pipeline.py", "oracle/_geometry.py",
            "io/rosbag.py", "io/mcap.py", "io/ros_bridge.py", "viz.py", "_malloc.py",
            "cli.py", "parallel/__init__.py", "parallel/sharding.py"} <= rels
    found = {}
    for p in paths:
        rel = os.path.relpath(p, REPO).replace(os.sep, "/")
        hits = jax_package_imports(open(p).read(), rel)
        if hits:
            found[rel] = hits
    assert not found, found


def test_the_import_scan_sees_every_form():
    src = ("import pointcloud_segmentation_tpu.config\n"
           "from pointcloud_segmentation_tpu import sphere\n"
           "from .. import sphere as s2\n"
           "from . import voting\n"
           "import pointcloud_segmentation_tpu_torch.config\n"
           "import jaxtyping\n"
           "def f():\n"
           "    import importlib\n"
           "    import jax.numpy as jnp\n"
           "    from jax import lax\n"
           "    return importlib.import_module('pointcloud_segmentation_tpu.io')\n")
    hits = jax_package_imports(src, "pointcloud_segmentation_tpu_torch/ops/x.py")
    assert sorted(hits) == sorted([
        "pointcloud_segmentation_tpu.config", "pointcloud_segmentation_tpu",
        "jax.numpy", "jax", "pointcloud_segmentation_tpu.io"]), hits
    hits = jax_package_imports(src, "pointcloud_segmentation_tpu_torch/x.py")
    assert ".." in hits


def _without_comments(path) -> str:
    """A C++ source with its // comments and all whitespace taken out."""
    import re

    with open(path) as f:
        return re.sub(r"\s+", "", re.sub(r"//[^\n]*", "", f.read()))


def test_the_native_source_is_the_jax_packages_but_for_comments():
    mine = os.path.join(PORT, "csrc", "pcs_runtime.cpp")
    theirs = os.path.join(REPO, "native", "pcs_runtime.cpp")
    assert _without_comments(mine) == _without_comments(theirs)
    assert len(_without_comments(mine)) > 8_000
    with open(mine) as f:
        assert "pcs_feeder_start" in f.read()


def test_the_port_loads_its_own_native_library_and_not_the_jax_packages():
    """In a fresh interpreter the port builds and uses its native runtime:
    the library mapped is its own, under build/torch_native/, and neither
    the JAX package's libpcs_runtime.so nor jax is loaded."""
    code = (
        "import os, sys, tempfile, time\n"
        "import numpy as np\n"
        "from pointcloud_segmentation_tpu_torch import native\n"
        "from pointcloud_segmentation_tpu_torch.io.replay import load_frames, save_frames\n"
        "from pointcloud_segmentation_tpu_torch.io.simulator import Frame\n"
        "assert native.available()\n"
        "mb, pb = native.NativeMailbox(64), native.NativePoseBuffer()\n"
        "d = tempfile.mkdtemp()\n"
        "log = os.path.join(d, 'l.pcsl')\n"
        "save_frames(log, [Frame(t=0.1 * i, position=np.zeros(3),\n"
        "                        quat_wxyz=np.array([1.0, 0, 0, 0]),\n"
        "                        points=np.ones((5, 3), np.float32)) for i in range(4)])\n"
        "f = native.NativeFeeder(log, mb, pb, rate_hz=0.0)\n"
        "while not f.done:\n"
        "    time.sleep(0.01)\n"
        "assert f.stop() == 4 and len(pb) == 4 and len(load_frames(log)) == 4\n"
        "maps = open('/proc/self/maps').read()\n"
        "assert 'pointcloud_segmentation_tpu/native/libpcs_runtime' not in maps\n"
        "assert 'libpcs_runtime.so' not in maps\n"
        "mine = [ln.split()[-1] for ln in maps.splitlines() if 'libpcs_runtime_' in ln]\n"
        "assert mine and all('/build/torch_native/' in p for p in mine), mine\n"
        "bad = [m for m in sys.modules if m in ('jax', 'pointcloud_segmentation_tpu')\n"
        "       or m.startswith(('jax.', 'pointcloud_segmentation_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(sorted(set(mine))[0])\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().startswith(os.path.join(REPO, "build", "torch_native"))


def test_the_structure_tool_loads_neither_jax_nor_the_jax_package():
    """tools/structure_torch.py flies a flight on the CPU, oracle beside
    it, with neither loaded."""
    code = (
        "import importlib.util, sys\n"
        "spec = importlib.util.spec_from_file_location('s', 'tools/structure_torch.py')\n"
        "st = importlib.util.module_from_spec(spec); spec.loader.exec_module(st)\n"
        "rec = st.run_flight('dev_multi_radius', 2, 'cpu', max_frames=2)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'pointcloud_segmentation_tpu')\n"
        "       or m.startswith(('jax.', 'pointcloud_segmentation_tpu.'))]\n"
        "assert not bad, bad\n"
        "print(rec['ok'])\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "True"


# ----------------------------------------------------------------- parity

CONFIG_FIELDS = ("num_x_max", "voting_mode", "leaf_size", "opt_dx", "diag_voxel",
                 "max_lines", "num_directions")


def _same_config(tc, jc):
    for f in CONFIG_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    assert dataclasses.asdict(tc.shapes) == dataclasses.asdict(jc.shapes)
    for f in dataclasses.fields(tc):
        if f.name != "shapes":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name


def _config_default():
    _same_config(TC.default_config(), JC.default_config())
    assert TC.NUM_DIRECTIONS == JC.NUM_DIRECTIONS
    assert (TC.VERBOSE_NONE, TC.VERBOSE_INFO, TC.VERBOSE_WARN) == (
        JC.VERBOSE_NONE, JC.VERBOSE_INFO, JC.VERBOSE_WARN)
    for kw in ({}, dict(granularity=2, radius_sizes=(0.015, 0.05), verbose_level=2)):
        assert TC.default_config(**kw).to_dict() == JC.default_config(**kw).to_dict()


def _config_yaml(tmp_path):
    path = os.path.join(REPO, "configs", "config.yaml")
    _same_config(TC.PipelineConfig.from_yaml(path), JC.PipelineConfig.from_yaml(path))
    _same_config(TC.PipelineConfig.from_yaml(path, granularity=3),
                 JC.PipelineConfig.from_yaml(path, granularity=3))
    changed = str(tmp_path / "changed.yaml")
    with open(changed, "w") as f:
        f.write("granularity: 2\nradius_sizes: [0.015, 0.05]\nopt_nlines: 3\n"
                "rad_2_leaf_ratio: 1.5\nunknown_key: 1\n")
    _same_config(TC.PipelineConfig.from_yaml(changed), JC.PipelineConfig.from_yaml(changed))


def _config_grid():
    for radius in ((0.015,), (0.03, 0.05), (0.05,), (0.1,), (0.2, 0.05)):
        for g in range(7):
            for ratio in (1.0, 1.5, 2.0):
                kw = dict(radius_sizes=radius, granularity=g, rad_2_leaf_ratio=ratio,
                          opt_nlines=g - 1)
                _same_config(TC.default_config(**kw), JC.default_config(**kw))
    shapes = dict(max_raw_points=2048, max_points=1024, max_world_segments=32, max_iters=7)
    _same_config(TC.default_config(shapes=TC.StaticShapes(**shapes), voting="carry"),
                 JC.default_config(shapes=JC.StaticShapes(**shapes), voting="carry"))


def _hough_space():
    for g in range(7):
        for t, j in zip(TS.hough_space(g), JS.hough_space(g)):
            assert t.dtype == j.dtype and t.shape == j.shape
            assert t.tobytes() == j.tobytes(), g


def _quat_to_rot():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(64, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    for row in q:
        assert np.array_equal(np.array(TG.quat_to_rot(*row)), np.array(JG.quat_to_rot(*row)))


def _simulate_trajectory():
    assert TSC.OBS_TESTS_SCENE == tuple(
        TSC.Cylinder(c.center, c.axis, c.radius, c.height) for c in JSC.OBS_TESTS_SCENE)
    assert TSC.WP_TESTS == JSC.WP_TESTS
    poses_t = TSC.trajectory_poses(TSC.WP_TESTS, hz=2.0, velocity=0.25)
    poses_j = JSC.trajectory_poses(JSC.WP_TESTS, hz=2.0, velocity=0.25)
    assert len(poses_t) == len(poses_j) == 31
    for (tt, pt, qt), (tj, pj, qj) in zip(poses_t, poses_j):
        assert tt == tj and np.array_equal(pt, pj) and np.array_equal(qt, qj)
    spec_t = TSIM.TofSpec(width=32, height=24, noise_frac=0.002)
    spec_j = JSIM.TofSpec(width=32, height=24, noise_frac=0.002)
    ft = TSIM.simulate_trajectory(TSC.OBS_TESTS_SCENE, poses_t[::6], spec_t, seed=5)
    fj = JSIM.simulate_trajectory(JSC.OBS_TESTS_SCENE, poses_j[::6], spec_j, seed=5)
    assert len(ft) == len(fj) == 6
    for a, b in zip(ft, fj):
        assert a.t == b.t
        for f in ("position", "quat_wxyz", "points"):
            assert getattr(a, f).tobytes() == getattr(b, f).tobytes(), f


def _pose_buffer():
    rng = np.random.default_rng(8)
    pt, pj = TPoseBuffer(capacity=16), JPoseBuffer(capacity=16)
    for t in rng.permutation(20) * 0.5:
        pos, q = rng.normal(size=3), rng.normal(size=4)
        pt.push(t, pos, q)
        pj.push(t, pos, q)
    assert len(pt) == len(pj) == 16
    for t in np.concatenate([rng.uniform(-2.0, 12.0, 200), [2.0, 9.5, 10.5, 11.0]]):
        a, b = pt.lookup(t), pj.lookup(t)
        assert (a is None) == (b is None), t
        if a is not None:
            assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), t


def _csv_writers(tmp_path):
    rng = np.random.default_rng(4)
    segs = [{"a": rng.normal(size=3) * 10 ** k, "b": rng.normal(size=3),
             "t_min": float(rng.normal()), "t_max": float(rng.normal() * 1e6)}
            for k in range(-3, 4)]
    rows = [(i, float(rng.normal()), j, float(rng.normal() * 1e-7))
            for i in range(4) for j in range(i)]
    recs = [{"wall_time": float(rng.uniform(0, 1e7)), "processing_time": float(rng.uniform(0, 1e5)),
             "seg_vec_size": int(rng.integers(0, 64)), "nblines": int(rng.integers(0, 10))}
            for _ in range(5)]
    for writer in ("write_segments_csv", "write_intersections_csv", "write_processing_time_csv"):
        data = {"write_segments_csv": segs, "write_intersections_csv": rows,
                "write_processing_time_csv": recs}[writer]
        pa, pb = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
        getattr(TCSV, writer)(pa, data)
        getattr(JCSV, writer)(pb, data)
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read(), writer
    TCSV.write_segments_csv(pa, segs)
    assert TCSV.read_segments_csv(pa) == JCSV.read_segments_csv(pa)
    assert TCSV.fmt_double(5123456.0) == JCSV.fmt_double(5123456.0) == "5.12346e+06"


def _intersection_pairs():
    rng = np.random.default_rng(6)
    for n in (0, 1, 5, 12):
        inter = rng.normal(size=(12, 12, 2)).astype(np.float32)
        inter[rng.random((12, 12)) < 0.4] = -1.0
        inter[0, :, 0] = -1.0            # one -1 of the two skips the pair too
        assert intersection_pairs(inter, n) == JaxEngine._intersection_pairs(inter, n)


def _mailbox():
    """The same put/take/close sequence gives the same values and drops, on
    one thread and with a consumer thread racing a producer."""
    rng = np.random.default_rng(9)
    boxes = (TMailbox(), JMailbox())
    script = [("put", int(v)) if rng.random() < 0.6 else ("take", None)
              for v in rng.integers(0, 1000, 200)] + [("close", None), ("take", None),
                                                      ("put", 7), ("take", None)]
    seen = ([], [])
    for op, v in script:
        for box, got in zip(boxes, seen):
            if op == "put":
                box.put(v)
            elif op == "take":
                got.append(box.take(timeout=0.0))
            else:
                box.close()
    assert seen[0] == seen[1]
    assert boxes[0].dropped == boxes[1].dropped > 0
    assert boxes[0].closed and boxes[1].closed

    def race(box):
        taken = []
        t = threading.Thread(target=lambda: taken.extend(
            iter(lambda: box.take(timeout=0.5), None)))
        t.start()
        for v in range(2000):
            box.put(v)
        box.close()
        t.join(timeout=10.0)
        assert not t.is_alive()
        assert taken == sorted(set(taken)) and taken[-1] == 1999
        assert len(taken) + box.dropped == 2000
    for box in (TMailbox(), JMailbox()):
        race(box)


def _replay_codec(tmp_path):
    poses = TSC.trajectory_poses(TSC.WP_TESTS, hz=2.0, velocity=0.25)[::5]
    frames = TSIM.simulate_trajectory(TSC.OBS_TESTS_SCENE, poses,
                                      TSIM.TofSpec(width=16, height=12), seed=2)
    frames.append(TSIM.Frame(t=99.5, position=np.zeros(3), quat_wxyz=np.array([1.0, 0, 0, 0]),
                             points=np.zeros((0, 3), np.float32)))
    pt, pj = str(tmp_path / "t.pcsl"), str(tmp_path / "j.pcsl")
    assert TREP.save_frames(pt, frames) == JREP._py_save(pj, frames) == len(frames)
    with open(pt, "rb") as a, open(pj, "rb") as b:
        assert a.read() == b.read()
    for got in (TREP.load_frames(pj), JREP.load_frames(pt), list(JREP._py_load(pt))):
        assert len(got) == len(frames)
        for a, b in zip(got, frames):
            assert a.t == b.t
            for f in ("position", "quat_wxyz", "points"):
                assert np.asarray(getattr(a, f)).tobytes() == np.asarray(getattr(b, f)).tobytes()
    with open(pj, "wb") as f:
        f.write(b"NOPE")
    with pytest.raises(IOError):
        TREP.load_frames(pj)


WBT = """#VRML_SIM R2023a utf8
DEF SEG2 Solid {
  translation 0.3 -0.2 1.3
  rotation 0.1294 -0.9659 -0.2241 3.14159
  children [ Shape { geometry Cylinder { height 1.5 radius 0.04 } } ]
}
DEF SEG1 Solid {
  translation 0.14 0.44 1.33
  rotation -0.1197 0.9794 -0.1628 3.04251
  children [ Shape { geometry Cylinder { radius 0.05 } } ]
}
DEF SEG3 Solid {
  translation 1 2 3
}
"""


def _scenes(tmp_path):
    def same(a, b):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert (x.center, x.axis, x.radius, x.height) == (y.center, y.axis, y.radius, y.height)
            assert np.array_equal(x.endpoints(), y.endpoints())
            assert x.as_truth() == y.as_truth()

    for name in ("OBS_TESTS_SCENE", "OBS_DEV_SCENE"):
        same(getattr(TSC, name), getattr(JSC, name))
    for kw in ({}, dict(radius=0.1)):
        same(TSC.mockup_scene(**kw), JSC.mockup_scene(**kw))
    for kw in ({}, dict(levels=2, width=1.0)):
        same(TSC.tower_scene(**kw), JSC.tower_scene(**kw))
    for seed in (0, 3):
        same(TSC.simple_scene(n_beams=4, seed=seed), JSC.simple_scene(n_beams=4, seed=seed))
    assert TSC.scene_truth(TSC.OBS_DEV_SCENE) == JSC.scene_truth(JSC.OBS_DEV_SCENE)
    assert TSC.WP_MOCKUP == JSC.WP_MOCKUP and TSC.WP_TESTS == JSC.WP_TESTS
    for kw in ({}, dict(a=1.8, z=1.7)):
        assert TSC.figure_eight_waypoints(**kw) == JSC.figure_eight_waypoints(**kw)
    for kw in ({}, dict(radius=1.2, z0=0.4, z1=2.2, turns=2.0, n=40)):
        assert TSC.spiral_waypoints(**kw) == JSC.spiral_waypoints(**kw)
    csv = tmp_path / "wp.csv"
    csv.write_text("x,y,z,yaw,duration\n1,0,0.3,3.14,5\n\n1,0,2,3.14,15\n")
    assert TSC.load_waypoints_csv(str(csv)) == JSC.load_waypoints_csv(str(csv))
    csv.write_text("1,0,0.3,3.14,5\n")
    for mod in (TSC, JSC):
        with pytest.raises(ValueError):
            mod.load_waypoints_csv(str(csv))
    wbt = tmp_path / "world.wbt"
    wbt.write_text(WBT)
    got = TSC.parse_wbt_scene(str(wbt))
    assert len(got) == 3 and got[1].height == 1.5 and got[2].radius == 1.0
    same(got, JSC.parse_wbt_scene(str(wbt)))


def _viz_point_helpers():
    rng = np.random.default_rng(10)
    for _ in range(50):
        lens = [int(v) for v in rng.integers(0, 40, rng.integers(1, 8))]
        cap = int(rng.integers(0, 120))
        assert TENG._waterfill_quotas(lens, cap) == JENG._waterfill_quotas(lens, cap)
        chunks = [rng.normal(size=(n, 3)) for n in lens if n]
        for q in range(1, sum(lens) + 1, 7):
            if chunks:
                assert np.array_equal(TENG._tail_points(chunks, q),
                                      JENG._tail_points(chunks, q))


def _eval(tmp_path):
    rng = np.random.default_rng(11)
    truth = JSC.scene_truth(JSC.OBS_TESTS_SCENE)
    proc = []
    for t in truth:
        b = np.asarray(t["b"]) + rng.normal(scale=0.03, size=3)
        proc.append({"a": np.asarray(t["a"]) + rng.normal(scale=0.1, size=3), "b": b,
                     "t_min": -0.9 + rng.normal(scale=0.1), "t_max": 0.9})
    proc += [{"a": rng.normal(size=3), "b": rng.normal(size=3), "t_min": 0.0, "t_max": 1.0}]
    for th in ((0.1, 0.5), (0.05, 0.2)):
        a, b = TEVAL.match_report(truth, proc, *th), JEVAL.match_report(truth, proc, *th)
        assert a.keys() == b.keys()
        assert all(a[k] == b[k] or (a[k] != a[k] and b[k] != b[k]) for k in a)
    path = str(tmp_path / "processing_time.csv")
    recs = [{"wall_time": 1e5 * i, "processing_time": float(rng.uniform(1e4, 9e4)),
             "seg_vec_size": i, "nblines": int(rng.integers(0, 4))} for i in range(20)]
    JCSV.write_processing_time_csv(path, recs)
    dt, dj = TEVAL.load_processing_time_csv(path), JEVAL.load_processing_time_csv(path)
    assert dt.keys() == dj.keys() and all(np.array_equal(dt[k], dj[k]) for k in dt)
    assert TEVAL.summarize(dt) == JEVAL.summarize(dj)


def _server_wire():
    rng = np.random.default_rng(12)
    for n in (0, 1, 777):
        t, pos, quat = float(rng.normal()), rng.normal(size=3), rng.normal(size=4)
        pts = rng.normal(size=(n, 3))
        mt = TSRV.pack_frame(t, pos, quat, pts)
        assert mt == JSRV.pack_frame(t, pos, quat, pts)
        assert TSRV._HDR.unpack(mt[:TSRV._HDR.size]) == (TSRV.MSG_FRAME, len(mt) - TSRV._HDR.size)
        for unpack in (TSRV._unpack_frame, JSRV._unpack_frame):
            t2, pos2, quat2, pts2 = unpack(mt[TSRV._HDR.size:])
            assert t2 == t and np.array_equal(pos2, pos) and np.array_equal(quat2, quat)
            assert np.array_equal(pts2, pts.astype(np.float32))
    assert (TSRV.MSG_FRAME, TSRV.MSG_QUERY, TSRV.MSG_FINAL, TSRV.MSG_SNAP) == (
        JSRV.MSG_FRAME, JSRV.MSG_QUERY, JSRV.MSG_FINAL, JSRV.MSG_SNAP)


def _code_without_imports_and_docstrings(path, renames=()):
    """ast.dump of a module with its imports and every docstring taken out
    (comments are no part of the tree), after the (old, new) text `renames`
    of its source."""
    src = open(path).read()
    for old, new in renames:
        assert old in src, old
        src = src.replace(old, new)
    tree = ast.parse(src)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        body[:] = [n for n in body if not isinstance(n, (ast.Import, ast.ImportFrom))]
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            del body[0]
    return ast.dump(tree)


def _oracle_copy():
    """The oracle's code is the original's but for imports and docstrings,
    and a seeded replay gives the same segments and intersections, value for
    value, with the same accumulated inlier points."""
    for name in ("pipeline.py", "__init__.py"):
        assert _code_without_imports_and_docstrings(
            os.path.join(PORT, "oracle", name)) == _code_without_imports_and_docstrings(
            os.path.join(REPO, JAX_PKG, "oracle", name)), name
    assert TORACLE.__all__ == JORACLE.__all__
    shapes = dict(max_raw_points=4096, max_points=2048, max_world_segments=32)
    kw = dict(granularity=2, surface_offset_correction=True)
    tcfg = TC.default_config(shapes=TC.StaticShapes(**shapes), **kw)
    jcfg = JC.default_config(shapes=JC.StaticShapes(**shapes), **kw)
    poses = TSC.trajectory_poses(TSC.WP_TESTS, hz=1.0, velocity=0.4)[:4]
    frames = TSIM.simulate_trajectory(TSC.OBS_TESTS_SCENE, poses,
                                      TSIM.TofSpec(noise_frac=0.002), seed=4)
    tw, jw = TORACLE.WorldMap(tcfg), JORACLE.WorldMap(jcfg)
    for f in frames:
        tr = TORACLE.process_frame(tw, f.points, f.position, f.quat_wxyz, tcfg)
        jr = JORACLE.process_frame(jw, f.points, f.position, f.quat_wxyz, jcfg)
        assert (tr.nblines, tr.status) == (jr.nblines, jr.status)
    assert len(tw.segments) == len(jw.segments) >= 3
    for a, b in zip(tw.segments, jw.segments):
        for f in dataclasses.fields(a):
            assert np.array_equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert tw.intersections_rows() == jw.intersections_rows()
    assert (TORACLE.pipeline.STATUS_OK, TORACLE.pipeline.STATUS_DEGENERATE,
            TORACLE.pipeline.STATUS_DX_TOO_LARGE, TORACLE.pipeline.STATUS_BX_ZERO) == (0, 1, 2, 3)


def _oracle_geometry():
    rng = np.random.default_rng(13)
    a, b, p = rng.normal(size=(3, 40, 3))
    for name in ("dot3", "find_proj", "point_line_distance"):
        assert np.array_equal(getattr(TOG, name)(a, b, p) if name != "dot3"
                              else TOG.dot3(a, b),
                              getattr(JG, name)(a, b, p) if name != "dot3"
                              else JG.dot3(a, b)), name
    assert np.array_equal(TOG.norm3(a), JG.norm3(a))
    assert np.array_equal(TOG.find_proj(a[0], b[0], p[0]), JG.find_proj(a[0], b[0], p[0]))
    t0, t1 = rng.normal(size=(2, 40))
    for got, want in zip(TOG.segment_endpoints(a, b, t0, t1),
                         JG.segment_endpoints(a, b, t0, t1)):
        assert np.array_equal(got, want)
    for v in list(rng.normal(size=(20, 3))) + [np.array([0.0, -2.0, 1.0]),
                                                np.array([0.0, 0.0, -1.0]), np.zeros(3)]:
        assert np.array_equal(TOG.canonicalize_direction(v), JG.canonicalize_direction(v))
    assert TOG.quat_to_rot is TG.quat_to_rot


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _parity_soak():
    """tools/parity_soak_torch.py draws the JAX soak's configs, scenes and
    flights for the same seeds, and keeps its books the same way."""
    jsoak, tsoak = _load_tool("parity_soak"), _load_tool("parity_soak_torch")
    for mode in ("base", "g6", "sensor128"):
        for f64 in (False, True):
            jsoak.MODE, jsoak.F64 = mode, f64
            for seed in range(3000, 3012):
                rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
                _same_config(tsoak.random_cfg(rt, mode, f64), jsoak.random_cfg(rj))
                assert rt.random() == rj.random()       # as many draws
    jsoak.MODE, jsoak.F64 = "base", False
    cfg, frames = tsoak.random_case(2023)
    assert (cfg.granularity, cfg.radius_sizes, cfg.opt_nlines) == (1, (0.03,), 0)
    assert 4 <= len(frames) < 10 and frames[0].points.shape == (1024, 3)
    batches = [{"n": 4, "counts": {"bx-knife-edge": 1}},
               {"n": 6, "counts": {"real": 2, "bx-knife-edge": 1}}]
    dj = dt = None
    for b in batches:
        dj, dt = jsoak.merge_batch(dj, b), tsoak.merge_batch(dt, b)
    assert dj == dt and dt["totals"]["unexplained"] == 2
    segs = [{"a": np.zeros(3), "b": np.array([1.0, 0, 0]), "t_min": 0.0, "t_max": 1.0,
             "radius": 0.05}]
    moved = [dict(segs[0], a=np.array([0.0, 0.2, 0.0]))]
    assert tsoak.compare_worlds((segs, []), (segs, [])) == []
    assert len(tsoak.compare_worlds((segs, [(1, 0.1, 0, 0.2)]), (moved + moved, []))) == 3
    assert os.path.basename(tsoak.ARTIFACT) == "SOAK_torch.json"


# the program's and the package's name in strings: what a copy of the port may
# change in code that is otherwise the original's
PORT_NAMES = {
    "io/rosbag.py": (('"pcs_torch.rosbag"', '"pcs_tpu.rosbag"'),
                     ("`pcs-torch bag-info`", "`pcs-tpu bag-info`")),
    "io/mcap.py": (('"pcs_torch.mcap"', '"pcs_tpu.mcap"'),
                   ('_mstr("pcs-torch")', '_mstr("pcs-tpu")')),
    "io/ros_bridge.py": (),
    "viz.py": (('"pointcloud_segmentation_tpu_torch"', '"pointcloud_segmentation_tpu"'),
               ('"pointcloud_segmentation_tpu_torch (live)"',
                '"pointcloud_segmentation_tpu (live)"')),
    "_malloc.py": (('"pointcloud_segmentation_tpu_torch"', '"pointcloud_segmentation_tpu"'),),
}


def _sensor_and_display_copies():
    """io/rosbag.py, io/mcap.py, io/ros_bridge.py, viz.py and _malloc.py hold
    the original's code but for imports, docstrings and the program's name;
    the modules they are wired to are the port's own."""
    from pointcloud_segmentation_tpu_torch import _malloc as TMALLOC
    from pointcloud_segmentation_tpu_torch import viz as TVIZ
    from pointcloud_segmentation_tpu_torch.io import mcap as TMCAP
    from pointcloud_segmentation_tpu_torch.io import ros_bridge as TBRIDGE
    from pointcloud_segmentation_tpu_torch.io import rosbag as TBAG

    for rel, renames in PORT_NAMES.items():
        assert _code_without_imports_and_docstrings(
            os.path.join(PORT, rel), renames) == _code_without_imports_and_docstrings(
            os.path.join(REPO, JAX_PKG, rel)), rel
    assert TBAG.Frame is TSIM.Frame and TMCAP.rosbag is TBAG
    assert TBRIDGE.SegmentationEngine is TENG.SegmentationEngine
    for mod in (TBAG, TMCAP, TBRIDGE, TVIZ, TMALLOC):
        assert mod.__name__.startswith("pointcloud_segmentation_tpu_torch.")
    frames = TBAG.bag_to_frames.__globals__
    assert "PoseBuffer" not in frames      # imported in the call, from the port:
    assert TMALLOC._applied is True        # the package import applied the cap
    TMALLOC.cap_malloc_arenas()            # and a second call is a no-op
    assert TENG._cap_malloc_arenas is TMALLOC.cap_malloc_arenas


def _io_exports():
    """io/__init__.py exports the JAX package's names, and the package's
    own names are the JAX package's that exist in the port."""
    import pointcloud_segmentation_tpu as JPKG
    import pointcloud_segmentation_tpu.io as JIO
    import pointcloud_segmentation_tpu_torch as TPKG
    import pointcloud_segmentation_tpu_torch.io as TIO

    assert TIO.__all__ == JIO.__all__
    assert all(getattr(TIO, name) is not None for name in TIO.__all__)
    assert TIO.bag_to_frames.__module__ == "pointcloud_segmentation_tpu_torch.io.rosbag"
    assert set(JPKG.__all__) - set(TPKG.__all__) == {"make_process_frame"}
    assert TPKG.__version__ == JPKG.__version__
    assert TPKG.viz.__name__ == "pointcloud_segmentation_tpu_torch.viz"
    beam = TSC.OBS_TESTS_SCENE[2]
    for kw in (dict(n=50, seed=5), dict(n=64, seed=1, noise=0.01)):
        assert np.array_equal(TSIM.cylinder_surface_cloud(beam, **kw),
                              JSIM.cylinder_surface_cloud(JSC.OBS_TESTS_SCENE[2], **kw))


PARITY = {
    "sensor_and_display_copies": _sensor_and_display_copies, "io_exports": _io_exports,
    "config_default": _config_default, "config_yaml": _config_yaml,
    "config_grid": _config_grid, "hough_space": _hough_space,
    "quat_to_rot": _quat_to_rot, "simulate_trajectory": _simulate_trajectory,
    "pose_buffer_lookup": _pose_buffer, "csv_writers": _csv_writers,
    "intersection_pairs": _intersection_pairs, "mailbox": _mailbox,
    "replay_codec": _replay_codec, "scenes_and_waypoints": _scenes,
    "viz_point_helpers": _viz_point_helpers, "eval": _eval,
    "server_wire": _server_wire, "oracle_copy": _oracle_copy,
    "oracle_geometry": _oracle_geometry, "parity_soak": _parity_soak,
}


def test_the_oracle_backend_loads_no_jax_and_initialises_no_cuda():
    """SegmentationEngine(cfg, backend="oracle") replays frames in a fresh
    interpreter: neither jax nor the JAX package is imported, CUDA stays
    uninitialised and no kernel library is built or loaded."""
    code = (
        "import sys, torch\n"
        "from pointcloud_segmentation_tpu_torch import SegmentationEngine, _build\n"
        "from pointcloud_segmentation_tpu_torch.config import StaticShapes, default_config\n"
        "from pointcloud_segmentation_tpu_torch.io.scene import (OBS_TESTS_SCENE, WP_TESTS,\n"
        "                                                        trajectory_poses)\n"
        "from pointcloud_segmentation_tpu_torch.io.simulator import TofSpec, simulate_trajectory\n"
        "cfg = default_config(granularity=2, shapes=StaticShapes(max_raw_points=4096,\n"
        "                     max_points=2048, max_world_segments=32))\n"
        "poses = trajectory_poses(WP_TESTS, hz=1.0, velocity=0.4)[4:6]\n"
        "frames = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002), seed=0)\n"
        "eng = SegmentationEngine(cfg, backend='oracle')\n"
        "recs = eng.run_replay(frames)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'pointcloud_segmentation_tpu')\n"
        "       or m.startswith(('jax.', 'pointcloud_segmentation_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert not _build._loaded\n"
        "print(len(recs), len(eng.world_segments()))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_recs, n_segs = map(int, out.stdout.split())
    assert n_recs == 2 and n_segs >= 1


@pytest.mark.parametrize("case", sorted(PARITY))
def test_copy_matches_the_original(case, tmp_path):
    fn = PARITY[case]
    fn(tmp_path) if fn.__code__.co_argcount else fn()
