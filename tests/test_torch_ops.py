"""The PyTorch port's geometry, eigh3 and preprocessing vs the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pointcloud_segmentation_tpu import geometry as G
from pointcloud_segmentation_tpu.config import default_config, StaticShapes
from pointcloud_segmentation_tpu.io.scene import OBS_TESTS_SCENE, WP_TESTS, trajectory_poses
from pointcloud_segmentation_tpu.io.simulator import simulate_trajectory, TofSpec
from pointcloud_segmentation_tpu.ops.eigh3 import (
    eigh3 as j_eigh3, eigvalsh3 as j_eigvalsh3,
    principal_eigenvector3 as j_principal_eigenvector3)
from pointcloud_segmentation_tpu.ops.preproc import preprocess as jax_preprocess

from pointcloud_segmentation_tpu_torch.geometry import canonicalize_direction
from pointcloud_segmentation_tpu_torch.ops import eigh3 as TE
from pointcloud_segmentation_tpu_torch.ops.preproc import preprocess, window_mask

torch.set_num_threads(2)


def random_sym(rng, n, scale=1.0):
    A = rng.normal(size=(n, 3, 3)) * scale
    return ((A + np.swapaxes(A, -1, -2)) / 2).astype(np.float32)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 50.0)])
def test_eigh3_matches_jax(seed, scale):
    A = random_sym(np.random.default_rng(seed), 64, scale)
    At, Aj = torch.from_numpy(A), jnp.asarray(A)
    w = TE.eigvalsh3(At).numpy()
    wj = np.asarray(j_eigvalsh3(Aj))
    np.testing.assert_allclose(w, wj, rtol=1e-5, atol=1e-5 * scale)
    lam, v = TE.principal_eigenvector3(At)
    lamj, vj = j_principal_eigenvector3(Aj)
    np.testing.assert_allclose(lam.numpy(), np.asarray(lamj), rtol=1e-5, atol=1e-5 * scale)
    # eigenvectors up to sign, where the top eigenvalue is well separated
    sep = (wj[:, 0] - wj[:, 1]) > 1e-2 * scale
    dots = np.abs((v.numpy() * np.asarray(vj)).sum(-1))
    np.testing.assert_allclose(dots[sep], 1.0, atol=1e-4)
    wf, V = TE.eigh3(At)
    wfj, Vj = j_eigh3(Aj)
    np.testing.assert_allclose(wf.numpy(), np.asarray(wfj), rtol=1e-5, atol=1e-5 * scale)
    assert V.shape == (64, 3, 3)


def test_eigh3_degenerate_isotropic():
    A = torch.eye(3) * 2.5
    np.testing.assert_allclose(TE.eigvalsh3(A).numpy(), 2.5, atol=1e-6)
    lam, v = TE.principal_eigenvector3(A)
    assert torch.isfinite(v).all()


def test_canonicalize_direction_matches_jax():
    rng = np.random.default_rng(3)
    vecs = rng.normal(size=(200, 3)).astype(np.float32)
    vecs[::4, 0] = 0.0
    vecs[::8, 1] = 0.0
    vecs[5] = 0.0
    for v in vecs:
        out = canonicalize_direction(torch.from_numpy(v)).numpy()
        ref = np.asarray(G.canonicalize_direction(jnp.asarray(v)))
        np.testing.assert_array_equal(out, ref)
        nz = np.flatnonzero(out)
        assert len(nz) == 0 or out[nz[0]] > 0            # D-SIGN


def pad_to(pts, n):
    out = np.full((n, 3), np.nan, np.float32)
    out[: len(pts)] = pts
    return out


def test_window_mask():
    pts = torch.tensor([[0.5, 0.0, 0.0], [-0.1, 0.0, 0.0], [1.5, 1.5, -1.5],
                        [1.6, 0.0, 0.0], [float("nan"), 0.0, 0.0],
                        [float("inf"), 0.0, 0.0]])
    assert window_mask(pts, 3.0).tolist() == [True, False, True, False, False, False]


@pytest.mark.parametrize("frame", [0, 3, 7])
def test_preprocess_matches_jax_on_simulated_frames(frame):
    cfg = default_config(shapes=StaticShapes(max_raw_points=4096, max_points=2048))
    poses = trajectory_poses(WP_TESTS, hz=2.0, velocity=0.25)[frame: frame + 1]
    fr = simulate_trajectory(OBS_TESTS_SCENE, poses, TofSpec(noise_frac=0.002),
                             seed=frame)[0]
    raw = pad_to(fr.points, cfg.shapes.max_raw_points)
    out, valid, count = preprocess(torch.from_numpy(raw), cfg)
    oj, vj, cj = jax_preprocess(jnp.asarray(raw), cfg)
    assert int(count) == int(cj) > 100
    np.testing.assert_array_equal(valid.numpy(), np.asarray(vj))
    np.testing.assert_allclose(out.numpy(), np.asarray(oj), atol=1e-6, rtol=0)


def test_preprocess_keeps_pcl_order_and_drops_overflow():
    rng = np.random.default_rng(5)
    cfg = default_config(shapes=StaticShapes(max_raw_points=1024, max_points=64))
    pts = rng.uniform([0.0, -1.0, -1.0], [1.4, 1.0, 1.0], size=(900, 3))
    raw = pad_to(pts, 1024)
    out, valid, count = preprocess(torch.from_numpy(raw), cfg)
    oj, vj, cj = jax_preprocess(jnp.asarray(raw), cfg)
    assert int(count) == int(cj) == 64
    np.testing.assert_allclose(out.numpy(), np.asarray(oj), atol=1e-6, rtol=0)
    ijk = np.floor(out.numpy() / cfg.leaf_size).astype(int)
    keys = list(map(tuple, ijk[:, ::-1]))
    assert keys == sorted(keys)
