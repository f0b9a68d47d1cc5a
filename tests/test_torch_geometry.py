"""The port's geometry against acezero_tpu.geometry on the same inputs (f32)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from acezero_tpu import geometry as jg
from acezero_tpu_torch import geometry as tg

ATOL = 1e-5


def _rots(n, seed):
    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def _cmp(t_out, j_out, atol=ATOL):
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "name",
    ["matrix_to_quat_wxyz", "matrix_to_rodrigues", "rotation_angle", "special_gramschmidt"],
)
def test_matrix_functions(name):
    m = _rots(64, 1)
    m[:4] = np.eye(3, dtype=np.float32)  # zero-angle branch
    _cmp(getattr(tg, name)(torch.from_numpy(m)), getattr(jg.rotations, name)(jnp.asarray(m)))


def test_special_procrustes(rng):
    m = (_rots(32, 4) + rng.normal(size=(32, 3, 3)) * 0.1).astype(np.float32)
    m[:4] = -m[:4]  # reflections project to det +1 too
    got = tg.special_procrustes(torch.from_numpy(m))
    _cmp(got, jg.rotations.special_procrustes(jnp.asarray(m)), atol=1e-4)
    np.testing.assert_allclose(torch.linalg.det(got).numpy(), 1.0, atol=1e-5)


def test_quat_and_rodrigues_to_matrix(rng):
    q = rng.normal(size=(64, 4)).astype(np.float32)
    _cmp(tg.quat_wxyz_to_matrix(torch.from_numpy(q)), jg.quat_wxyz_to_matrix(jnp.asarray(q)))
    r = rng.normal(size=(64, 3)).astype(np.float32)
    r[:4] *= 1e-6  # Taylor branch
    _cmp(tg.rodrigues_to_matrix(torch.from_numpy(r)), jg.rodrigues_to_matrix(jnp.asarray(r)))


def test_transforms(rng):
    R = _rots(16, 2)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    T_t = tg.make_se3(torch.from_numpy(R), torch.from_numpy(t))
    T_j = jg.make_se3(jnp.asarray(R), jnp.asarray(t))
    _cmp(T_t, T_j)
    _cmp(tg.invert_se3(T_t), jg.invert_se3(T_j))
    _cmp(tg.compose_se3(T_t, tg.invert_se3(T_t)), jg.compose_se3(T_j, jg.invert_se3(T_j)))
    x = rng.normal(size=(5, 3)).astype(np.float32)
    _cmp(tg.to_homogeneous(torch.from_numpy(x)), jg.transforms.to_homogeneous(jnp.asarray(x)))


def test_projection(rng):
    _cmp(tg.get_pixel_grid(6, 10), jg.get_pixel_grid(6, 10))
    _cmp(tg.make_intrinsics(500.0, 320.0, 240.0), jg.make_intrinsics(500.0, 320.0, 240.0))
    pts = (rng.normal(size=(7, 11, 3)) + [0, 0, 4]).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rots(1, 3)[0]
    pose[:3, 3] = [0.1, -0.2, 0.3]
    K = np.array(jg.make_intrinsics(500.0, 320.0, 240.0))
    px_t, d_t = tg.project_points(torch.from_numpy(pts), torch.from_numpy(pose), torch.from_numpy(K))
    px_j, d_j = jg.project_points(jnp.asarray(pts), jnp.asarray(pose), jnp.asarray(K))
    _cmp(px_t, px_j, atol=2e-3)  # pixels of magnitude ~1e3: f32 relative ~1e-6
    _cmp(d_t, d_j)

    depth = rng.uniform(0.5, 5.0, size=(6, 10)).astype(np.float32)
    depth[0, :3] = 0.0
    depth[1, 0] = 2000.0
    grid = np.array(jg.get_pixel_grid(6, 10))
    got = tg.backproject_depth(torch.from_numpy(depth), 500.0, 40.0, 24.0, torch.from_numpy(pose),
                               torch.from_numpy(grid))
    want = jg.backproject_depth(jnp.asarray(depth), 500.0, 40.0, 24.0, jnp.asarray(pose), jnp.asarray(grid))
    _cmp(got, want)
