"""The port's camera paths (viewer/render_paths.py) against the JAX
package's on the 12-camera ring of tests/test_viewer_extras.py:14-60: the
same numpy code, allclose at 1e-12."""

import numpy as np
import pytest

TOL = 1e-12


def _ring(n=12, z=1.0, tilt=0.0):
    from instascene_tpu.data.synthetic import look_at
    poses = []
    for i in range(n):
        ang = 2 * np.pi * i / n
        pos = np.array([3 * np.cos(ang), 3 * np.sin(ang), z])
        R_w2c, _ = look_at(pos, np.array([0.0, 0.0, tilt]))
        c2w = np.eye(4)
        c2w[:3, :3] = R_w2c.T
        c2w[:3, 3] = pos
        poses.append(c2w[:3])
    return np.stack(poses)


RINGS = {"ring": dict(), "low_tilted": dict(z=-0.5, tilt=0.4)}


@pytest.mark.parametrize("ring", list(RINGS))
def test_pose_functions_match_jax(ring):
    from instascene_tpu.viewer import render_paths as J
    from instascene_tpu_torch.viewer import render_paths as T
    poses = _ring(**RINGS[ring])
    np.testing.assert_allclose(T.focus_point_fn(poses),
                               J.focus_point_fn(poses), atol=TOL, rtol=0)
    for a, b in zip(T.transform_poses_pca(poses),
                    J.transform_poses_pca(poses)):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=0)
    np.testing.assert_allclose(T.pad_poses(poses), J.pad_poses(poses),
                               atol=TOL, rtol=0)
    for kw in (dict(n_frames=24), dict(n_frames=7, z_variation=0.5,
                                       z_phase=0.25)):
        np.testing.assert_allclose(T.generate_ellipse_path(poses, **kw),
                                   J.generate_ellipse_path(poses, **kw),
                                   atol=TOL, rtol=0)
    if ring == "ring":
        # the JAX test's own checks (tests/test_viewer_extras.py:55-60)
        assert np.allclose(T.focus_point_fn(poses), 0.0, atol=1e-8)
        rec, tr = T.transform_poses_pca(poses)
        assert np.abs(rec[:, :3, 3]).max() <= 1.0 + 1e-9
        assert np.allclose(rec, (tr @ T.pad_poses(poses))[:, :3], atol=1e-9)
        assert rec[:, :3, 1].mean(axis=0)[2] > 0


def test_path_to_minicams_matches_jax():
    from instascene_tpu.viewer import render_paths as J
    from instascene_tpu_torch.viewer import render_paths as T
    path = J.generate_ellipse_path(_ring(), n_frames=24)
    tc = T.path_to_minicams(path, 64, 48, 0.9, 0.7)
    jc = J.path_to_minicams(path, 64, 48, 0.9, 0.7)
    assert len(tc) == len(jc) == 24
    for a, b in zip(tc, jc):
        assert (a.width, a.height, a.fovx, a.fovy) == (b.width, b.height,
                                                       b.fovx, b.fovy)
        for k in ("w2v", "full_proj", "camera_center"):
            np.testing.assert_allclose(getattr(a, k), getattr(b, k),
                                       atol=TOL, rtol=0)
        assert np.isfinite(a.full_proj).all()
