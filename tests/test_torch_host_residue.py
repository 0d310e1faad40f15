"""The port's host residue against the JAX package on the same numpy inputs:
the L2, cosine and smoothness losses, build_rotation_np, SH2RGB and
eval_sh_np, the SH rotation helpers, the colour maps (against
matplotlib too) and render_net_image, and the native points3D.bin parser."""

import io
import struct

import numpy as np
import pytest
import torch

import jax.numpy as jnp


@pytest.fixture
def rng():
    return np.random.default_rng(7)


# ---------------------------------------------------------------- losses

@pytest.mark.parametrize("name", ["l2_loss", "cos_loss"])
def test_pointwise_losses_match(rng, name):
    import instascene_tpu.losses as J
    import instascene_tpu_torch.losses as P
    a = rng.normal(size=(12, 9, 3)).astype(np.float32)
    b = rng.normal(size=(12, 9, 3)).astype(np.float32)
    got = float(getattr(P, name)(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(getattr(J, name)(jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-6, (got, want)


@pytest.mark.parametrize("disp_shape", [(14, 11), (14, 11, 1)])
def test_smooth_loss_matches(rng, disp_shape):
    from instascene_tpu.losses import smooth_loss as jax_smooth
    from instascene_tpu_torch.losses import smooth_loss
    disp = rng.random(disp_shape).astype(np.float32)
    img = rng.random((14, 11, 3)).astype(np.float32)
    got = float(smooth_loss(torch.as_tensor(disp), torch.as_tensor(img)))
    want = float(jax_smooth(jnp.asarray(disp), jnp.asarray(img)))
    assert abs(got - want) <= 1e-6, (got, want)


# ------------------------------------------------------- rotations, SH

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_build_rotation_np_bitwise(rng, dtype):
    from instascene_tpu.utils.general import build_rotation_np as J
    from instascene_tpu_torch.utils.general import build_rotation_np as P
    q = rng.normal(size=(40, 4)).astype(dtype)
    q[0] = 0.0
    got, want = P(q), J(q)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_np_and_sh2rgb_bitwise(rng, deg):
    from instascene_tpu.ops.sh import SH2RGB as JS, eval_sh_np as J
    from instascene_tpu_torch.ops.sh import SH2RGB as PS, eval_sh_np as P
    sh = rng.normal(size=(30, 16, 3))
    d = rng.normal(size=(30, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert np.array_equal(P(deg, sh, d), J(deg, sh, d))
    assert np.array_equal(PS(sh[:, 0]), JS(sh[:, 0]))


@pytest.mark.parametrize("degrees", [(33.0, -71.0, 12.0), (25.0, -40.0, 65.0),
                                     (180.0, 0.0, 0.0)])
def test_sh_rotation_matches(rng, degrees):
    import instascene_tpu.utils.sh_rotation as J
    import instascene_tpu_torch.utils.sh_rotation as P
    R = P.euler_deg_to_rotmat(degrees)
    np.testing.assert_allclose(R, J.euler_deg_to_rotmat(degrees), atol=1e-12,
                               rtol=0)
    bp, bj = P.sh_rotation_blocks(R), J.sh_rotation_blocks(R)
    for l in (1, 2, 3):
        np.testing.assert_allclose(bp[l], bj[l], atol=1e-12, rtol=0)
    rest = rng.normal(size=(20, 15, 3)).astype(np.float32)
    got = P.rotate_sh_rest(rest, R)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, J.rotate_sh_rest(rest, R), atol=1e-12,
                               rtol=0)
    q = rng.normal(size=(20, 4))
    np.testing.assert_allclose(P.rotmat_to_quat(R), J.rotmat_to_quat(R),
                               atol=1e-12, rtol=0)
    np.testing.assert_allclose(
        P.compose_quaternion(P.rotmat_to_quat(R), q),
        J.compose_quaternion(J.rotmat_to_quat(R), q), atol=1e-12, rtol=0)


def test_sh_rotation_equivariance_on_port(rng):
    """tests/test_data_layer.py::test_sh_rotation_equivariance on the
    port: eval_sh(rotate(c), R·d) == eval_sh(c, d), and
    rotmat(q_R ⊗ q) == R @ rotmat(q)."""
    from instascene_tpu_torch.ops.sh import eval_sh_np
    from instascene_tpu_torch.utils.general import build_rotation_np
    from instascene_tpu_torch.utils.sh_rotation import (compose_quaternion,
                                                        euler_deg_to_rotmat,
                                                        rotate_sh_rest,
                                                        rotmat_to_quat)
    R = euler_deg_to_rotmat([33.0, -71.0, 12.0])
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)
    sh = rng.standard_normal((50, 16, 3))
    sh_rot = sh.copy()
    sh_rot[:, 1:] = rotate_sh_rest(sh[:, 1:], R)
    d = rng.standard_normal((50, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert np.abs(eval_sh_np(3, sh, d)
                  - eval_sh_np(3, sh_rot, d @ R.T)).max() < 1e-10
    q = rng.standard_normal((50, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = compose_quaternion(rotmat_to_quat(R), q)
    err = np.abs(build_rotation_np(q2) - np.einsum(
        "ij,njk->nik", R, build_rotation_np(q))).max()
    assert err < 1e-12


# ---------------------------------------------------------------- colours

def test_turbo_table_is_matplotlibs():
    import matplotlib.pyplot as plt
    from instascene_tpu_torch.utils.colormaps import TURBO
    cm = plt.get_cmap("turbo")
    cm._init()
    assert cm.N == len(TURBO)
    assert np.array_equal(cm._lut[:-3, :3], TURBO)


@pytest.mark.parametrize("n", [2, 3, 5, 17, 41, 256, 1000])
def test_hsv_table_is_matplotlibs(n):
    import matplotlib.pyplot as plt
    from instascene_tpu_torch.utils.colormaps import hsv_lut
    cm = plt.get_cmap("hsv", n)
    cm._init()
    assert np.array_equal(cm._lut[:-3, :3], hsv_lut(n))


def test_colormap_bitwise(rng):
    import matplotlib.pyplot as plt
    from instascene_tpu.utils.image import colormap as jax_colormap
    from instascene_tpu_torch.utils.image import colormap
    x = (rng.random((23, 31)) * 1.4 - 0.2).astype(np.float32)
    x[0, :4] = [0.0, 1.0, 0.5, 255.5 / 256]
    got = colormap(x)
    assert got.dtype == np.float32 and got.shape == (23, 31, 3)
    assert np.array_equal(got, jax_colormap(x))
    want = plt.get_cmap("turbo")(np.clip(x, 0, 1))[..., :3].astype(np.float32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype,top", [(np.uint8, 1), (np.uint8, 7),
                                       (np.uint16, 300), (np.int32, 40),
                                       (np.int64, 70_000), (np.float64, 9)])
def test_mask_to_rgb_bitwise(rng, dtype, top):
    import matplotlib.colors as mcolors
    import matplotlib.pyplot as plt
    from instascene_tpu.utils.image import mask_to_rgb as jax_mask_to_rgb
    from instascene_tpu_torch.utils.image import mask_to_rgb
    mask = rng.integers(0, top + 1, (19, 24)).astype(dtype)
    mask[0, 0] = top
    got = mask_to_rgb(mask)
    assert got.dtype == np.uint8 and got.shape == (19, 24, 3)
    assert np.array_equal(got, jax_mask_to_rgb(mask))
    num = int(mask.max()) + 1
    want = np.uint8(plt.get_cmap("hsv", max(num, 2))(mcolors.Normalize(
        vmin=0, vmax=max(num - 1, 1))(mask))[..., :3] * 255.0)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("mode", ["RGB", "Alpha", "Normal", "Depth", "Edge",
                                  "Curvature", 0, 3])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_render_net_image_matches(rng, mode, as_tensor):
    """Every mode of tests/test_viewer_extras.py::test_render_net_image_modes
    (by name and by index into render_items), from numpy arrays and from
    tensors."""
    from instascene_tpu.utils.image import render_net_image as J
    from instascene_tpu_torch.utils.image import render_net_image as P
    h, w = 16, 24
    pkg = {"render": rng.random((h, w, 3)).astype(np.float32) * 1.2 - 0.1,
           "rend_alpha": rng.random((h, w, 1)).astype(np.float32),
           "rend_normal": rng.random((h, w, 3)).astype(np.float32) * 2 - 1,
           "surf_depth": rng.random((h, w, 1)).astype(np.float32) * 3}
    items = ["RGB", "Alpha", "Normal", "Depth", "Edge", "Curvature"]
    want = J(pkg, items, mode, None)
    tpkg = ({k: torch.as_tensor(v) for k, v in pkg.items()} if as_tensor
            else pkg)
    got = P(tpkg, items, mode, None)
    assert got.shape == (h, w, 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------- native

def _points3d_bytes(rng, n=200):
    buf = io.BytesIO()
    buf.write(struct.pack("<Q", n))
    for i in range(n):
        tl = int(rng.integers(0, 6))
        buf.write(struct.pack("<Q3d3Bd", i, *rng.normal(size=3),
                              *rng.integers(0, 256, 3), rng.random()))
        buf.write(struct.pack("<Q", tl))
        buf.write(rng.integers(0, 2 ** 31, 2 * tl).astype(
            np.int32).tobytes())
    return buf.getvalue()


def test_native_parse_matches(rng, tmp_path):
    """The port's library (native/colmap_io.cpp built into its own build
    dir) parses like the JAX package's library, a struct walk and the
    port's Python parse; the port's reader returns the same arrays as the
    JAX reader."""
    from instascene_tpu.data import colmap as jcolmap
    from instascene_tpu.data.native import points3d_parse_native as jnative
    from instascene_tpu_torch.data import colmap
    from instascene_tpu_torch.data.native import (get_lib,
                                                  points3d_parse_native)
    data = _points3d_bytes(rng)
    assert get_lib() is not None
    got = points3d_parse_native(data)
    want = jnative(data)
    assert got is not None and want is not None
    f = io.BytesIO(data)
    num = struct.unpack("<Q", f.read(8))[0]
    walked = []
    for _ in range(num):
        vals = struct.unpack("<QdddBBBd", f.read(43))
        walked.append(vals)
        f.read(8 * struct.unpack("<Q", f.read(8))[0])
    walked = np.array(walked, dtype=object)
    py = (walked[:, 1:4].astype(np.float64), walked[:, 4:7].astype(np.uint8),
          walked[:, 7:8].astype(np.float64))
    for a, b, c, d in zip(got, want, py, colmap.parse_points3D(data)):
        assert a.dtype == b.dtype == c.dtype == d.dtype
        assert (np.array_equal(a, b) and np.array_equal(a, c)
                and np.array_equal(a, d))
    path = tmp_path / "points3D.bin"
    path.write_bytes(data)
    for a, b in zip(colmap.read_points3D_binary(str(path)),
                    jcolmap.read_points3D_binary(str(path))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("case", ["truncated", "hostile_track",
                                  "hostile_count", "short"])
def test_native_parse_rejects_malformed(rng, case):
    """A malformed buffer parses to None in both packages
    (tests/test_data_layer.py:259,278)."""
    from instascene_tpu.data.native import points3d_parse_native as jnative
    from instascene_tpu_torch.data.native import points3d_parse_native
    if case == "truncated":
        data = _points3d_bytes(rng, 20)[:-5]
    elif case == "hostile_track":
        data = (struct.pack("<Q", 2)
                + struct.pack("<Q3d3Bd", 1, 0.0, 0.0, 0.0, 0, 0, 0, 0.1)
                + struct.pack("<Q", 0xFFFFFFFFFFFFFFF0) + b"\x00" * 64)
    elif case == "hostile_count":
        data = struct.pack("<Q", 2 ** 40) + _points3d_bytes(rng, 3)[8:]
    else:
        data = b"\x01\x00"
    assert points3d_parse_native(data) is None
    if case != "hostile_count":       # the JAX loader would allocate 2^40
        assert jnative(data) is None
