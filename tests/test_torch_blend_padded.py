"""K7 and K8, the blend over the padded [T, D, K] layout: the port's plain
versions (ops/blend_padded.py) against the JAX TPU kernels
`blend_fwd_pallas` and `blend_pallas_diff` (Pallas in interpret mode) on
tests/test_blend_pallas.py's inputs (48x32, 80 gaussians, E = 4), the
padded layout against the JAX package's `layout="padded"` binning, and
`rasterize_padded_fwd` against `rasterize_pallas_fwd` on the golden scene.
The CUDA kernels are held against the plain versions in
test_torch_kernel.py."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_blend_pallas import GRID_X, H, TILE, W, build_packed

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "forward.npz")
# tests/test_blend_pallas.py:83-93, by out row
ROW_TOL = [(slice(0, 3), 3e-4, "color"), (slice(3, 4), 3e-3, "depth"),
           (slice(4, 7), 3e-4, "normal"), (slice(7, 8), 3e-3, "median"),
           (slice(8, 9), 3e-3, "distortion"), (slice(9, 10), 2e-5, "final_T")]


def _inputs(seed=0):
    packed, count, args, E = build_packed(np.random.default_rng(seed))
    return np.array(packed), np.asarray(count).astype(np.int32), args, E


def _check_rows(out, jout, E):
    for rows, tol, name in ROW_TOL + [(slice(10, 10 + E), 5e-4, "extras")]:
        np.testing.assert_allclose(out[:, rows], jout[:, rows], atol=tol,
                                   rtol=0, err_msg=name)


def test_plain_k7_matches_blend_fwd_pallas():
    """Out rows within the JAX suite's tolerances, n_contrib exactly."""
    from instascene_tpu.ops.blend_pallas import blend_fwd_pallas
    from instascene_tpu_torch.ops.blend_padded import blend_fwd_padded
    packed, count, _, E = _inputs()
    j = blend_fwd_pallas(jnp.asarray(packed), jnp.asarray(count), TILE,
                         GRID_X, E, interpret=True)
    out, iout = blend_fwd_padded(torch.as_tensor(packed),
                                 torch.as_tensor(count), GRID_X, E)
    _check_rows(out.numpy(), np.asarray(j.out), E)
    np.testing.assert_array_equal(iout.numpy()[:, 0], np.asarray(j.iout)[:, 0])
    assert iout[:, 0].max() > 0


def test_plain_k7_empty_tile_keeps_final_t():
    """A tile with count 0 writes final T = 1 and zero color
    (tests/test_blend_pallas.py:733), as the JAX kernel does."""
    from instascene_tpu.ops.blend_pallas import blend_fwd_pallas
    from instascene_tpu_torch.ops.blend_padded import blend_fwd_padded
    packed, count, _, E = _inputs()
    count[0] = 0
    out, iout = blend_fwd_padded(torch.as_tensor(packed),
                                 torch.as_tensor(count), GRID_X, E)
    j = blend_fwd_pallas(jnp.asarray(packed), jnp.asarray(count), TILE,
                         GRID_X, E, interpret=True)
    assert (out[0, 9] == 1).all() and not out[0, 0:9].any()
    assert not iout[0].any()
    np.testing.assert_allclose(np.asarray(j.out)[0, 9], 1.0)
    _check_rows(out.numpy(), np.asarray(j.out), E)


def test_blend_padded_diff_matches_jax_grad():
    """The loss Σ out·w through pack_inputs and blend_padded_diff (K7/K8)
    against jax.grad through blend_pallas_diff on the same numpy inputs:
    the loss at rtol 1e-4, each input's gradient within 3e-3 of its
    largest |value| (tests/test_blend_pallas.py:156-163)."""
    from instascene_tpu.ops.blend_pallas import (blend_pallas_diff,
                                                 pack_flat_cols)
    from instascene_tpu_torch.ops.blend_padded import (blend_padded_diff,
                                                       pack_inputs)
    from instascene_tpu_torch.ops.blend_visits import (
        pack_flat_cols as tpack)
    packed, count, args, E = _inputs()
    ti = np.asarray(args["tile_indices"])
    T, P2 = packed.shape[0], TILE * TILE
    wout = np.random.default_rng(1).normal(size=(T, 12 + E, P2)).astype(
        np.float32)
    wout[:, 10 + E:] = 0.0
    names = ("packT", "xy", "normal", "opacity", "color", "extra")
    arrs = [np.asarray(args[k])[:-1] for k in names]
    n = arrs[0].shape[0]

    def jloss(packT, xy, normal, opacity, color, extra):
        flat = pack_flat_cols(packT, xy, normal, opacity, color, extra)
        p = jnp.transpose(flat[jnp.asarray(ti)], (0, 2, 1))
        out, _ = blend_pallas_diff(p, jnp.asarray(count), TILE, GRID_X, E,
                                   True)
        return jnp.sum(out * wout), out

    (_, jout), jg = jax.value_and_grad(jloss, argnums=tuple(range(6)),
                                       has_aux=True)(*map(jnp.asarray, arrs))
    ts = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    flat = tpack(ts[0].reshape(n, 3, 3), ts[1], ts[2], ts[3], ts[4], ts[5])
    out, _ = blend_padded_diff(pack_inputs(flat, torch.as_tensor(ti)),
                               torch.as_tensor(count), GRID_X, E)
    (out * torch.as_tensor(wout)).sum().backward()
    # the loss values summed in float64 on both sides: its ~24k signed
    # terms cancel to ~0.08, so a float32 sum's order alone moves it ~3e-3
    w64 = wout.astype(np.float64)
    np.testing.assert_allclose((out.detach().double().numpy() * w64).sum(),
                               (np.asarray(jout, np.float64) * w64).sum(),
                               rtol=1e-4)
    for name, t, g in zip(names, ts, jg):
        g = np.asarray(g).reshape(n, -1)
        scale = np.abs(g).max()
        assert scale > 0, name
        err = np.abs(t.grad.numpy().reshape(n, -1) - g).max() / scale
        assert err < 3e-3, (name, err)


def test_padded_layout_matches_jax_binning():
    """padded_layout of the port's binning equals the JAX package's
    layout="padded" tile_indices and tile_count over the real slots (both
    opacity-aware); K is the largest count rounded up to 128, the rest of
    each row the sentinel N."""
    from instascene_tpu.cameras import Camera
    from instascene_tpu.data.synthetic import look_at
    from instascene_tpu.ops.binning import bin_gaussians as jbin
    from instascene_tpu.ops.preprocess import preprocess_gaussians as jpre
    from instascene_tpu_torch.ops.binning import bin_gaussians, padded_layout
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    rng = np.random.default_rng(3)
    n = 400
    xyz = rng.normal(0, 0.6, (n, 3)).astype(np.float32)
    scales = np.exp(rng.normal(-2.0, 0.5, (n, 2))).astype(np.float32)
    rots = rng.normal(size=(n, 4)).astype(np.float32)
    opac = rng.uniform(0.02, 0.98, n).astype(np.float32)
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.65,
                 image_name="t", width=W, height=H)
    jp = jpre(jnp.asarray(xyz), jnp.asarray(scales), jnp.asarray(rots),
              jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
              jnp.asarray(cam.camera_center), W, H,
              color=jnp.zeros((n, 3)), opacity=jnp.asarray(opac))
    jb = jbin(jp, W, H, pair_cap=16384, tile_cap=1024, layout="padded")
    assert int(jb.n_dropped) == 0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    tp = preprocess_gaussians(f(xyz), f(scales), f(rots), f(cam.w2v),
                              f(cam.full_proj), f(cam.camera_center), W, H,
                              f(opac), color=torch.zeros(n, 3))
    idx, count = padded_layout(bin_gaussians(tp, W, H))
    jc = np.asarray(jb.tile_count)
    np.testing.assert_array_equal(count.numpy(), jc)
    K = idx.shape[1]
    assert K % 128 == 0 and K - 128 < jc.max() <= K
    ji = np.asarray(jb.tile_indices)
    for t_, c in enumerate(jc):
        np.testing.assert_array_equal(idx[t_, :c].numpy(), ji[t_, :c])
        assert (idx[t_, c:] == n).all()


def test_rasterize_padded_fwd_matches_jax_on_goldens():
    """rasterize_padded_fwd (K7's plain version) against
    rasterize_pallas_fwd (interpret mode) on the golden scene: every map
    within the JAX suite's kernel-vs-twin tolerances, color with the
    background; the port bins opacity-aware rects (the JAX entry
    opacity-blind ones), so its n_contrib is compared with the goldens',
    which the port's rasterize matches exactly."""
    from instascene_tpu.cameras import Camera
    from instascene_tpu.data.synthetic import look_at
    from instascene_tpu.ops.rasterize_pallas import rasterize_pallas_fwd
    from instascene_tpu_torch.ops.rasterize import CameraMats
    from instascene_tpu_torch.ops.rasterize_padded import (
        rasterize_padded_fwd)
    g = np.load(GOLDEN)
    gw, gh, e = int(g["W"]), int(g["H"]), g["inputs_extra"].shape[1]
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.65,
                 image_name="g", width=gw, height=gh)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    keys = ("xyz", "scales", "rots", "opac", "color", "extra")
    inp = [np.asarray(g[f"inputs_{k}"], np.float32) for k in keys]
    jm, jr, jv, jd, jn = rasterize_pallas_fwd(
        *map(jnp.asarray, inp[:4]), jnp.asarray(cam.w2v),
        jnp.asarray(cam.full_proj), jnp.asarray(cam.camera_center),
        jnp.asarray(bg), jnp.asarray(inp[4]), None, jnp.asarray(inp[5]),
        None, gw, gh, 0, n_extra=e, interpret=True)
    assert int(jn) == 0
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    maps, radii, vis, depth, nd = rasterize_padded_fwd(
        *map(f, inp[:4]), CameraMats(f(cam.w2v), f(cam.full_proj),
                                     f(cam.camera_center)), bg, gw, gh,
        colors=f(inp[4]), extras=f(inp[5]))
    assert nd == 0
    for key, tol in (("color", 3e-4), ("depth", 3e-3), ("normal", 3e-4),
                     ("median_depth", 3e-3), ("distortion", 3e-3),
                     ("final_T", 2e-5), ("extra", 5e-4)):
        np.testing.assert_allclose(maps[key].numpy(), np.asarray(jm[key]),
                                   atol=tol, rtol=0, err_msg=key)
    np.testing.assert_array_equal(maps["n_contrib"].numpy(), g["n_contrib"])
    np.testing.assert_array_equal(radii.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(depth.numpy(), np.asarray(jd))


@pytest.mark.parametrize("kernel", ["fwd", "bwd"])
def test_padded_wrappers_refuse_what_the_kernels_do_not_take(kernel,
                                                              monkeypatch):
    """The widths the kernels take are 0..the device's limit (a wider E
    raises and names the limit; here a device whose limit is 300, the
    limit itself is asked of the card in test_torch_kernel.py); the plain
    versions take any."""
    from instascene_tpu_torch.ops import blend_padded as bp
    from instascene_tpu_torch.ops import blend_visits as bv
    monkeypatch.setattr(bv, "width_limit", lambda dev: 300)
    count = torch.zeros(2, dtype=torch.int32)
    bp._check(f"blend_{kernel}_padded", torch.zeros((2, 21 + 300, 128)),
              count, 300)
    with pytest.raises(ValueError, match="E <= 300"):
        bp._check(f"blend_{kernel}_padded", torch.zeros((2, 21 + 301, 128)),
                  count, 301)
    with pytest.raises(ValueError, match="K % 128"):
        bp._check("blend_fwd_padded", torch.zeros((2, 25, 100)), count, 4)
