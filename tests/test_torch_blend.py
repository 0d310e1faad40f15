"""K1, the forward blend: the port's plain version (blend_fwd_reference)
against the JAX TPU kernel (blend_visits_diff / blend_visits_viewer, Pallas
in interpret mode) on identical packed rows. The CUDA kernel is held
against the plain version in test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

W, H = 64, 48
GRID_X = W // 16
NUM_TILES = GRID_X * (H // 16)
PAIR_CAP = 2048
# the JAX suite's tolerances between its own blends: rows of out[T, 12+E, 256]
TOL = {"color": (slice(0, 3), 3e-4), "depth": (slice(3, 4), 3e-3),
       "normal": (slice(4, 7), 3e-4), "median": (slice(7, 8), 3e-3),
       "distortion": (slice(8, 9), 3e-3), "final_T": (slice(9, 10), 2e-5)}


def _inputs(E):
    """JAX preprocess + visit binning + pack of a small SH-3 scene."""
    from instascene_tpu.ops.binning import bin_gaussians
    from instascene_tpu.ops.blend_pallas import pack_flat_cols
    from instascene_tpu.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    st, mk = make_bench_scene(n=300, seed=4, profile="trained")
    cam = mk(2, W, H)
    rng = np.random.default_rng(4)
    shs = np.concatenate([st["features_dc"], rng.normal(
        0, 0.2, (300, 15, 3)).astype(np.float32)], axis=1)
    opac = jnp.asarray(1 / (1 + np.exp(-st["opacity"][:, 0])))
    pre = preprocess_gaussians(
        jnp.asarray(st["xyz"]), jnp.exp(jnp.asarray(st["scaling"])),
        jnp.asarray(st["rotation"]), jnp.asarray(cam.w2v),
        jnp.asarray(cam.full_proj), jnp.asarray(cam.camera_center), W, H,
        shs=jnp.asarray(shs), sh_degree=3, opacity=opac)
    b = bin_gaussians(pre, W, H, PAIR_CAP, 256, layout="visits")
    assert int(b.n_dropped) == 0
    extras = None
    if E:
        f = st["seg_feature"]
        extras = jnp.asarray(f / np.linalg.norm(f, axis=1, keepdims=True))
    flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                          extras)
    v = b.visits
    bundle = (b.sorted_gid, v.visit_chunk, v.visit_tile, v.visit_s0,
              v.visit_s1, v.visit_tstart)
    total = int(b.total_pairs)
    start = np.asarray(b.tile_start).astype(np.int32)
    end = start + np.asarray(b.tile_count).astype(np.int32)
    port = (torch.as_tensor(np.array(flat)[:-1]),
            torch.as_tensor(np.asarray(b.sorted_gid)[:total].astype(np.int32)),
            torch.as_tensor(start), torch.as_tensor(end))
    return flat, bundle, port


@pytest.mark.parametrize("E,viewer", [(16, False), (0, False), (16, True)],
                         ids=["full-E16", "full-E0", "viewer-E16"])
def test_plain_k1_matches_tpu_kernel(E, viewer):
    from instascene_tpu.ops.blend_visits import (blend_visits_diff,
                                                 blend_visits_viewer)
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    flat, bundle, port = _inputs(E)
    if viewer:
        jout, jiout = blend_visits_viewer(flat, bundle, NUM_TILES, 16, GRID_X,
                                          E, True)
    else:
        jout, jiout = blend_visits_diff(flat, bundle, None, NUM_TILES, 16,
                                        GRID_X, E, True)
    jout, jiout = np.asarray(jout), np.asarray(jiout)
    out, iout = blend_fwd_reference(*port, GRID_X, E, viewer=viewer)
    out, iout = out.numpy(), iout.numpy()
    assert out.shape == jout.shape and iout.shape == jiout.shape
    np.testing.assert_array_equal(iout[:, 0], jiout[:, 0])   # n_contrib
    assert jiout[:, 0].max() > 0
    groups = dict(TOL)
    if E:
        groups["features"] = (slice(10, 10 + E), 5e-4)
    if viewer:
        for k in ("depth", "normal", "median", "distortion"):
            del groups[k]
        # rows the viewer mode leaves alone are exact zeros, as in K1
        for r in (3, 4, 5, 6, 7, 8, 10 + E, 11 + E):
            assert not out[:, r].any() and not jout[:, r].any(), r
        assert not iout[:, 1].any()
    else:
        np.testing.assert_array_equal(iout[:, 1], jiout[:, 1])  # med_slot
        groups["m1m2"] = (slice(10 + E, 12 + E), 3e-3)
    for name, (rows, tol) in groups.items():
        np.testing.assert_allclose(out[:, rows], jout[:, rows], atol=tol,
                                   rtol=0, err_msg=name)


def test_empty_tiles_and_cpu_dispatch():
    """Empty tiles give final_T = 1 and zeros; a CPU tensor runs the plain
    version and launches nothing."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops.blend_visits import (blend_fwd,
                                                       blend_fwd_reference)
    _, _, (flat, gid, start, end) = _inputs(16)
    start = start.clone()
    end = end.clone()
    end[0] = start[0]                       # empty the first tile
    before = dict(LAUNCHES)
    out, iout = blend_fwd(flat, gid, start, end, GRID_X, 16)
    assert LAUNCHES == before
    ref, iref = blend_fwd_reference(flat, gid, start, end, GRID_X, 16)
    assert torch.equal(out, ref) and torch.equal(iout, iref)
    assert torch.all(out[0, 9] == 1.0)
    assert not out[0, :9].any() and not out[0, 10:].any()
    assert not iout[0].any()


def test_grad_request_raises():
    from instascene_tpu_torch.ops.blend_visits import blend_fwd
    _, _, (flat, gid, start, end) = _inputs(0)
    flat = flat.clone().requires_grad_(True)
    # the forward kernel alone has no gradient: blend() (BlendFunction) has
    with pytest.raises(ValueError, match=r"blend\(\)"):
        blend_fwd(flat, gid, start, end, GRID_X, 0)
    with torch.no_grad():
        blend_fwd(flat, gid, start, end, GRID_X, 0)

