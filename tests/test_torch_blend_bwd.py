"""K1's no_dist mode and K2, the backward blend: the port's plain versions
against the JAX TPU kernels (blend_visits_diff, Pallas in interpret mode)
on identical packed rows, and the per-gaussian reduction. The CUDA kernels
are held against the plain versions in test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_blend import GRID_X, H, NUM_TILES, PAIR_CAP, TOL, W

# packed column groups of flat [N, 21+E] (blend_pallas.pack_flat_cols)
GROUPS = {"A": slice(0, 3), "B": slice(3, 6), "C": slice(6, 9),
          "Tw": slice(9, 12), "xy": slice(12, 14), "normal": slice(14, 17),
          "opacity": slice(17, 18), "color": slice(18, 21)}


def _inputs(E, n=300, seed=4, boost=12.0):
    """JAX preprocess + visit binning + pack of a small SH-3 scene whose
    surfels are `boost` times the benchmark profile's, so that both the
    ray-splat (3D) and the screen-filter (2D) branches take part and some
    pixels latch done. Returns (JAX flat with its sentinel row, the visit
    bundle, the port's (flat, sorted_gid, tile_start, tile_end))."""
    from instascene_tpu.ops.binning import bin_gaussians
    from instascene_tpu.ops.blend_pallas import pack_flat_cols
    from instascene_tpu.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    st, mk = make_bench_scene(n=n, seed=seed, profile="trained")
    cam = mk(2, W, H)
    rng = np.random.default_rng(seed)
    shs = np.concatenate([st["features_dc"], rng.normal(
        0, 0.2, (n, 15, 3)).astype(np.float32)], axis=1)
    opac = jnp.asarray(1 / (1 + np.exp(-st["opacity"][:, 0])))
    pre = preprocess_gaussians(
        jnp.asarray(st["xyz"]),
        jnp.exp(jnp.asarray(st["scaling"])) * boost,
        jnp.asarray(st["rotation"]), jnp.asarray(cam.w2v),
        jnp.asarray(cam.full_proj), jnp.asarray(cam.camera_center), W, H,
        shs=jnp.asarray(shs), sh_degree=3, opacity=opac)
    b = bin_gaussians(pre, W, H, PAIR_CAP * 4, 1024, layout="visits")
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


def _runs(gid, n):
    """(gid_order, run_start) of JAX's pair list, as the port's binning
    gives them for its own: each gaussian's slots, ascending."""
    g = gid.numpy()
    run_start = np.zeros(n + 1, np.int32)
    run_start[1:] = np.cumsum(np.bincount(g, minlength=n))
    return (torch.as_tensor(np.argsort(g, kind="stable").astype(np.int32)),
            torch.as_tensor(run_start))


def test_plain_k1_no_dist_matches_tpu_kernel():
    """no_dist: rows 3, 8, 10+E, 11+E exact zeros in both; every other row
    and iout as JAX's no_dist kernel gives them, at the slice-1 tolerances,
    and equal to the port's own `full` mode."""
    from instascene_tpu.ops.blend_visits import blend_visits_diff
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    E = 0
    flat, bundle, port = _inputs(E)
    jout, jiout = blend_visits_diff(flat, bundle, None, NUM_TILES, 16, GRID_X,
                                    E, True, no_dist=True)
    jout, jiout = np.asarray(jout), np.asarray(jiout)
    out, iout = blend_fwd_reference(*port, GRID_X, E, no_dist=True)
    full, ifull = blend_fwd_reference(*port, GRID_X, E)
    out, iout = out.numpy(), iout.numpy()
    np.testing.assert_array_equal(iout, jiout)
    np.testing.assert_array_equal(iout, ifull.numpy())
    assert jiout[:, 0].max() > 0
    zero = [3, 8, 10 + E, 11 + E]
    assert not out[:, zero].any() and not jout[:, zero].any()
    for name in ("color", "normal", "median", "final_T"):
        rows, tol = TOL[name]
        np.testing.assert_allclose(out[:, rows], jout[:, rows], atol=tol,
                                   rtol=0, err_msg=name)
    keep = [r for r in range(12 + E) if r not in zero]
    np.testing.assert_array_equal(out[:, keep], full.numpy()[:, keep])


@pytest.mark.parametrize("E,no_dist", [(0, False), (16, False), (0, True),
                                       (16, True)],
                         ids=["full-E0", "full-E16", "no_dist-E0",
                              "no_dist-E16"])
def test_plain_k2_matches_tpu_kernel(E, no_dist):
    """d_flat through the port's BlendFunction (plain path) against
    jax.grad through blend_visits_diff (K2 in interpret mode) of one random
    Σ out·wout, per packed column group within 3e-3 (`full`) / 5e-3
    (`no_dist`) of the group's largest |gradient| — the JAX suite's own
    tolerances between its backends (T is recovered per slot here, per
    128-slot visit there)."""
    from instascene_tpu.ops.blend_visits import blend_visits_diff
    from instascene_tpu_torch.ops.blend_visits import blend
    flat, bundle, port = _inputs(E)
    rng = np.random.default_rng(11 + E)
    wout = rng.normal(size=(NUM_TILES, 12 + E, 256)).astype(np.float32)

    def loss(fl):
        out, _ = blend_visits_diff(fl, bundle, None, NUM_TILES, 16, GRID_X,
                                   E, True, no_dist=no_dist)
        return jnp.sum(out * wout)

    jg = np.asarray(jax.grad(loss)(flat))[:-1]       # drop the sentinel row
    fl = port[0].clone().requires_grad_(True)
    out, _ = blend(fl, *port[1:], GRID_X, E, _runs(port[1], fl.shape[0]),
                   no_dist=no_dist)
    (out * torch.as_tensor(wout)).sum().backward()
    g = fl.grad.numpy()
    assert g.shape == jg.shape and np.isfinite(g).all()
    tol = 5e-3 if no_dist else 3e-3
    groups = dict(GROUPS)
    if E:
        groups["features"] = slice(21, 21 + E)
    for name, cols in groups.items():
        scale = np.abs(jg[:, cols]).max()
        assert scale > 0, name
        err = np.abs(g[:, cols] - jg[:, cols]).max()
        assert err <= tol * scale, (name, err, scale)


def test_reduction_and_counts():
    """reduce_per_gaussian sums each gaussian's slots (the sentinel-free
    index_add_ of JAX's VJP); the plain path launches no kernel; the
    backward's work count matches what n_contrib says."""
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, blend_bwd, blend_bwd_reference, blend_fwd_reference,
        reduce_per_gaussian)
    _, _, (flat, gid, start, end) = _inputs(16)
    out, iout = blend_fwd_reference(flat, gid, start, end, GRID_X, 16)
    saved = torch.stack([out[:, 9], out[:, 26], out[:, 27]], 1)
    gout = torch.as_tensor(np.random.default_rng(3).normal(
        size=out.shape).astype(np.float32))
    before = dict(LAUNCHES)
    d_sorted = blend_bwd(flat, gid, start, end, GRID_X, 16, gout, saved,
                         iout)
    d_ref, (evals, hits, slots) = blend_bwd_reference(
        flat, gid, start, end, GRID_X, 16, gout, saved, iout,
        count_work=True)
    assert torch.equal(d_sorted, d_ref)
    n = flat.shape[0]
    d_flat = reduce_per_gaussian(d_sorted, gid, n, _runs(gid, n))
    assert LAUNCHES == before
    want = np.zeros((n, 37), np.float64)
    np.add.at(want, gid.numpy(), d_sorted.numpy().astype(np.float64))
    np.testing.assert_allclose(d_flat.numpy(), want, rtol=1e-5, atol=1e-6)
    # slots past a pixel's n_contrib have no contribution: zero rows where
    # the whole tile is past it
    assert evals == int(iout[:, 0].sum()) and 0 < hits <= evals
    assert 0 < slots <= gid.shape[0]
    nc_max = iout[:, 0].amax(dim=1)
    for t in range(start.shape[0]):
        tail = d_sorted[int(start[t]) + int(nc_max[t]):int(end[t])]
        assert not tail.any()
