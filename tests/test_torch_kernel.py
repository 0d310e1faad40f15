"""K1 within the port: the plain version's work count on the CPU, and the
CUDA kernel against its plain version and the goldens on the card.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_kernel.py -q
(tests/conftest.py imports JAX, hence --noconftest there.)"""

import os

import numpy as np
import pytest
import torch

W, H = 64, 48
GRID_X = W // 16
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens",
                      "forward.npz")


def _port_binned(E, device="cpu", boost=1.0):
    """Preprocess + bin + pack of a 2000-gaussian SH-3 scene at 64x48 by
    the port itself: dense enough that some pixels latch done. `boost`
    scales the surfels (12 makes the ray-splat branch take part).
    Returns (flat, BinningOut)."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    st, mk = make_bench_scene(n=2000, seed=4, profile="trained")
    p = from_numpy(st, device=device)
    cm = camera_mats(mk(2, W, H), device)
    opac = p.opacity_activated()[:, 0]
    pre = preprocess_gaussians(
        p.xyz, p.scaling_activated() * boost, p.rotation_normalized(), cm.w2v,
        cm.full_proj, cm.campos, W, H, opac, shs=p.features(), sh_degree=3)
    b = bin_gaussians(pre, W, H)
    flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                          p.seg_feature_normed() if E else None)
    return flat, b


def _port_inputs(E, device="cpu", boost=1.0):
    """(flat, sorted_gid, tile_start, tile_end) of _port_binned."""
    flat, b = _port_binned(E, device, boost)
    return flat, b.sorted_gid, b.tile_start, b.tile_end


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("viewer", [False, True], ids=["full", "viewer"])
def test_plain_k1_work_counts(viewer):
    """count_work leaves the outputs as they were and counts per pixel the
    slots walked (all of the tile's unless the pixel latched done, so at
    least up to its last contributor) and the contributions."""
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    args = (*_port_inputs(16), GRID_X, 16)
    out, iout = blend_fwd_reference(*args, viewer=viewer)
    out2, iout2, n_eval, n_hit = blend_fwd_reference(
        *args, viewer=viewer, count_work=True)
    assert torch.equal(out, out2) and torch.equal(iout, iout2)
    count = (args[3] - args[2])[:, None].expand_as(n_eval)
    last = iout[:, 0]
    assert torch.all(n_hit <= last) and torch.all(last <= n_eval)
    assert torch.all(n_eval <= count)
    assert torch.equal(n_hit > 0, last > 0)
    # a pixel that stopped short of its tile's end latched done: the next
    # contribution, with alpha <= 0.99, would have taken T below 1e-4
    short = n_eval < count
    assert short.any() and (n_eval == count).any()
    assert torch.all(out[:, 9][short] < 1e-2)


@pytest.mark.parametrize("boost", [1.0, 12.0], ids=["bench", "boosted"])
def test_binning_runs_are_a_stable_sort_of_the_pairs(boost):
    """BinningOut's per-gaussian runs, made from the sort binning already
    did, equal a stable sort of sorted_gid: gid_order lists each gaussian's
    slots ascending, run_start is the prefix sum of its pair counts."""
    flat, b = _port_binned(0, boost=boost)
    n = flat.shape[0]
    gid = b.sorted_gid
    assert gid.numel() > 0
    assert b.gid_order.dtype == b.run_start.dtype == torch.int32
    assert torch.equal(b.gid_order.long(), torch.argsort(gid, stable=True))
    want = torch.zeros(n + 1, dtype=torch.int64)
    want[1:] = torch.cumsum(torch.bincount(gid, minlength=n), 0)
    assert torch.equal(b.run_start.long(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("E,viewer", [(16, False), (0, False), (16, True)],
                         ids=["full-E16", "full-E0", "viewer-E16"])
def test_cuda_kernel_matches_plain(cuda, E, viewer):
    """On the card: csrc/blend_fwd.cu equals its plain version (n_contrib
    and med_slot exactly, every row within 3e-4), and viewer mode leaves
    the rows it does not compute exactly zero."""
    from instascene_tpu_torch.ops.blend_visits import (LAUNCHES, blend_fwd,
                                                       blend_fwd_reference)
    args = (*_port_inputs(E, cuda), GRID_X, E)
    key = "K1 viewer" if viewer else "K1 full"
    want = {**LAUNCHES, key: LAUNCHES[key] + 1}
    out, iout = blend_fwd(*args, viewer=viewer)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    ref, iref = blend_fwd_reference(*args, viewer=viewer)
    assert torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    if viewer:
        for r in (3, 4, 5, 6, 7, 8, 10 + E, 11 + E):
            assert not out[:, r].any(), r
        assert not iout[:, 1].any()


@pytest.mark.cuda
def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    from instascene_tpu_torch.ops.blend_visits import blend_fwd
    flat, gid, start, end = _port_inputs(16, cuda)
    with pytest.raises(ValueError, match="built for E"):
        blend_fwd(flat[:, :29].contiguous(), gid, start, end, GRID_X, 8)
    with pytest.raises(ValueError, match="flat must be"):
        blend_fwd(flat.double(), gid, start, end, GRID_X, 16)
    with pytest.raises(ValueError, match="sorted_gid"):
        blend_fwd(flat, gid.long(), start, end, GRID_X, 16)
    with pytest.raises(ValueError, match="tile_end"):
        blend_fwd(flat, gid, start, end[:-1], GRID_X, 16)
    with pytest.raises(ValueError, match="blend"):
        blend_fwd(flat.clone().requires_grad_(True), gid, start, end,
                  GRID_X, 16)


@pytest.mark.cuda
def test_cuda_rasterize_matches_goldens(cuda):
    """The whole rasterizer on the card against the JAX package's goldens
    (atol 2e-5, rtol 1e-4, n_contrib exact); the goldens' 4 feature
    channels go in zero-padded to the kernel's 16."""
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    from instascene_tpu_torch.ops.blend_visits import LAUNCHES
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    g = np.load(GOLDEN)
    gw, gh, n = int(g["W"]), int(g["H"]), int(g["n"])
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.65,
                 image_name="g", width=gw, height=gh)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
    e = g["inputs_extra"].shape[1]
    extras = np.zeros((n, 16), np.float32)
    extras[:, :e] = g["inputs_extra"]
    want = {**LAUNCHES, "K1 full": LAUNCHES["K1 full"] + 1}
    out = rasterize(f(g["inputs_xyz"]), f(g["inputs_scales"]),
                    f(g["inputs_rots"]), f(g["inputs_opac"]),
                    CameraMats(f(cam.w2v), f(cam.full_proj),
                               f(cam.camera_center)),
                    [0.1, 0.2, 0.3], RasterizeConfig(gw, gh),
                    colors=f(g["inputs_color"]), extras=f(extras))
    assert LAUNCHES == want
    b = out.blend
    assert not b.extra[..., e:].any()
    for key in ("color", "depth", "alpha", "normal", "median_depth",
                "distortion", "final_T"):
        np.testing.assert_allclose(getattr(b, key).cpu().numpy(), g[key],
                                   atol=2e-5, rtol=1e-4, err_msg=key)
    np.testing.assert_allclose(b.extra[..., :e].cpu().numpy(), g["extra"],
                               atol=2e-5, rtol=1e-4)
    np.testing.assert_array_equal(b.n_contrib.cpu().numpy(), g["n_contrib"])


@pytest.mark.cuda
@pytest.mark.parametrize("E", [0, 16], ids=["E0", "E16"])
def test_cuda_k1_no_dist_matches_plain(cuda, E):
    """K1 no_dist on the card: iout equal to its plain version, every row
    within 3e-4, rows 3, 8, 10+E, 11+E exactly zero."""
    from instascene_tpu_torch.ops.blend_visits import (blend_fwd,
                                                       blend_fwd_reference)
    args = (*_port_inputs(E, cuda, boost=12.0), GRID_X, E)
    out, iout = blend_fwd(*args, no_dist=True)
    torch.cuda.synchronize()
    ref, iref = blend_fwd_reference(*args, no_dist=True)
    assert torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    assert not out[:, [3, 8, 10 + E, 11 + E]].any()


@pytest.mark.cuda
@pytest.mark.parametrize("E,no_dist", [(0, False), (16, False), (0, True),
                                       (16, True)],
                         ids=["full-E0", "full-E16", "no_dist-E0",
                              "no_dist-E16"])
def test_cuda_k2_matches_plain(cuda, E, no_dist):
    """K2 and the segment sum on the card against their plain versions on
    the same inputs: per-slot rows and d_flat within 1e-4 of each column's
    largest |value| (the sums over a tile's pixels run in another order),
    and d_flat bit for bit equal over two runs."""
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, blend_bwd, blend_bwd_reference, blend_fwd,
        reduce_per_gaussian)
    flat, b = _port_binned(E, cuda, boost=12.0)
    gid, n = b.sorted_gid, flat.shape[0]
    runs = (b.gid_order, b.run_start)
    args = (flat, gid, b.tile_start, b.tile_end, GRID_X, E)
    out, iout = blend_fwd(*args, no_dist=no_dist)
    saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                        1).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(5)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    k2 = "K2 no_dist" if no_dist else "K2 full"
    want = {**LAUNCHES, k2: LAUNCHES[k2] + 2,
            "segment_sum": LAUNCHES["segment_sum"] + 2}
    d1 = blend_bwd(*args, gout, saved, iout, no_dist=no_dist)
    f1 = reduce_per_gaussian(d1, gid, n, runs)
    d2 = blend_bwd(*args, gout, saved, iout, no_dist=no_dist)
    f2 = reduce_per_gaussian(d2, gid, n, runs)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    ref = blend_bwd_reference(*args, gout, saved, iout, no_dist=no_dist)
    fref = reduce_per_gaussian(ref.cpu(), gid.cpu(), n,
                               (b.gid_order.cpu(), b.run_start.cpu()))
    for got, want in ((d1, ref), (f1.cpu(), fref)):
        scale = want.abs().amax(dim=0).clamp(min=1e-30)
        err = ((got.to(want.device) - want).abs() / scale).amax()
        assert float(err) <= 1e-4, float(err)
