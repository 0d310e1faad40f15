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


def _port_binned(E, device="cpu", boost=1.0, view=2, dilate=0,
                 clip_rect=False):
    """Preprocess + bin + pack of a 2000-gaussian SH-3 scene at 64x48 by
    the port itself, seen from orbit camera `view`: dense enough that some
    pixels latch done. E <= 16 feature channels (the first E of the
    scene's 16). `boost` scales the surfels (12 makes the ray-splat branch
    take part). dilate: the binning's rects dilated by that many tiles (a
    superset pair list); clip_rect: flat carries the fresh rects. Returns
    (flat, BinningOut)."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    st, mk = make_bench_scene(n=2000, seed=4, profile="trained")
    p = from_numpy(st, device=device)
    cm = camera_mats(mk(view, W, H), device)
    opac = p.opacity_activated()[:, 0]
    pre = preprocess_gaussians(
        p.xyz, p.scaling_activated() * boost, p.rotation_normalized(), cm.w2v,
        cm.full_proj, cm.campos, W, H, opac, shs=p.features(), sh_degree=3)
    b = bin_gaussians(pre, W, H, dilate_tiles=dilate)
    flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                          p.seg_feature_normed()[:, :E].contiguous()
                          if E else None,
                          rect=(pre.rect_min, pre.rect_max) if clip_rect
                          else None)
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
    # any width up to 256 runs; a wider one raises and names the limit
    with pytest.raises(ValueError, match="E <= 256"):
        blend_fwd(torch.zeros((flat.shape[0], 21 + 257), device=cuda), gid,
                  start, end, GRID_X, 257)
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


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 21, 37])
def test_cuda_segment_sum_is_the_plain_version_bit_for_bit(cuda, D):
    """The segment sum on a synthetic binning — 20,000 gaussians with runs
    of 0-3 slots in a shuffled slot order, one gaussian with a run of 4,096
    — is torch.equal to its plain version (index_add_ in slot order) run on
    the CPU: the kernel adds each gaussian's rows in slot order from 0."""
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, reduce_per_gaussian, reduce_per_gaussian_reference)
    rng = np.random.default_rng(30 + D)
    n = 20_000
    lens = rng.integers(0, 4, size=n)
    lens[n // 3] = 4096
    gid = np.repeat(np.arange(n), lens)
    sorted_gid = gid[rng.permutation(gid.size)].astype(np.int32)
    gid_order = np.argsort(sorted_gid, kind="stable").astype(np.int32)
    run_start = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    d = rng.standard_normal((gid.size, D)).astype(np.float32)
    d *= (np.float32(10.0) ** rng.integers(-4, 5, size=d.shape)).astype(
        np.float32)
    d_cpu, gid_cpu = torch.from_numpy(d), torch.from_numpy(sorted_gid)
    runs = (torch.from_numpy(gid_order).to(cuda),
            torch.from_numpy(run_start).to(cuda))
    before = LAUNCHES["segment_sum"]
    got = reduce_per_gaussian(d_cpu.to(cuda), gid_cpu.to(cuda), n, runs)
    torch.cuda.synchronize()
    assert LAUNCHES["segment_sum"] == before + 1
    want = reduce_per_gaussian_reference(d_cpu, gid_cpu, n)
    assert torch.equal(got.cpu(), want)
    assert not got[torch.from_numpy(lens == 0).to(cuda)].any()


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "done0"])
def test_cuda_k1_extras_only_matches_plain(cuda, masked):
    """K1 extras_only on the card: iout equal to its plain version, final T
    and features within 3e-4; with done0 the sampled pixels equal K1
    `full`'s bit for bit and the latched ones are (T = 1, 0, n_contrib 0)."""
    from instascene_tpu_torch.ops.blend_visits import (LAUNCHES, blend_fwd,
                                                       blend_fwd_reference)
    E = 16
    args = (*_port_inputs(E, cuda, boost=12.0), GRID_X, E)
    nt = args[2].shape[0]
    d0 = None
    if masked:
        gen = torch.Generator(device="cpu").manual_seed(2)
        d0 = (torch.rand((nt, 1, 256), generator=gen) >= 0.1).to(
            torch.int32).to(cuda)
    want = {**LAUNCHES, "K1 extras_only": LAUNCHES["K1 extras_only"] + 1}
    out, iout = blend_fwd(*args, extras_only=True, done0=d0)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    ref, iref = blend_fwd_reference(*args, extras_only=True, done0=d0)
    assert torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    zero = [r for r in range(12 + E) if not 9 <= r < 10 + E]
    assert not out[:, zero].any() and not iout[:, 1].any()
    if masked:
        full, ifull = blend_fwd(*args)
        s = d0[:, 0] == 0
        assert torch.equal(iout[:, 0][s], ifull[:, 0][s])
        for r in range(9, 10 + E):
            assert torch.equal(out[:, r][s], full[:, r][s]), r
        assert (out[:, 9][~s] == 1).all() and not iout[:, 0][~s].any()


@pytest.mark.cuda
@pytest.mark.parametrize("E", [0, 16], ids=["E0", "E16"])
def test_cuda_k1_track_matches_plain(cuda, E):
    """K1 track on the card: contributor ids equal to its plain version,
    weights within 1e-6, out and iout equal to K1 `full`'s."""
    from instascene_tpu_torch.ops.blend_visits import (blend_fwd,
                                                       blend_fwd_reference)
    args = (*_port_inputs(E, cuda, boost=12.0), GRID_X, E)
    out, iout, ids, w = blend_fwd(*args, track=True)
    full, ifull = blend_fwd(*args)
    torch.cuda.synchronize()
    _, _, rids, rw = blend_fwd_reference(*args, track=True)
    assert torch.equal(ids, rids) and (ids >= 0).any()
    torch.testing.assert_close(w, rw, atol=1e-6, rtol=0)
    assert torch.equal(out, full) and torch.equal(iout, ifull)


@pytest.mark.cuda
@pytest.mark.parametrize("masked", [False, True], ids=["plain", "done0"])
def test_cuda_k2_extras_only_matches_plain(cuda, masked):
    """K2 extras_only and the segment sum at D = 16 on the card: per-slot
    rows and d_flat within 1e-4 of each column's largest |value| of the
    plain versions, and bit for bit equal over two runs."""
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, blend_bwd, blend_bwd_reference, blend_fwd,
        reduce_per_gaussian)
    E = 16
    flat, b = _port_binned(E, cuda, boost=12.0)
    gid, n = b.sorted_gid, flat.shape[0]
    runs = (b.gid_order, b.run_start)
    args = (flat, gid, b.tile_start, b.tile_end, GRID_X, E)
    d0 = None
    if masked:
        gen = torch.Generator(device="cpu").manual_seed(3)
        d0 = (torch.rand((b.tile_start.shape[0], 1, 256), generator=gen)
              >= 0.1).to(torch.int32).to(cuda)
    out, iout = blend_fwd(*args, extras_only=True, done0=d0)
    saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                        1).contiguous()
    gen = torch.Generator(device="cpu").manual_seed(6)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    want = {**LAUNCHES, "K2 extras_only": LAUNCHES["K2 extras_only"] + 2,
            "segment_sum": LAUNCHES["segment_sum"] + 2}
    d1 = blend_bwd(*args, gout, saved, iout, extras_only=True)
    f1 = reduce_per_gaussian(d1, gid, n, runs)
    d2 = blend_bwd(*args, gout, saved, iout, extras_only=True)
    f2 = reduce_per_gaussian(d2, gid, n, runs)
    torch.cuda.synchronize()
    assert LAUNCHES == want
    assert d1.shape == (gid.shape[0], E)
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    ref = blend_bwd_reference(*args, gout, saved, iout, extras_only=True)
    fref = reduce_per_gaussian(ref.cpu(), gid.cpu(), n,
                               (b.gid_order.cpu(), b.run_start.cpu()))
    for got, want in ((d1, ref), (f1.cpu(), fref)):
        scale = want.abs().amax(dim=0).clamp(min=1e-30)
        err = ((got.to(want.device) - want).abs() / scale).amax()
        assert float(err) <= 1e-4, float(err)


def _bwd_twice(args, gout, saved, iout, n, runs, gid, **kw):
    """K2 (or K4) and the segment sum, twice: (d_sorted, d_flat), after
    checking that the second run is bit for bit the first."""
    from instascene_tpu_torch.ops.blend_visits import (blend_bwd,
                                                       reduce_per_gaussian)
    d1 = blend_bwd(*args, gout, saved, iout, extras_only=True, **kw)
    f1 = reduce_per_gaussian(d1, gid, n, runs)
    d2 = blend_bwd(*args, gout, saved, iout, extras_only=True, **kw)
    f2 = reduce_per_gaussian(d2, gid, n, runs)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    return d1, f1


def _col_err(got, want):
    scale = want.abs().amax(dim=0).clamp(min=1e-30)
    return float(((got - want).abs() / scale).amax())


def _saved(out, E):
    return torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                       1).contiguous()


@pytest.mark.cuda
def test_cuda_k3_k4_match_plain(cuda):
    """K1 and K2 extras_only over a list of 5 tiles (K3, K4) on the card:
    out/iout equal to their plain version, and each listed row bit for bit
    K1 extras_only's row of its tile over the whole frame; K4's rows within
    1e-4 of each column's largest |value| of its plain version, zero for
    the slots of unlisted tiles, bit for bit equal over two runs."""
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, blend_bwd_reference, blend_fwd, blend_fwd_reference,
        reduce_per_gaussian)
    E = 16
    flat, b = _port_binned(E, cuda, boost=12.0)
    gid, n = b.sorted_gid, flat.shape[0]
    args = (flat, gid, b.tile_start, b.tile_end, GRID_X, E)
    ids = torch.tensor([0, 3, 5, 6, 11], dtype=torch.int32, device=cuda)
    want = {**LAUNCHES, "K3 extras_only": LAUNCHES["K3 extras_only"] + 1,
            "K4 extras_only": LAUNCHES["K4 extras_only"] + 2,
            "segment_sum": LAUNCHES["segment_sum"] + 2}
    out, iout = blend_fwd(*args, extras_only=True, tile_ids=ids)
    gen = torch.Generator(device="cpu").manual_seed(8)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    d, f = _bwd_twice(args, gout, _saved(out, E), iout, n,
                      (b.gid_order, b.run_start), gid, tile_ids=ids)
    assert LAUNCHES == want
    ref, iref = blend_fwd_reference(*args, extras_only=True, tile_ids=ids)
    assert out.shape == (5, 12 + E, 256) and torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    full, ifull = blend_fwd(*args, extras_only=True)
    assert torch.equal(out, full[ids.long()])
    assert torch.equal(iout, ifull[ids.long()])
    dref = blend_bwd_reference(*args, gout, _saved(out, E), iout,
                               extras_only=True, tile_ids=ids)
    mine = torch.zeros(gid.shape[0], dtype=torch.bool, device=cuda)
    for t in ids.tolist():
        mine[int(b.tile_start[t]):int(b.tile_end[t])] = True
    assert d[mine].any() and not d[~mine].any()
    assert _col_err(d, dref) <= 1e-4
    fref = reduce_per_gaussian(dref.cpu(), gid.cpu(), n,
                               (b.gid_order.cpu(), b.run_start.cpu()))
    assert _col_err(f.cpu(), fref) <= 1e-4


@pytest.mark.cuda
def test_cuda_tiles_per_view_matches_plain(cuda):
    """K1 and K2 extras_only over three views concatenated along the tile
    axis by merge_binnings (tiles_per_view): out/iout equal to their plain
    version and bit for bit each view's own K1 extras_only render; K2's
    rows within 1e-4 of each column's largest |value| of its plain
    version, bit for bit equal over two runs."""
    from instascene_tpu_torch.ops.binning import merge_binnings
    from instascene_tpu_torch.ops.blend_visits import (
        LAUNCHES, blend_bwd_reference, blend_fwd, blend_fwd_reference)
    E = 16
    views = [_port_binned(E, cuda, boost=12.0, view=v) for v in (1, 2, 3)]
    n = views[0][0].shape[0]
    flat, mb, T = merge_binnings(views)
    args = (flat, mb.sorted_gid, mb.tile_start, mb.tile_end, GRID_X, E)
    want = {**LAUNCHES,
            "K1 tiles_per_view": LAUNCHES["K1 tiles_per_view"] + 1,
            "K2 tiles_per_view": LAUNCHES["K2 tiles_per_view"] + 2,
            "segment_sum": LAUNCHES["segment_sum"] + 2}
    out, iout = blend_fwd(*args, extras_only=True, tiles_per_view=T)
    gen = torch.Generator(device="cpu").manual_seed(9)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    d, _ = _bwd_twice(args, gout, _saved(out, E), iout, 3 * n,
                      (mb.gid_order, mb.run_start), mb.sorted_gid,
                      tiles_per_view=T)
    assert LAUNCHES == want
    ref, iref = blend_fwd_reference(*args, extras_only=True,
                                    tiles_per_view=T)
    assert torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    for v, (f, b) in enumerate(views):
        own, iown = blend_fwd(f, b.sorted_gid, b.tile_start, b.tile_end,
                              GRID_X, E, extras_only=True)
        assert torch.equal(out[v * T:(v + 1) * T], own)
        assert torch.equal(iout[v * T:(v + 1) * T], iown)
    dref = blend_bwd_reference(*args, gout, _saved(out, E), iout,
                               extras_only=True, tiles_per_view=T)
    assert _col_err(d, dref) <= 1e-4


@pytest.mark.cuda
def test_cuda_k5_k6_match_plain(cuda):
    """K5 and K6 on ~300 drawn pixels (duplicates included): feat and aux
    against their plain version (n_contrib exactly, T and features within
    3e-4), and at every drawn pixel bit for bit K1 extras_only with a done0
    that frees the same pixels; K6's rows within 1e-4 of each column's
    largest |value| of its plain version, and K6 + the segment sum bit for
    bit equal over two runs."""
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops.blend_visits import (LAUNCHES, blend_fwd,
                                                       reduce_per_gaussian)
    E = 16
    flat, b = _port_binned(E, cuda, boost=12.0)
    gid, n = b.sorted_gid, flat.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(4)
    idx = torch.randint(0, W * H, (300,), generator=gen)
    idx[5:9] = idx[0]
    nt = b.tile_start.shape[0]
    S = bs.pick_sparse_s(300, nt)
    spix, _, _, ov = bs.spix_from_idx(idx.to(cuda), W, H, 16, S)
    assert not bool(ov)
    args = (flat, gid, b.tile_start, b.tile_end, spix, GRID_X, E)
    want = {**LAUNCHES, "K5": LAUNCHES["K5"] + 1, "K6": LAUNCHES["K6"] + 2}
    feat, aux = bs.blend_sparse_fwd(*args)
    gout = torch.randn(feat.shape, generator=gen).to(cuda)
    d1 = bs.blend_sparse_bwd(*args, gout, aux)
    d2 = bs.blend_sparse_bwd(*args, gout, aux)
    torch.cuda.synchronize()
    assert LAUNCHES == want and torch.equal(d1, d2)
    runs = (b.gid_order, b.run_start)
    assert torch.equal(reduce_per_gaussian(d1, gid, n, runs),
                       reduce_per_gaussian(d2, gid, n, runs))
    rfeat, raux = bs.blend_sparse_fwd_reference(*args)
    assert torch.equal(aux[..., 1], raux[..., 1]) and aux[..., 1].any()
    torch.testing.assert_close(aux, raux, atol=3e-4, rtol=0)
    torch.testing.assert_close(feat, rfeat, atol=3e-4, rtol=0)
    t_i, s_i = torch.nonzero(spix >= 0, as_tuple=True)
    p_i = spix[t_i, s_i].long()
    d0 = torch.ones((nt, 1, 256), dtype=torch.int32, device=cuda)
    d0[t_i, 0, p_i] = 0
    out, iout = blend_fwd(flat, gid, b.tile_start, b.tile_end, GRID_X, E,
                          extras_only=True, done0=d0)
    assert torch.equal(feat[t_i, s_i], out[t_i, 10:10 + E, p_i])
    assert torch.equal(aux[t_i, s_i, 0], out[t_i, 9, p_i])
    assert torch.equal(aux[t_i, s_i, 1], iout[t_i, 0, p_i].float())
    dref = bs.blend_sparse_bwd_reference(*args, gout, aux)
    assert _col_err(d1, dref) <= 1e-4


@pytest.mark.cuda
def test_cuda_prim_graph_matches_cpu(cuda):
    """HDBSCAN's Prim's tree on the card, where its steps replay a captured
    CUDA graph (n − 1 > 3·graph_steps, then eager steps for the rest):
    bit for bit the card's eager steps on the same points and core
    distances (min_samples 10, whose ties the tree breaks by index); the
    same edges in the same order as the CPU's eager steps, distances to
    rtol 1e-12, where no two reachabilities tie (random core distances:
    between devices the norms may differ in the last bit, which decides a
    tie); and hdbscan on the card labels the points as on the CPU (core
    distances 0 at min_samples 1, so no ties), whose partition
    tests/test_torch_export.py holds to sklearn's."""
    from instascene_tpu_torch.semantic.export import (_core_distances,
                                                      _prim_mst, hdbscan)
    rng = np.random.default_rng(7)
    n = 3000
    centers = rng.normal(0, 1, (4, 16))
    x = centers[rng.integers(0, 4, n)] + rng.normal(0, 0.2, (n, 16))
    xc, xg = torch.as_tensor(x), torch.as_tensor(x, device=cuda)
    core = _core_distances(xg, 10)
    eager = _prim_mst(xg, core, graph_steps=n)
    graph = _prim_mst(xg, core, graph_steps=256)
    np.testing.assert_array_equal(graph, eager)
    core_r = torch.as_tensor(rng.uniform(0.6, 1.4, n))
    want = _prim_mst(xc, core_r)
    got = _prim_mst(xg, core_r.to(cuda), graph_steps=256)
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-12, atol=0)
    a = hdbscan(x, 30, 1, 0.1, True, device="cpu")
    b = hdbscan(x, 30, 1, 0.1, True, device=cuda)
    assert len(np.unique(a[a >= 0])) >= 2
    np.testing.assert_array_equal(b, a)


def _k2_twice(args, gout, saved, iout, n, runs, gid, **kw):
    """K2 (any mode) and the segment sum twice: (d_sorted, d_flat), after
    checking that the second run is bit for bit the first."""
    from instascene_tpu_torch.ops.blend_visits import (blend_bwd,
                                                       reduce_per_gaussian)
    d1 = blend_bwd(*args, gout, saved, iout, **kw)
    f1 = reduce_per_gaussian(d1, gid, n, runs)
    d2 = blend_bwd(*args, gout, saved, iout, **kw)
    f2 = reduce_per_gaussian(d2, gid, n, runs)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2) and torch.equal(f1, f2)
    return d1, f1


@pytest.mark.cuda
@pytest.mark.parametrize("E", [0, 4, 8, 16])
def test_cuda_k7_k8_match_plain(cuda, E):
    """K7 and K8 over the padded layout of the port's binning: K7's out and
    iout equal to its plain version's (rows within 3e-4) and bit for bit
    K1 `full`'s on the same binning (the same rows in the same order);
    K8's d(packed) within 1e-4 of each column's largest |value| of its
    plain version, zero past each tile's slots, bit for bit equal over two
    runs and bit for bit K2 `full`'s per-slot rows."""
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import padded_layout
    from instascene_tpu_torch.ops.blend_padded import (
        blend_bwd_padded, blend_bwd_padded_reference, blend_fwd_padded,
        blend_fwd_padded_reference, pack_inputs)
    flat, b = _port_binned(E, cuda, boost=12.0)
    idx, count = padded_layout(b)
    packed = pack_inputs(flat, idx)
    T, D, K = packed.shape
    want = {**bv.LAUNCHES, "K7": bv.LAUNCHES["K7"] + 1,
            "K8": bv.LAUNCHES["K8"] + 2}
    out, iout = blend_fwd_padded(packed, count, GRID_X, E)
    saved = _saved(out, E)
    gen = torch.Generator(device="cpu").manual_seed(10 + E)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    d1 = blend_bwd_padded(packed, count, GRID_X, E, gout, saved, iout)
    d2 = blend_bwd_padded(packed, count, GRID_X, E, gout, saved, iout)
    torch.cuda.synchronize()
    assert bv.LAUNCHES == want and torch.equal(d1, d2)
    ref, iref = blend_fwd_padded_reference(packed, count, GRID_X, E)
    assert torch.equal(iout, iref) and iout[:, 0].any()
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    k1, ik1 = bv.blend_fwd(flat, b.sorted_gid, b.tile_start, b.tile_end,
                           GRID_X, E)
    assert torch.equal(out, k1) and torch.equal(iout, ik1)
    dref = blend_bwd_padded_reference(packed, count, GRID_X, E, gout, saved,
                                      iout)
    assert _col_err(d1.permute(0, 2, 1).reshape(-1, D),
                    dref.permute(0, 2, 1).reshape(-1, D)) <= 1e-4
    slot = torch.arange(K, device=cuda)[None, :] < count[:, None]
    assert d1.any() and not d1.permute(0, 2, 1)[~slot].any()
    k2 = bv.blend_bwd(flat, b.sorted_gid, b.tile_start, b.tile_end, GRID_X,
                      E, gout, saved, iout)
    t_of = torch.repeat_interleave(torch.arange(T, device=cuda),
                                   count.long())
    k_of = torch.arange(b.total_pairs, device=cuda) - b.tile_start.long()[
        t_of]
    assert torch.equal(d1[t_of, :, k_of], k2)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "viewer", "no_dist",
                                  "extras_only"])
def test_cuda_clip_rect_matches_plain_and_fresh(cuda, mode):
    """K1 clip_rect over a superset pair list (the binning dilated by one
    tile, flat carrying the fresh rects) against its plain version (iout
    equal, rows within 3e-4), and its out bit for bit K1's over the fresh
    binning (a gated slot contributes nothing; only the slot numbers of
    iout differ). K2 clip_rect (not viewer) against its plain version
    (1e-4 of each column's largest), twice bit for bit, and its d_flat bit
    for bit the fresh binning's (the gated slots' rows are zeros)."""
    from instascene_tpu_torch.ops import blend_visits as bv
    E = 16
    flat, b = _port_binned(E, cuda, boost=12.0, dilate=1, clip_rect=True)
    fresh, bf = _port_binned(E, cuda, boost=12.0)
    assert b.total_pairs > bf.total_pairs
    n = flat.shape[0]
    kw = dict(viewer=mode == "viewer", no_dist=mode == "no_dist",
              extras_only=mode == "extras_only")
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E)
    fargs = (fresh, bf.sorted_gid, bf.tile_start, bf.tile_end, GRID_X, E)
    key = f"K1 {mode} clip_rect"
    want = {**bv.LAUNCHES, key: bv.LAUNCHES[key] + 1}
    out, iout = bv.blend_fwd(*args, clip_rect=True, **kw)
    torch.cuda.synchronize()
    assert bv.LAUNCHES == want
    ref, iref = bv.blend_fwd_reference(*args, clip_rect=True, **kw)
    assert torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    own, iown = bv.blend_fwd(*fargs, **kw)
    assert torch.equal(out, own)
    if mode == "viewer":
        return
    bkw = dict(no_dist=mode == "no_dist", extras_only=mode == "extras_only")
    gen = torch.Generator(device="cpu").manual_seed(12)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    d, f = _k2_twice(args, gout, _saved(out, E), iout, n,
                     (b.gid_order, b.run_start), b.sorted_gid,
                     clip_rect=True, **bkw)
    assert d.shape[1] == (E if mode == "extras_only" else 21 + E + 4)
    assert not d[:, 21 + E:].any()
    dref = bv.blend_bwd_reference(*args, gout, _saved(out, E), iout,
                                  clip_rect=True, **bkw)
    assert _col_err(d, dref) <= 1e-4
    _, ff = _k2_twice(fargs, gout, _saved(own, E), iown, n,
                      (bf.gid_order, bf.run_start), bf.sorted_gid, **bkw)
    assert torch.equal(f[:, :ff.shape[1]], ff)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["full", "viewer", "no_dist"])
def test_cuda_k3_k4_every_mode(cuda, mode):
    """K1 over a list of 5 tiles (K3) in `mode`: out/iout equal to its
    plain version and bit for bit the whole frame's rows; K2 over the list
    (K4, not viewer) within 1e-4 of each column's largest of its plain
    version, zero for the slots of unlisted tiles, twice bit for bit."""
    from instascene_tpu_torch.ops import blend_visits as bv
    E = 16
    flat, b = _port_binned(E, cuda, boost=12.0)
    n = flat.shape[0]
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, GRID_X, E)
    ids = torch.tensor([0, 3, 5, 6, 11], dtype=torch.int32, device=cuda)
    kw = dict(viewer=mode == "viewer", no_dist=mode == "no_dist")
    want = {**bv.LAUNCHES, f"K3 {mode}": bv.LAUNCHES[f"K3 {mode}"] + 1}
    out, iout = bv.blend_fwd(*args, tile_ids=ids, **kw)
    torch.cuda.synchronize()
    assert bv.LAUNCHES == want
    ref, iref = bv.blend_fwd_reference(*args, tile_ids=ids, **kw)
    assert out.shape == (5, 12 + E, 256) and torch.equal(iout, iref)
    torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
    full, ifull = bv.blend_fwd(*args, **kw)
    assert torch.equal(out, full[ids.long()])
    assert torch.equal(iout, ifull[ids.long()])
    if mode == "viewer":
        return
    gen = torch.Generator(device="cpu").manual_seed(13)
    gout = torch.randn(out.shape, generator=gen).to(cuda)
    d, _ = _k2_twice(args, gout, _saved(out, E), iout, n,
                     (b.gid_order, b.run_start), b.sorted_gid, tile_ids=ids,
                     no_dist=mode == "no_dist")
    dref = bv.blend_bwd_reference(*args, gout, _saved(out, E), iout,
                                  tile_ids=ids, no_dist=mode == "no_dist")
    mine = torch.zeros(b.total_pairs, dtype=torch.bool, device=cuda)
    for t in ids.tolist():
        mine[int(b.tile_start[t]):int(b.tile_end[t])] = True
    assert d[mine].any() and not d[~mine].any()
    assert _col_err(d, dref) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("E", [4, 8])
def test_cuda_runtime_width_matches_plain(cuda, E):
    """The run-time-width instantiation (E neither 0 nor 16): K1 full and
    extras_only against their plain versions (iout equal, rows within
    3e-4), K2 full and extras_only and the segment sum (1e-4 of each
    column's largest, twice bit for bit), and K5/K6 on ~300 draws (feat
    and aux within 3e-4 with n_contrib exact, bit for bit K1 extras_only
    at the drawn pixels; K6 within 1e-4, twice bit for bit)."""
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops import blend_visits as bv
    flat, b = _port_binned(E, cuda, boost=12.0)
    gid, n = b.sorted_gid, flat.shape[0]
    runs = (b.gid_order, b.run_start)
    args = (flat, gid, b.tile_start, b.tile_end, GRID_X, E)
    gen = torch.Generator(device="cpu").manual_seed(20 + E)
    for xo in (False, True):
        out, iout = bv.blend_fwd(*args, extras_only=xo)
        ref, iref = bv.blend_fwd_reference(*args, extras_only=xo)
        assert torch.equal(iout, iref) and iout[:, 0].any()
        torch.testing.assert_close(out, ref, atol=3e-4, rtol=0)
        gout = torch.randn(out.shape, generator=gen).to(cuda)
        d, f = _k2_twice(args, gout, _saved(out, E), iout, n, runs, gid,
                         extras_only=xo)
        dref = bv.blend_bwd_reference(*args, gout, _saved(out, E), iout,
                                      extras_only=xo)
        fref = bv.reduce_per_gaussian(dref.cpu(), gid.cpu(), n,
                                      (runs[0].cpu(), runs[1].cpu()))
        assert _col_err(d, dref) <= 1e-4
        assert _col_err(f.cpu(), fref) <= 1e-4
    idx = torch.randint(0, W * H, (300,), generator=gen)
    nt = b.tile_start.shape[0]
    S = bs.pick_sparse_s(300, nt)
    spix, _, _, ov = bs.spix_from_idx(idx.to(cuda), W, H, 16, S)
    assert not bool(ov)
    sargs = (flat, gid, b.tile_start, b.tile_end, spix, GRID_X, E)
    feat, aux = bs.blend_sparse_fwd(*sargs)
    rfeat, raux = bs.blend_sparse_fwd_reference(*sargs)
    assert torch.equal(aux[..., 1], raux[..., 1]) and aux[..., 1].any()
    torch.testing.assert_close(aux, raux, atol=3e-4, rtol=0)
    torch.testing.assert_close(feat, rfeat, atol=3e-4, rtol=0)
    t_i, s_i = torch.nonzero(spix >= 0, as_tuple=True)
    p_i = spix[t_i, s_i].long()
    d0 = torch.ones((nt, 1, 256), dtype=torch.int32, device=cuda)
    d0[t_i, 0, p_i] = 0
    out, iout = bv.blend_fwd(*args, extras_only=True, done0=d0)
    assert torch.equal(feat[t_i, s_i], out[t_i, 10:10 + E, p_i])
    gs = torch.randn(feat.shape, generator=gen).to(cuda)
    d1 = bs.blend_sparse_bwd(*sargs, gs, aux)
    d2 = bs.blend_sparse_bwd(*sargs, gs, aux)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2)
    assert _col_err(d1, bs.blend_sparse_bwd_reference(*sargs, gs, aux)) \
        <= 1e-4
