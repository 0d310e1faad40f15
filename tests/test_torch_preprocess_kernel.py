"""preprocess_gaussians' two paths: which one a call takes (on the CPU,
the device check and the kernel replaced by a recorder), and the CUDA
kernel (csrc/preprocess.cu) against the eager chain on the card, bit for
bit.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_kernel.py -q
"""

import functools
import math

import numpy as np
import pytest
import torch

W, H = 64, 48
FIELDS = ("T", "xy", "normal_view", "depth", "radius", "rect_min",
          "rect_max", "tiles_touched", "valid", "color")


def _model(requires_grad):
    """A 400-gaussian SH-3 model with features (a tenth of it dead) and a
    camera at 64x48; with requires_grad its leaves require grad."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    st, mk = make_bench_scene(n=400, seed=2, profile="trained")
    rng = np.random.default_rng(2)
    st["features_rest"] = rng.normal(0, 0.2, (400, 15, 3)).astype(np.float32)
    st["alive"] = rng.random(400) > 0.1
    st["active_sh_degree"] = 3
    p = from_numpy(st, device="cpu")
    if requires_grad:
        for name in ("xyz", "features_dc", "features_rest", "scaling",
                     "rotation", "opacity", "seg_feature"):
            getattr(p, name).requires_grad_(True)
    return p, mk(1, W, H)


def _preprocess(p, cam):
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, "cpu")
    return preprocess_gaussians(
        p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
        cm.full_proj, cm.campos, W, H, p.opacity_activated()[:, 0],
        shs=p.features(), sh_degree=3, alive=p.alive)


def _geometry_detached(p, cam):
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, "cpu")
    d = lambda a: a.detach()
    return preprocess_gaussians(
        d(p.xyz), d(p.scaling_activated()), d(p.rotation_normalized()),
        cm.w2v, cm.full_proj, cm.campos, W, H,
        d(p.opacity_activated()[:, 0]), shs=d(p.features()), sh_degree=3,
        alive=p.alive)


def _no_grad(p, cam):
    with torch.no_grad():
        return _preprocess(p, cam)


def _render(**kw):
    def call(p, cam):
        from instascene_tpu_torch.config import PipelineParams
        from instascene_tpu_torch.render import render
        return render(cam, p, PipelineParams(), np.zeros(3, np.float32),
                      **kw)
    return call


def _semantic_view(p, cam):
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train_semantic import render_features
    from instascene_tpu_torch.render import camera_mats
    return render_features(p, camera_mats(cam, "cpu"),
                           torch.zeros(3), RasterizeConfig(
                               W, H, bwd_extras_only=True))


# (call, its leaves require grad, the path it must take on the card)
DISPATCH = {
    "grad": (_preprocess, True, "eager"),
    "no_grad": (_no_grad, True, "kernel"),
    "detached": (_geometry_detached, True, "kernel"),
    "leaves_without_grad": (_preprocess, False, "kernel"),
    "render_training": (_render(), True, "eager"),
    "render_viewer": (_render(viewer=True), True, "kernel"),
    "render_track": (_render(track_contrib=True), True, "kernel"),
    "semantic_view": (_semantic_view, True, "kernel"),
}


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_on_the_card(case, monkeypatch):
    """With the device check answering "cuda" and the kernel replaced by a
    recorder that returns the plain outputs and counts its launch as the
    kernel does: a call under autograd on inputs that require grad takes
    the eager chain and counts preprocess_eager; every other call takes
    the kernel, the viewer's and the tracker's renders on leaves that
    require grad included, and the dispatcher counts nothing more."""
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops import preprocess as pre
    calls = []

    def kernel(*args):
        calls.append(args)
        bv.LAUNCHES["preprocess"] += 1
        return pre.preprocess_plain(*args)

    monkeypatch.setattr(pre, "_on_card", lambda t: True)
    monkeypatch.setattr(pre, "preprocess_kernel", kernel)
    call, requires_grad, path = DISPATCH[case]
    p, cam = _model(requires_grad)
    before = dict(bv.LAUNCHES)
    call(p, cam)
    got = {k: bv.LAUNCHES[k] - before[k] for k in bv.LAUNCHES}
    want = dict.fromkeys(got, 0)
    want["preprocess" if path == "kernel" else "preprocess_eager"] = 1
    assert got == want
    assert len(calls) == (path == "kernel")


@pytest.mark.parametrize("case", ["grad", "no_grad", "render_viewer"])
def test_cpu_tensors_take_the_plain_path(case):
    """CPU tensors run the plain version whatever autograd needs, and
    count no launch; its outputs keep a graph only where one was asked
    for."""
    from instascene_tpu_torch.ops import blend_visits as bv
    call, requires_grad, _ = DISPATCH[case]
    p, cam = _model(requires_grad)
    before = dict(bv.LAUNCHES)
    out = call(p, cam)
    assert bv.LAUNCHES == before
    if case == "grad":
        assert out.T.requires_grad and out.color.requires_grad
    elif case == "no_grad":
        assert not out.T.requires_grad
    else:
        assert not out["T"].requires_grad


def test_no_gaussians_launch_nothing(monkeypatch):
    """The kernel path with no gaussians returns empty outputs and counts
    no launch (the kernel launches none)."""
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops import preprocess as pre
    from instascene_tpu_torch.render import camera_mats
    p, cam = _model(False)
    cm = camera_mats(cam, "cpu")
    monkeypatch.setattr(pre, "_on_card", lambda t: True)
    before = dict(bv.LAUNCHES)
    out = pre.preprocess_gaussians(
        p.xyz[:0], p.scaling_activated()[:0], p.rotation_normalized()[:0],
        cm.w2v, cm.full_proj, cm.campos, W, H, p.opacity_activated()[:0, 0],
        shs=p.features()[:0], sh_degree=3)
    assert bv.LAUNCHES == before
    assert out.T.shape == (0, 3, 3) and out.rect_min.shape == (0, 2)
    assert out.color.shape == (0, 3) and out.valid.dtype == torch.bool


def test_conic_cull_follows_either_path(monkeypatch):
    """conic_cull applies conic_cull_masks to what either path returns."""
    from instascene_tpu_torch.ops import preprocess as pre
    from instascene_tpu_torch.render import camera_mats
    p, cam = _model(False)
    cm = camera_mats(cam, "cpu")
    args = (p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
            cm.full_proj, cm.campos, W, H, p.opacity_activated()[:, 0])
    kw = dict(shs=p.features(), sh_degree=3, alive=p.alive, conic_cull=True)
    plain = pre.preprocess_gaussians(*args, **kw)
    monkeypatch.setattr(pre, "_on_card", lambda t: True)
    monkeypatch.setattr(pre, "preprocess_kernel", pre.preprocess_plain)
    kernel = pre.preprocess_gaussians(*args, **kw)
    assert plain.cull_lo is not None
    for f in ("cull_lo", "cull_hi", "tiles_touched"):
        assert torch.equal(getattr(kernel, f), getattr(plain, f)), f
    assert int(plain.tiles_touched.sum()) < int(
        pre.preprocess_plain(*args, **{k: v for k, v in kw.items()
                                       if k != "conic_cull"})
        .tiles_touched.sum())


# ---- the kernel on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


EYE = (0.3, -3.5, 1.0)    # the card tests' camera centre


@functools.lru_cache(maxsize=2)
def _scene(n):
    """n random gaussians around the camera's target (seeded, on the card):
    log-normal scales, random quaternions, SH 3 with 16 coefficients; some
    behind the camera or at its centre, and some degenerate (zero
    quaternions, zero or huge scales, opacity near 0 and exactly 1)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(n)
    r = lambda *s: torch.rand(s, generator=g, device=dev)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    xyz = (r(n, 3) * 2 - 1) * torch.tensor([2.5, 2.5, 1.5], device=dev)
    xyz[: n // 20] = (r(n // 20, 3) * 2 - 1) * 8.0    # around and behind
    xyz[-3:] = torch.tensor(EYE, dtype=torch.float32, device=dev)
    scaling = torch.exp(rn(n, 2) * 0.8 - 4.0)
    rotation = rn(n, 4)
    opacity = torch.sigmoid(rn(n) * 2)
    shs = rn(n, 16, 3) * 0.3
    k = n // 100
    rotation[k:2 * k] = 0.0
    scaling[2 * k:3 * k] = 0.0
    scaling[3 * k:4 * k] = 40.0
    opacity[4 * k:5 * k] = 1e-7
    opacity[5 * k:6 * k] = 1.0
    alive = r(n) > 0.1
    return dict(xyz=xyz, scaling=scaling, rotation=rotation,
                opacity=opacity, shs=shs, alive=alive)


def _camera(width, height, dev):
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    from instascene_tpu_torch.render import camera_mats
    R_w2c, t = look_at(np.array(EYE), np.zeros(3))
    fovx = 1.2
    fovy = 2 * math.atan(math.tan(fovx / 2) * height / width)
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=fovx, fovy=fovy,
                 image_name="k", width=width, height=height)
    return camera_mats(cam, dev)


def _same_bits(a, b):
    """Equal bits, NaN where NaN (torch.equal alone fails on NaN)."""
    a, b = a.contiguous(), b.contiguous()
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


CASES = {
    "sh0": dict(sh_degree=0), "sh1": dict(sh_degree=1),
    "sh2": dict(sh_degree=2), "sh3": dict(sh_degree=3),
    "color": dict(color="random"), "zero_color": dict(color="zeros"),
    "alive": dict(sh_degree=3, alive=True),
    "slab": dict(sh_degree=3, alive=True, slab=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("size", [(976, 728), (1920, 1080)],
                         ids=["976x728", "1080p"])
@pytest.mark.parametrize("n", [300_000, 2_960_000], ids=["waldo", "garden"])
def test_kernel_matches_eager_bit_for_bit(n, size, case, cuda):
    """Every output of the kernel against the eager chain on the same
    inputs, bit for bit; then binning of each gives the same pair list."""
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.preprocess import (preprocess_gaussians,
                                                     preprocess_plain)
    s = _scene(n)
    width, height = size
    c = CASES[case]
    cm = _camera(width, height, cuda)
    kw = dict(alive=s["alive"] if c.get("alive") else None)
    if "color" in c:
        kw["color"] = (torch.rand_like(s["xyz"]) if c["color"] == "random"
                       else torch.zeros_like(s["xyz"]))
    else:
        kw.update(shs=s["shs"], sh_degree=c["sh_degree"])
    if c.get("slab"):
        # the third of four 16-row-aligned slabs of the frame
        h = -(-height // 64) * 16
        kw.update(y_offset=2 * h, full_height=height)
        height = h
    args = (s["xyz"], s["scaling"], s["rotation"], cm.w2v, cm.full_proj,
            cm.campos, width, height, s["opacity"])
    want = preprocess_plain(*args, **kw)
    before = bv.LAUNCHES["preprocess"]
    got = preprocess_gaussians(*args, **kw)
    torch.cuda.synchronize()
    assert bv.LAUNCHES["preprocess"] == before + 1
    bad = [f for f in FIELDS if not _same_bits(getattr(got, f),
                                               getattr(want, f))]
    assert not bad, f"fields differing from the eager chain: {bad}"
    assert int(want.valid.sum()) > n // 10     # the camera sees the scene
    b_got = bin_gaussians(got, width, height)
    b_want = bin_gaussians(want, width, height)
    assert b_got.total_pairs == b_want.total_pairs > 0
    for f in ("sorted_gid", "tile_start", "tile_end"):
        assert torch.equal(getattr(b_got, f), getattr(b_want, f)), f


@pytest.mark.cuda
def test_kernel_counts_its_launch(cuda):
    """preprocess_kernel called directly counts its one launch."""
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.preprocess import preprocess_kernel
    s = _scene(300_000)
    cm = _camera(W, H, cuda)
    before = dict(bv.LAUNCHES)
    preprocess_kernel(s["xyz"], s["scaling"], s["rotation"], cm.w2v,
                      cm.full_proj, cm.campos, W, H, s["opacity"],
                      shs=s["shs"], sh_degree=3)
    want = dict(before, preprocess=before["preprocess"] + 1)
    assert bv.LAUNCHES == want


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take(cuda):
    from instascene_tpu_torch.ops.preprocess import preprocess_kernel
    s = _scene(300_000)
    cm = _camera(W, H, cuda)
    args = (s["xyz"], s["scaling"], s["rotation"], cm.w2v, cm.full_proj,
            cm.campos, W, H, s["opacity"])
    with pytest.raises(ValueError, match="coefficients"):
        preprocess_kernel(*args, shs=s["shs"][:, :4], sh_degree=2)
    with pytest.raises(ValueError, match="color or shs"):
        preprocess_kernel(*args)
    with pytest.raises(ValueError, match="scaling"):
        preprocess_kernel(s["xyz"], s["scaling"][:-1], *args[2:],
                          shs=s["shs"], sh_degree=3)
