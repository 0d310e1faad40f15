"""preprocess_gaussians' paths: which one a call takes, and that the
autograd Function wires the kernel pair into the geometry step's graph
(on the CPU, the device check and the kernels replaced by recorders that
compute the plain version); then the CUDA kernels (csrc/preprocess.cu) on
the card: the forward against the eager chain bit for bit, the backward
against autograd through it.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_preprocess_kernel.py -q
"""

import functools
import math
import os
import subprocess
import sys

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


def _camera_grad(p, cam):
    """_preprocess with a camera centre that requires grad."""
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, "cpu")
    return preprocess_gaussians(
        p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
        cm.full_proj, cm.campos.clone().requires_grad_(True), W, H,
        p.opacity_activated()[:, 0], shs=p.features(), sh_degree=3,
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


# (call, its leaves require grad, the path it must take on the card:
# "kernel" the forward alone, "graph" the kernel pair, "refused" a
# ValueError, as camera gradients are taken on the CPU alone)
DISPATCH = {
    "grad": (_preprocess, True, "graph"),
    "camera_grad": (_camera_grad, True, "refused"),
    "no_grad": (_no_grad, True, "kernel"),
    "detached": (_geometry_detached, True, "kernel"),
    "leaves_without_grad": (_preprocess, False, "kernel"),
    "render_training": (_render(), True, "graph"),
    "render_viewer": (_render(viewer=True), True, "kernel"),
    "render_track": (_render(track_contrib=True), True, "kernel"),
    "semantic_view": (_semantic_view, True, "kernel"),
}


def _plain_backward(args, grads):
    """What preprocess_bwd_kernel returns, from the plain version:
    autograd's gradients of preprocess_plain's T, normal_view, depth, xy
    and color (the given ones) for xyz, scaling, rotation and shs."""
    from instascene_tpu_torch.ops.preprocess import preprocess_plain
    args = list(args)
    at = [0, 1, 2] + ([10] if args[10] is not None else [])
    leaves = [args[i].detach().requires_grad_(True) for i in at]
    for i, leaf in zip(at, leaves):
        args[i] = leaf
    if args[10] is None:        # a given colour: the kernel evaluates none
        args[9] = torch.zeros_like(args[0])
    with torch.enable_grad():
        out = preprocess_plain(*args)
        outs = (out.T, out.normal_view, out.depth, out.xy, out.color)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                  [g for _, g in pairs], allow_unused=True)
    got = [torch.zeros_like(x) if g is None else g
           for g, x in zip(got, leaves)]
    return tuple(got) + ((None,) if len(got) == 3 else ())


def _recorders(monkeypatch):
    """The device check answering "cuda" and the two kernels replaced by
    recorders that count their launches as the kernels do: the forward
    returns preprocess_plain's outputs, the backward _plain_backward's
    gradients. Returns the list of the recorders' calls."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops import preprocess as pre
    calls = []

    def kernel(*args):
        calls.append("preprocess")
        LAUNCHES["preprocess"] += 1
        with torch.no_grad():
            return pre.preprocess_plain(*args)

    def bwd_kernel(args, grads):
        calls.append("preprocess_bwd")
        LAUNCHES["preprocess_bwd"] += 1
        return _plain_backward(args, grads)

    monkeypatch.setattr(pre, "_on_card", lambda t: True)
    monkeypatch.setattr(pre, "preprocess_kernel", kernel)
    monkeypatch.setattr(pre, "preprocess_bwd_kernel", bwd_kernel)
    return calls


def _loss(out):
    """A sum of every floating output that requires grad."""
    vals = out.values() if isinstance(out, dict) else out
    return sum(v.float().sum() for v in vals if isinstance(v, torch.Tensor)
               and v.requires_grad)


@pytest.mark.parametrize("case", sorted(DISPATCH))
def test_dispatch_on_the_card(case, monkeypatch):
    """With the device check answering "cuda" and the kernels replaced by
    recorders: a call under autograd on geometry that requires grad takes
    the kernel pair, one forward launch and, after a backward, one
    backward launch; a call whose camera requires grad is refused and
    launches nothing; every other call takes the forward kernel alone, the
    viewer's and the tracker's renders on leaves that require grad
    included, and the dispatcher counts nothing more."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    calls = _recorders(monkeypatch)
    call, requires_grad, path = DISPATCH[case]
    p, cam = _model(requires_grad)
    before = LAUNCHES.copy()
    if path == "refused":
        with pytest.raises(ValueError, match="camera gradients are taken "
                                             "on the CPU"):
            call(p, cam)
    else:
        out = call(p, cam)
        if path != "kernel":
            _loss(out).backward()
    got = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
    want = dict.fromkeys(got, 0)
    want.update({"kernel": {"preprocess": 1},
                 "graph": {"preprocess": 1, "preprocess_bwd": 1},
                 "refused": {}}[path])
    assert got == want
    assert calls == {"kernel": ["preprocess"],
                     "graph": ["preprocess", "preprocess_bwd"],
                     "refused": []}[path]


def _step_inputs(lambda_dist, device="cpu"):
    """A geometry step: 400 gaussians (SH 3, a tenth dead,
    surfels 12x larger so the screen filter takes part) at 64x48, a random
    target."""
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train import camera_tensors
    st, mk = make_bench_scene(n=400, seed=7, profile="trained")
    rng = np.random.default_rng(7)
    st["scaling"] = (st["scaling"] + np.log(12.0)).astype(np.float32)
    st["features_rest"] = rng.normal(0, 0.2, (400, 15, 3)).astype(np.float32)
    st["seg_feature"] = None
    st["alive"] = rng.random(400) > 0.1
    st["active_sh_degree"] = 3
    c = mk(2, W, H)
    cam = Camera(uid=2, colmap_id=2, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
                 image_name="2", width=W, height=H,
                 image=rng.random((H, W, 3)).astype(np.float32))
    cfg = RasterizeConfig(W, H, no_depth_dist=lambda_dist == 0.0)
    return from_numpy(st, device), camera_tensors(cam, device), cfg


def _assert_close(got, want, name):
    """Within float rounding of the eager chain: 1e-5 relative, or 1e-6 of
    the field's largest |gradient|."""
    assert float(want.abs().max()) > 0, f"{name}: no gradient to compare"
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()),
                               msg=name)


@pytest.mark.parametrize("lambda_dist", [0.0, 100.0],
                         ids=["no_dist", "dist"])
def test_step_gradients_through_the_kernel_pair(lambda_dist, monkeypatch):
    """step_gradients with the kernel pair wired in (recorders computing
    the plain version) gives the eager chain's gradients for every leaf
    and for dL/dT from the t_offset tap: the Function routes each incoming
    gradient to its leaf, opacity's through pack alone. The step launches
    one forward and one backward and no eager call."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.pipelines.train import step_gradients
    params, ct, cfg = _step_inputs(lambda_dist)
    run = lambda: step_gradients(params, ct, torch.zeros(3), 0.2,
                                 lambda_dist, 0.05, 0.0, cfg, 1.0)
    want = run()
    calls = _recorders(monkeypatch)
    before = LAUNCHES.copy()
    got = run()
    assert calls == ["preprocess", "preprocess_bwd"]
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        **dict.fromkeys(LAUNCHES, 0), "preprocess": 1,
        "preprocess_bwd": 1}
    assert torch.equal(got.loss, want.loss)
    assert set(got.grads) == set(want.grads)
    for f in sorted(want.grads):
        _assert_close(got.grads[f], want.grads[f], f)
    _assert_close(got.t_grad, want.t_grad, "t_grad")


def test_override_color_keeps_its_gradient(monkeypatch):
    """A given colour bypasses the Function: render() with override_color
    on the kernel pair gives the colour, the opacity and the geometry the
    eager chain's gradients."""
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.render import render
    p, cam = _model(True)
    color = torch.rand(400, 3, generator=torch.Generator().manual_seed(3))
    color.requires_grad_(True)
    weights = torch.rand(H, W, 3, generator=torch.Generator().manual_seed(4))

    def run():
        out = render(cam, p, PipelineParams(), np.zeros(3, np.float32),
                     override_color=color)
        loss = (out["render"] * weights).sum() + out["rend_alpha"].sum()
        return torch.autograd.grad(loss, [color, p.opacity, p.xyz,
                                          p.scaling, p.rotation])

    want = run()
    calls = _recorders(monkeypatch)
    got = run()
    assert calls == ["preprocess", "preprocess_bwd"]
    for name, g, w in zip(("color", "opacity", "xyz", "scaling",
                           "rotation"), got, want):
        _assert_close(g, w, name)


@pytest.mark.parametrize("case", ["grad", "no_grad", "render_viewer"])
def test_cpu_tensors_take_the_plain_path(case):
    """CPU tensors run the plain version whatever autograd needs, and
    count no launch; its outputs keep a graph only where one was asked
    for."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    call, requires_grad, _ = DISPATCH[case]
    p, cam = _model(requires_grad)
    before = LAUNCHES.copy()
    out = call(p, cam)
    assert LAUNCHES == before
    if case == "grad":
        assert out.T.requires_grad and out.color.requires_grad
    elif case == "no_grad":
        assert not out.T.requires_grad
    else:
        assert not out["T"].requires_grad


def test_preprocess_stands_below_the_blend():
    """Importing ops/preprocess.py in a fresh interpreter loads its launch
    plumbing from cuda_build and not ops/blend_visits.py, which imports
    preprocess's constants: the two modules do not import each other."""
    code = ("import sys, instascene_tpu_torch.ops.preprocess; "
            "print(sorted(m for m in sys.modules if m in ("
            "'instascene_tpu_torch.cuda_build', "
            "'instascene_tpu_torch.ops.blend_visits')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == \
        "['instascene_tpu_torch.cuda_build']"


def test_no_gaussians_launch_nothing(monkeypatch):
    """The kernel path with no gaussians returns empty outputs and counts
    no launch (the kernel launches none)."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops import preprocess as pre
    from instascene_tpu_torch.render import camera_mats
    p, cam = _model(False)
    cm = camera_mats(cam, "cpu")
    monkeypatch.setattr(pre, "_on_card", lambda t: True)
    before = LAUNCHES.copy()
    out = pre.preprocess_gaussians(
        p.xyz[:0], p.scaling_activated()[:0], p.rotation_normalized()[:0],
        cm.w2v, cm.full_proj, cm.campos, W, H, p.opacity_activated()[:0, 0],
        shs=p.features()[:0], sh_degree=3)
    assert LAUNCHES == before
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
    from instascene_tpu_torch.cuda_build import LAUNCHES
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
    before = LAUNCHES["preprocess"]
    got = preprocess_gaussians(*args, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["preprocess"] == before + 1
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
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops.preprocess import preprocess_kernel
    s = _scene(300_000)
    cm = _camera(W, H, cuda)
    before = LAUNCHES.copy()
    preprocess_kernel(s["xyz"], s["scaling"], s["rotation"], cm.w2v,
                      cm.full_proj, cm.campos, W, H, s["opacity"],
                      shs=s["shs"], sh_degree=3)
    want = dict(before, preprocess=before["preprocess"] + 1)
    assert LAUNCHES == want


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


# ---- the backward kernel on the card

# (gaussians, sizes): waldo's, barn's and garden's
GRAD_SCENES = {"waldo": (300_000, ((976, 728), (1920, 1080))),
               "barn": (1_660_000, ((960, 540),)),
               "garden": (2_960_000, ((1297, 840),))}
GRAD_CASES = [(name, size) for name, (_, sizes) in GRAD_SCENES.items()
              for size in sizes]
DEGENERATE = 1000   # the scene's last gaussians, in blocks of 200


@functools.lru_cache(maxsize=1)
def _trained(n):
    """The `trained` profile at n gaussians on the card, as render() hands
    it to preprocess (activated, normalised, SH 3 with random rest
    coefficients, a tenth dead), its last DEGENERATE gaussians in blocks:
    behind the camera, at scales so large that T's products overflow (the
    box's divisor not taken, d_ok false, and where two of the centre's
    overflowed terms cancel, a non-finite centre), and with colours clamped
    at 0. Returns (inputs, the degenerate-scale rows, the camera maker)."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    st, mk = make_bench_scene(n=n, seed=1, profile="trained")
    st["seg_feature"] = None
    p = from_numpy(st, "cuda")
    del st
    g = torch.Generator(device="cuda").manual_seed(n)
    p.features_rest.copy_(torch.randn(p.features_rest.shape, generator=g,
                                      device="cuda") * 0.2)
    p.alive.copy_(torch.rand(n, generator=g, device="cuda") > 0.1)
    x = dict(xyz=p.xyz.clone(), scaling=p.scaling_activated(),
             rotation=p.rotation_normalized(),
             opacity=p.opacity_activated()[:, 0], shs=p.features(),
             alive=p.alive.clone())
    eye = torch.as_tensor(np.asarray(mk(0, 64, 48).camera_center,
                                     np.float32), device="cuda")
    d = n - DEGENERATE
    x["xyz"][d:d + 200] = 2 * eye - x["xyz"][d:d + 200]       # behind
    x["scaling"][d + 200:d + 400] = 3e19                      # overflow
    x["shs"][d + 400:d + 600, 0] = -4.0                       # colour 0
    return x, slice(d + 200, d + 400), mk


def _grad_inputs(name, size, deg):
    """Inputs, the camera and one set of incoming gradients (seeded), zero
    on the overflowing rows as a step gives them: such gaussians fall in
    no tile (where one did not, float32 autograd through the eager chain
    would give it NaN)."""
    from instascene_tpu_torch.render import camera_mats
    n = GRAD_SCENES[name][0]
    x, huge, mk = _trained(n)
    width, height = size
    cm = camera_mats(mk(0, width, height), "cuda")
    args = (x["xyz"], x["scaling"], x["rotation"], cm.w2v, cm.full_proj,
            cm.campos, width, height, x["opacity"], None, x["shs"], deg,
            x["alive"], None, None)
    g = torch.Generator(device="cuda").manual_seed(n + width + deg)
    rn = lambda *s: torch.randn(s, generator=g, device="cuda")
    grads = [rn(n, 3, 3), rn(n, 3), rn(n), rn(n, 2), rn(n, 3)]
    for gr in grads:
        gr[huge] = 0.0
    return args, grads


class _Torch64:
    """torch with float32 standing for float64: preprocess_plain's
    arithmetic in double where the module names torch.float32."""
    float32 = torch.float64

    def __getattr__(self, name):
        return getattr(torch, name)


def _autograd(args, grads, double=False, monkeypatch=None):
    """autograd's gradients of preprocess_plain for xyz, scaling, rotation
    and shs, in float32 or (double) in float64 throughout."""
    from instascene_tpu_torch.ops import preprocess as pre
    args = list(args)
    if double:
        args = [a.double() if isinstance(a, torch.Tensor)
                and a.is_floating_point() else a for a in args]
        grads = [gr.double() for gr in grads]
        monkeypatch.setattr(pre, "torch", _Torch64())
        monkeypatch.setattr(pre, "fma", lambda a, b, c: a * b + c)
    leaves = [args[i].detach().requires_grad_(True) for i in (0, 1, 2, 10)]
    for i, leaf in zip((0, 1, 2, 10), leaves):
        args[i] = leaf
    out = pre.preprocess_plain(*args)
    if double:
        monkeypatch.undo()
        assert out.T.dtype == torch.float64
    got = torch.autograd.grad(
        [out.T, out.normal_view, out.depth, out.xy, out.color], leaves,
        grads, allow_unused=True)
    return [torch.zeros_like(x) if gr is None else gr
            for gr, x in zip(got, leaves)]


def _rel(a, b):
    """Relative L2 gap of a to b."""
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


LEAVES = ("xyz", "scaling", "rotation", "shs")


@pytest.mark.cuda
@pytest.mark.parametrize("deg", [0, 1, 2, 3])
@pytest.mark.parametrize("case", GRAD_CASES,
                         ids=[f"{n}-{w}x{h}" for n, (w, h) in GRAD_CASES])
def test_backward_matches_autograd(case, deg, cuda, monkeypatch):
    """The kernel pair under autograd on the benchmark's sizes: the
    forward's outputs bit for bit the eager chain's; each leaf's gradient
    within 1e-5 (relative L2) of float32 autograd through the eager chain,
    and no further from float64 autograd than twice the float32 chain's
    own gap, plus 1e-7; coefficients above the degree get exact zeros.
    One forward and one backward launch."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops.preprocess import (preprocess_gaussians,
                                                     preprocess_plain)
    name, size = case
    args, grads = _grad_inputs(name, size, deg)
    leaves = [args[i].detach().requires_grad_(True) for i in (0, 1, 2, 10)]
    kargs = list(args)
    for i, leaf in zip((0, 1, 2, 10), leaves):
        kargs[i] = leaf
    before = LAUNCHES.copy()
    out = preprocess_gaussians(*kargs[:9], shs=kargs[10], sh_degree=deg,
                               alive=kargs[12])
    got = torch.autograd.grad(
        [out.T, out.normal_view, out.depth, out.xy, out.color], leaves,
        grads)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        **dict.fromkeys(LAUNCHES, 0), "preprocess": 1,
        "preprocess_bwd": 1}
    with torch.no_grad():
        want_fwd = preprocess_plain(*args)
    bad = [f for f in FIELDS if not _same_bits(getattr(out, f).detach(),
                                               getattr(want_fwd, f))]
    assert not bad, f"fields differing from the eager chain: {bad}"
    del want_fwd
    eager = _autograd(args, grads)
    exact = _autograd(args, grads, double=True, monkeypatch=monkeypatch)
    for leaf, k, e, x in zip(LEAVES, got, eager, exact):
        assert bool(torch.isfinite(k).all()), f"{leaf}: not finite"
        gap, own = _rel(k, e), _rel(e, x)
        assert gap <= 1e-5, f"{leaf}: {gap:.3g} from float32 autograd"
        assert _rel(k, x) <= 2 * own + 1e-7, (
            f"{leaf}: {_rel(k, x):.3g} from float64 autograd, the eager "
            f"chain {own:.3g}")
    assert not got[3][:, (deg + 1) ** 2:].any()


@pytest.mark.cuda
def test_backward_without_sh_or_some_gradients(cuda):
    """A given colour (no SH: no shs gradient, the colour's own passing
    by), and outputs that took no gradient (None) read as zeros: the
    kernel against autograd through the eager chain."""
    from instascene_tpu_torch.ops.preprocess import (preprocess_bwd_kernel,
                                                     preprocess_plain)
    args, grads = _grad_inputs("waldo", (976, 728), 3)
    args = list(args)
    args[10] = None
    leaves = [args[i].detach().requires_grad_(True) for i in (0, 1, 2)]
    pargs = list(args)
    for i, leaf in enumerate(leaves):
        pargs[i] = leaf
    pargs[9] = torch.zeros_like(args[0])
    out = preprocess_plain(*pargs)
    want = torch.autograd.grad([out.T, out.xy], leaves,
                               [grads[0], grads[3]])
    got = preprocess_bwd_kernel(args, (grads[0], None, None, grads[3],
                                       grads[4]))
    assert got[3] is None
    for leaf, k, w in zip(LEAVES, got, want):
        assert _rel(k, w) <= 1e-5, leaf


@pytest.mark.cuda
def test_geometry_step_launches_the_pair(cuda):
    """One geometry train_step on the card: one forward launch, one
    backward launch."""
    from instascene_tpu_torch.models import densify as dens
    from instascene_tpu_torch.models.optimizer import init_adam_state
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.pipelines.train import train_step
    params, ct, cfg = _step_inputs(0.0, cuda)
    lrs = {"xyz": 1.6e-4, "features_dc": 2.5e-3,
           "features_rest": 2.5e-3 / 20, "opacity": 0.05, "scaling": 5e-3,
           "rotation": 1e-3, "seg_feature": 0.0}
    before = LAUNCHES.copy()
    train_step(params, init_adam_state(params),
               dens.init_stats(params.capacity, cuda), ct,
               torch.zeros(3, device=cuda), lrs, 0.2, 0.0, 0.05, 0.0, cfg,
               1.0)
    torch.cuda.synchronize()
    got = {k: LAUNCHES[k] - before[k] for k in
           ("preprocess", "preprocess_bwd")}
    assert got == {"preprocess": 1, "preprocess_bwd": 1}


@pytest.mark.cuda
def test_backward_refuses_what_it_does_not_take(cuda):
    from instascene_tpu_torch.ops.preprocess import preprocess_bwd_kernel
    args, grads = _grad_inputs("waldo", (976, 728), 3)
    with pytest.raises(ValueError, match="dT"):
        preprocess_bwd_kernel(args, [grads[0][:-1]] + grads[1:])
    with pytest.raises(ValueError, match="not in 0-3"):
        preprocess_bwd_kernel(args[:11] + (4,) + args[12:], grads)
    with pytest.raises(ValueError, match="coefficients"):
        preprocess_bwd_kernel(args[:10] + (args[10][:, :4],) + args[11:],
                              grads)
    with pytest.raises(ValueError, match="scaling"):
        preprocess_bwd_kernel((args[0].cpu(),) + args[1:], grads)
