"""The port's differentiable rasterizer and geometry train step against the
JAX package on the same seeded numpy inputs: rasterize gradients through K2's
plain version against jax.grad through JAX's rasterize (its CPU blend), and
one train_step in both recipes (the reference defaults, where the kernels run
no_dist, and the 2DGS bounded-scene recipe with a mono-normal prior)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

W, H = 64, 48
N = 300
FIELDS_TRAINED = ("xyz", "features_dc", "features_rest", "scaling",
                  "rotation", "opacity")


def _state(seed=4, boost=12.0, n_dead=10):
    """The benchmark scene's `trained` profile at N gaussians, surfels
    `boost` times larger (so both the ray-splat and the screen-filter
    branches take part), SH 3 with random rest coefficients, no features,
    the last n_dead slots dead."""
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    st, mk = make_bench_scene(n=N, seed=seed, profile="trained")
    rng = np.random.default_rng(seed)
    st["scaling"] = (st["scaling"] + np.log(boost)).astype(np.float32)
    st["features_rest"] = rng.normal(0, 0.2, (N, 15, 3)).astype(np.float32)
    st["seg_feature"] = None
    st["alive"] = np.arange(N) < N - n_dead
    return st, mk


def _jax_params(st):
    from instascene_tpu.models.gaussians import GaussianParams
    return GaussianParams(**{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                 else v) for k, v in st.items()})


def _jax_cfg():
    from instascene_tpu.ops.rasterize import RasterizeConfig
    return RasterizeConfig(width=W, height=H, chunk=16, pair_cap=65536,
                           tile_cap=256)


@pytest.mark.parametrize("no_dist", [False, True], ids=["full", "no_dist"])
def test_rasterize_grads_match_jax(no_dist):
    """Gradients of one random weighted sum of the rasterizer's maps with
    respect to xyz, opacity, scales, rotations and SH, within 3e-3 (`full`)
    / 5e-3 (`no_dist`) of each field's largest |gradient| — the JAX suite's
    own tolerances between its blends. In no_dist the sum leaves out the
    depth and distortion maps, which that mode does not compute."""
    from instascene_tpu.ops.rasterize import CameraMats as JMats
    from instascene_tpu.ops.rasterize import rasterize as jrasterize
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    st, mk = _state()
    cam = mk(2, W, H)
    rng = np.random.default_rng(7)
    wts = {k: rng.normal(size=s).astype(np.float32) for k, s in (
        ("color", (H, W, 3)), ("depth", (H, W)), ("alpha", (H, W)),
        ("normal", (H, W, 3)), ("median_depth", (H, W)),
        ("distortion", (H, W)))}
    if no_dist:
        del wts["depth"], wts["distortion"]
    alive = st["alive"]
    inputs = dict(
        xyz=st["xyz"], scales=np.exp(st["scaling"]),
        rot=st["rotation"] / np.linalg.norm(st["rotation"], axis=1,
                                            keepdims=True),
        opac=(1 / (1 + np.exp(-st["opacity"][:, 0]))).astype(np.float32),
        shs=np.concatenate([st["features_dc"], st["features_rest"]], 1))
    bg = np.array([0.1, 0.2, 0.3], np.float32)

    def jloss(a):
        out = jrasterize(a["xyz"], a["scales"], a["rot"], a["opac"],
                         JMats(jnp.asarray(cam.w2v), jnp.asarray(cam.full_proj),
                               jnp.asarray(cam.camera_center)),
                         jnp.asarray(bg), _jax_cfg(), shs=a["shs"],
                         sh_degree=3, alive=jnp.asarray(alive))
        return sum(jnp.sum(getattr(out.blend, k) * w) for k, w in wts.items())

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in inputs.items()})
    leaves = {k: torch.as_tensor(v).requires_grad_(True)
              for k, v in inputs.items()}
    cm = CameraMats(*(torch.as_tensor(np.asarray(a, np.float32)) for a in
                      (cam.w2v, cam.full_proj, cam.camera_center)))
    out = rasterize(leaves["xyz"], leaves["scales"], leaves["rot"],
                    leaves["opac"], cm, bg,
                    RasterizeConfig(W, H, no_depth_dist=no_dist),
                    shs=leaves["shs"], sh_degree=3,
                    alive=torch.as_tensor(alive))
    loss = sum((getattr(out.blend, k) * torch.as_tensor(w)).sum()
               for k, w in wts.items())
    loss.backward()
    tol = 5e-3 if no_dist else 3e-3
    for k, leaf in leaves.items():
        g, want = leaf.grad.numpy(), np.asarray(jg[k])
        assert np.isfinite(g).all(), k
        assert not g[~alive].any(), f"{k}: a dead slot has a gradient"
        scale = np.abs(want).max()
        assert scale > 0, k
        err = np.abs(g - want).max()
        assert err <= tol * scale, (k, err, scale)


def _warm_adam(st, seed=9):
    """A warm Adam state (count 100, moments that the step's gradients
    perturb), so the step's update is smooth in the gradients instead of
    the sign of each one, as Adam's first step is."""
    rng = np.random.default_rng(seed)
    m = {f: (rng.normal(size=st[f].shape) * 1e-3).astype(np.float32)
         for f in FIELDS_TRAINED}
    v = {f: ((np.abs(rng.normal(size=st[f].shape)) + 0.5) * 1e-3
             ).astype(np.float32) ** 2 for f in FIELDS_TRAINED}
    return m, v, 100


RECIPES = {
    # the reference defaults: lambda_dist 0, depth_ratio 1 (kernels no_dist)
    "no_dist": dict(lambda_dist=0.0, depth_ratio=1.0, prior=False),
    # 2DGS bounded scenes (--lambda_dist 100 --depth_ratio 0), with a
    # mono-normal prior
    "dist_prior": dict(lambda_dist=100.0, depth_ratio=0.0, prior=True),
}


@pytest.mark.parametrize("recipe", list(RECIPES))
def test_train_step_matches_jax(recipe):
    """One geometry train step: loss at rtol 1e-4, every updated parameter
    within 5e-3, the densification stats (from the t_offset tap) within 2e-3
    of their largest value, visibility counts and radii equal."""
    from instascene_tpu.cameras import Camera as JCamera
    from instascene_tpu.models import densify as jdens
    from instascene_tpu.models.optimizer import AdamState as JAdam
    from instascene_tpu.models.optimizer import init_adam_state as jinit
    from instascene_tpu.pipelines import train as jtrain
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.models import densify as dens
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.models.optimizer import AdamState
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines import train as ttrain
    rc = RECIPES[recipe]
    st, mk = _state()
    c = mk(3, W, H)
    rng = np.random.default_rng(21)
    gt = rng.random((H, W, 3)).astype(np.float32)
    normal = None
    if rc["prior"]:
        normal = rng.normal(size=(H, W, 3)).astype(np.float32)
        normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
        normal[::5] *= 1.5           # some pixels outside the prior's mask
    kw = dict(uid=3, colmap_id=3, R=c.R, T=c.T, fovx=c.fovx, fovy=c.fovy,
              image_name="3", width=W, height=H, image=gt, normal=normal)
    jct = jtrain.camera_tensors(JCamera(**kw))
    tct = ttrain.camera_tensors(Camera(**kw), "cpu")
    m, v, count = _warm_adam(st)
    stats0 = [np.random.default_rng(5).random(N).astype(np.float32) * s
              for s in (1e-3, 3.0, 5.0)]
    lrs = {"xyz": 1.6e-4 * 4.4, "features_dc": 2.5e-3,
           "features_rest": 2.5e-3 / 20, "opacity": 0.05, "scaling": 5e-3,
           "rotation": 1e-3, "seg_feature": 0.0}
    lam = dict(lambda_dssim=0.2, lambda_dist=rc["lambda_dist"],
               lambda_normal=0.05,
               lambda_normal_prior=0.1 if rc["prior"] else 0.0)
    bg = np.zeros(3, np.float32)

    jp = _jax_params(st)
    jopt = jinit(jp)
    jopt = JAdam(m=jopt.m.replace(**{f: jnp.asarray(a) for f, a in m.items()}),
                 v=jopt.v.replace(**{f: jnp.asarray(a) for f, a in v.items()}),
                 count=jnp.asarray(count, jnp.int32))
    dummy = jnp.zeros(1)
    jp2, jopt2, jst2, jm = jtrain.train_step(
        jp, jopt, jdens.DensifyStats(*map(jnp.asarray, stats0)),
        jct.w2v, jct.full_proj, jct.campos, jct.c2w_rot, jct.gt_image,
        jct.normal_prior if rc["prior"] else dummy,
        jct.normal_mask if rc["prior"] else dummy, jnp.asarray(bg),
        {k: jnp.float32(x) for k, x in lrs.items()},
        *(jnp.float32(lam[k]) for k in ("lambda_dssim", "lambda_dist",
                                        "lambda_normal",
                                        "lambda_normal_prior")),
        _jax_cfg(), jct.tanfovx, jct.tanfovy, rc["depth_ratio"],
        rc["prior"])

    tp = from_numpy(st, "cpu")
    t = lambda d: {f: torch.as_tensor(a) for f, a in d.items()}
    stages = []
    cfg = RasterizeConfig(W, H, no_depth_dist=recipe == "no_dist")
    tp2, topt2, tst2, tm = ttrain.train_step(
        tp, AdamState(m=t(m), v=t(v), count=count),
        dens.DensifyStats(*map(torch.as_tensor, stats0)), tct,
        torch.as_tensor(bg), lrs, cfg=cfg, depth_ratio=rc["depth_ratio"],
        on_stage=stages.append, **lam)

    assert stages == ["render", "loss", "backward", "adam"]
    assert topt2.count == count + 1 == int(jopt2.count)
    for k in ("loss", "ll1", "dist", "normal"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                   atol=1e-7, err_msg=k)
    assert tm["total_pairs"] > 0
    for f in FIELDS_TRAINED:
        got, want = getattr(tp2, f).numpy(), np.asarray(getattr(jp2, f))
        np.testing.assert_allclose(got, want, atol=5e-3, rtol=0, err_msg=f)
        moved = got != st[f]
        assert not moved[~st["alive"]].any(), f"{f}: a dead slot moved"
    np.testing.assert_array_equal(tst2.denom.numpy(), np.asarray(jst2.denom))
    np.testing.assert_array_equal(tst2.max_radii2d.numpy(),
                                  np.asarray(jst2.max_radii2d))
    acc, jacc = tst2.xyz_gradient_accum.numpy(), np.asarray(
        jst2.xyz_gradient_accum)
    grew = jacc - stats0[0]
    assert grew.max() > 0, "the t_offset tap gave no densification grads"
    np.testing.assert_allclose(acc - stats0[0], grew,
                               atol=2e-3 * grew.max(), rtol=0)
