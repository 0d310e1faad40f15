#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (instascene_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA GPU and nvcc. It
imports nothing of JAX or of the JAX package. Phases, each printing its own
lines; any failure exits non-zero and prints no result:

1. device and build: the card's name and power limit, then the CUDA kernels
   built from instascene_tpu_torch/csrc/ (nvcc, sm_90a) and the seconds it
   took;
2. kernel vs plain: the rasterizer on the card against the JAX package's
   goldens (tests/goldens/forward.npz); K1 (ops/blend_visits.blend_fwd)
   against its plain PyTorch version (blend_fwd_reference) on the same
   inputs on the card, in `full` mode with E=16 and E=0, in `viewer` mode
   with E=16 and in `no_dist` mode with E=0, on a mid-size scene (n_contrib
   exactly equal), and `full`/`viewer` on the first full-width frame
   (n_contrib mismatches at most 1e-5 of the pixels), with its time and its
   bound there; K2 (blend_bwd) and the per-gaussian segment sum
   (reduce_per_gaussian) against their plain versions on one random
   cotangent, `full` and `no_dist`, E=0 and E=16, mid-size, each run twice
   (d_flat bit for bit equal);
3. the serving path at full width: the 300k-gaussian, SH-3, 16-channel
   `trained` benchmark scene is written to a PLY and served by the port's
   headless click-to-segment CLI (semantic_gui.main) at 1920x1080 — a depth
   preview (full blend), then two clicks → segment → save — then four more
   orbit frames through SegmentationEngine.render_view. Launch counts are
   reset just before and read just after; K1 must have launched.
4. the training frame at 976x728 (the repo's geometry benchmark size, same
   scene without features): K1 no_dist, K2 in both modes and the segment
   sum against their plain versions, timed, with their bounds;
5. the training path at full width, launch counts reset just before and
   read just after: train_step on that scene (3 warm-up steps, then 20
   timed steps with the reference defaults, K1/K2 no_dist, and 10 with the
   2DGS bounded-scene recipe, lambda_dist 100 and depth_ratio 0), with the
   stage split of each step; then the training CLI (train.main) on a COLMAP
   scene written with the port's writers (8 orbit cameras with PNG images
   rendered by the port, the 300k centres as points3D.bin) for 30
   iterations with densification at 20 and 30 (at the thresholds of
   CLI_DENSIFY; each also prints what the reference's would leave), a test
   report at 10 and 30,
   a save and a checkpoint at 30, and a resume from the checkpoint. K1 and
   K2 must have launched; n_alive must grow, PSNR must rise, the PLY must
   load back.
6. one JSON line with the kernels' numbers, then the last line
   {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"          # a CPU rehearsal of the script's flow sets "cpu"

# tolerances, kernel vs plain version (the JAX suite's own, between its
# Pallas and XLA blends): rows of out[T, 12+E, 256]
TOL = {"color": 3e-4, "depth": 3e-3, "normal": 3e-4, "median": 3e-3,
       "distortion": 3e-3, "final_T": 2e-5, "features": 5e-4, "m1m2": 3e-3}
MID = dict(n=20_000, width=512, height=384)
FULL = dict(n=300_000, width=1920, height=1080)
# the geometry benchmark (bench.py:332-403): 976x728, four orbit cameras,
# a seeded random target, lambda (dssim 0.2, dist 0 or 100, normal 0.05)
TRAIN = dict(width=976, height=728, cams=4, warm=3, steps=20, dist_steps=10)
CLI_CAMS, CLI_ITERS = 8, 30
# 30 iterations from the 300k centres (most of them occluded inside their
# clusters) leave the mean view-space gradient at a median of ~2e-7 and a
# 99th percentile of ~1.5e-5: at the reference's 2e-4 about 15 gaussians
# densify, while its opacity cull of 0.05 prunes ~15k that the first
# iterations push below it. The CLI therefore runs at a tenth of the
# threshold and at 3DGS's cull of 0.005, which no gaussian starting at
# opacity 0.1 can reach in 30 iterations: its logit would have to fall by
# 3.1, and 30 Adam steps at the opacity learning rate of 0.05 move it by
# less than 2. Each densification also prints the n_alive the same step
# would leave at the reference's thresholds (REF_DENSIFY), unchecked:
# densification at the reference's gradient threshold is held to JAX's only
# on the CPU (tests/test_torch_train_host.py::test_densify_and_prune_matches,
# identical inputs).
CLI_DENSIFY = ["--densify_grad_threshold", "2e-5", "--opacity_cull", "0.005"]
REF_DENSIFY = (2e-4, 0.05)
# K2 vs plain: per column, the largest |kernel − plain| over the column's
# largest |value| (the sums over a tile's pixels run in another order)
K2_TOL = 1e-4
CLICKS = "960,540,760,470"
# the synthetic scene's seg features are all-positive random vectors
# (cosine ~0.75 between instances), so a click at the default 0.7 score
# threshold selects nearly every gaussian; trained features separate
# instances, which a threshold of 0.95 models here
SCORE_THRESHOLD = "0.95"
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, FP32 SIMT FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
# FP32 operations of K1, counted from csrc/blend_fwd.cu (an fma counts 2,
# expf, a division, a compare or a min/max 1): each evaluated (pair, pixel)
# does the splat and its mask; each contribution adds the done test, the
# weight, color and E features, and in `full` mode depth, normal, distortion
# and median
OPS_EVAL = 41
OPS_HIT = 10             # + 2 per feature channel, + OPS_HIT_MODE[mode]
OPS_HIT_MODE = {"full": 25, "no_dist": 10, "viewer": 0}
# FP32 operations of K2, counted from csrc/blend_bwd.cu the same way: each
# (slot, pixel) up to the pixel's n_contrib re-evaluates the splat; each
# contribution recovers T, forms dL/dw, dL/dalpha, dL/drho and the 21+E
# column terms (+ 3 per feature channel, + the distortion and expected-depth
# chains in `full`); a slot's row sums the terms of the pixels that
# contribute to it, c - 1 additions per column for c of them (the kernel's
# 256-wide block reduction adds more, but the function needs only these)
OPS_BWD_HIT = 54
OPS_BWD_HIT_E = 3
OPS_BWD_HIT_FULL = 24


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def row_errors(out_k, out_r, E, mode, agree):
    """Max |kernel − plain| per output group over pixels where n_contrib
    agrees; returns {group: (err, tol)}."""
    groups = {"color": [0, 1, 2], "final_T": [9],
              "features": list(range(10, 10 + E))}
    if mode != "viewer":
        groups.update({"normal": [4, 5, 6], "median": [7]})
    if mode == "full":
        groups.update({"depth": [3], "distortion": [8],
                       "m1m2": [10 + E, 11 + E]})
    errs = {}
    for name, rows in groups.items():
        if not rows:
            continue
        d = (out_k[:, rows] - out_r[:, rows]).abs()
        d = d.masked_fill(~agree[:, None, :], 0.0)
        errs[name] = (float(d.max()), TOL[name])
    return errs


def frame_stages(p, cam, width, height, with_extras):
    """The stages of one frame before K1, as calls over the state's
    activated tensors (activations are not part of any stage): returns
    (preprocess(), bin(pre), pack(pre))."""
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, p.device)
    opac = p.opacity_activated()[:, 0]
    args = (p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
            cm.full_proj, cm.campos, width, height, opac)
    kw = dict(shs=p.features(), sh_degree=p.active_sh_degree, alive=p.alive)
    extras = p.seg_feature_normed() if with_extras else None
    return (lambda: preprocess_gaussians(*args, **kw),
            lambda pre: bin_gaussians(pre, width, height),
            lambda pre: pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac,
                                       pre.color, extras))


def frame_inputs(p, cam, width, height, with_extras):
    """Preprocess + bin + pack of one frame, on the state's device."""
    preprocess, binning, pack = frame_stages(p, cam, width, height,
                                             with_extras)
    pre = preprocess()
    return pack(pre), binning(pre), (width + 15) // 16


def stage_ms(p, cam, width, height):
    """Median CUDA-event ms of render()'s stages for one viewer frame:
    preprocess (with SH), binning (pair expand + sort; one host read),
    pack."""
    preprocess, binning, pack = frame_stages(p, cam, width, height, True)
    pre = preprocess()
    return {"preprocess": time_ms(preprocess, 3),
            "binning": time_ms(lambda: binning(pre), 3),
            "pack": time_ms(lambda: pack(pre), 3)}


def time_ms(fn, reps):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def compare_kernel(label, flat, b, grid_x, E, mode, exact, timing=False):
    import torch
    from instascene_tpu_torch.ops.blend_visits import (blend_fwd,
                                                       blend_fwd_reference)
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    kw = dict(viewer=mode == "viewer", no_dist=mode == "no_dist")
    out_k, iout_k = blend_fwd(*args, **kw)
    torch.cuda.synchronize()
    out_r, iout_r, n_eval, n_hit = blend_fwd_reference(
        *args, count_work=True, **kw)
    torch.cuda.synchronize()
    nc_k, nc_r = iout_k[:, 0], iout_r[:, 0]
    agree = nc_k == nc_r
    n_pix = agree.numel()
    mism = int((~agree).sum())
    errs = row_errors(out_k, out_r, E, mode, agree)
    slot_mism = (0 if mode == "viewer" else
                 int(((iout_k[:, 1] != iout_r[:, 1]) & agree).sum()))
    print(f"[kernel] {label} {mode} E={E}: pairs={b.total_pairs} "
          f"n_contrib mismatches={mism}/{n_pix} med_slot mismatches="
          f"{slot_mism} " + " ".join(f"{k}={v[0]:.3g}(tol {v[1]:g})"
                                     for k, v in errs.items()), flush=True)
    check(bool(torch.isfinite(out_k).all()), f"{label}: non-finite output")
    if exact:
        check(mism == 0, f"{label} {mode} E={E}: n_contrib differs")
    else:
        check(mism <= 1e-5 * n_pix,
              f"{label} {mode} E={E}: {mism} n_contrib mismatches")
    check(slot_mism == 0, f"{label} {mode} E={E}: med_slot differs")
    # rows a mode does not compute stay exact zeros
    zero = {"viewer": [3, 4, 5, 6, 7, 8, 10 + E, 11 + E],
            "no_dist": [3, 8, 10 + E, 11 + E], "full": []}[mode]
    if zero:
        check(not out_k[:, zero].any() and not out_r[:, zero].any(),
              f"{label} {mode} E={E}: a row it does not compute is nonzero")
    if mode == "viewer":
        check(not iout_k[:, 1].any(), f"{label} viewer: med_slot written")
    for k, (err, tol) in errs.items():
        check(err <= tol, f"{label} {mode} E={E}: {k} error {err} > {tol}")
    res = {"max_abs_err": max(e for e, _ in errs.values()), "mism": mism}
    if timing:
        res["ms"] = time_ms(lambda: blend_fwd(*args, **kw), 20)
        res["plain_ms"] = time_ms(
            lambda: blend_fwd_reference(*args, **kw), 1)
        res.update(k1_bound(flat, b, E, mode, n_eval, n_hit))
    return res


def k1_bound(flat, b, E, mode, n_eval, n_hit):
    """Least time for K1's work on these inputs: each input read once and
    each output written once over HBM bandwidth, against the FP32
    operations these inputs need at the FP32 SIMT peak — every pixel
    evaluates its tile's slots until it latches done (n_eval), and
    contributes n_hit times."""
    import torch
    nt = b.tile_start.numel()
    bytes_ = (flat.numel() * 4 + b.sorted_gid.numel() * 4 + 2 * nt * 4
              + nt * (12 + E) * 256 * 4 + nt * 2 * 256 * 4)
    evals = int(n_eval.sum(dtype=torch.int64))
    hits = int(n_hit.sum(dtype=torch.int64))
    ops = evals * OPS_EVAL + hits * (OPS_HIT + 2 * E + OPS_HIT_MODE[mode])
    return dict(bound(bytes_, ops), evals=evals, hits=hits,
                max_evals=b.total_pairs * 256)


def bound(bytes_, ops):
    """The larger of bytes over the HBM rate and FP32 operations over the
    FP32 SIMT peak, in ms."""
    t_bytes = bytes_ / HBM_BPS
    t_ops = ops / FP32_FLOPS
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_, "ops": ops}


def col_rel_err(got, want):
    """Per column, max |got − want| over the column's max |want|; the
    largest over the columns."""
    scale = want.abs().amax(dim=0).clamp(min=1e-30)
    return float(((got - want).abs().amax(dim=0) / scale).max())


def compare_k2(label, flat, b, grid_x, E, no_dist, timing=False):
    """K2 and the segment sum on the card against their plain versions on
    the same inputs (K1's own forward, one seeded random cotangent), then
    both kernels a second time: d_sorted and d_flat bit for bit equal."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    mode = "no_dist" if no_dist else "full"
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    out, iout = bv.blend_fwd(*args, no_dist=no_dist)
    saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                        dim=1).contiguous()
    gen = torch.Generator(device=flat.device).manual_seed(5 + E)
    gout = torch.randn(out.shape, generator=gen, device=flat.device)
    n = flat.shape[0]
    runs = (b.gid_order, b.run_start)
    bwd = (*args, gout, saved, iout)
    d1 = bv.blend_bwd(*bwd, no_dist=no_dist)
    f1 = bv.reduce_per_gaussian(d1, b.sorted_gid, n, runs)
    d2 = bv.blend_bwd(*bwd, no_dist=no_dist)
    f2 = bv.reduce_per_gaussian(d2, b.sorted_gid, n, runs)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2) and torch.equal(f1, f2))
    d_ref, (evals, hits, slots) = bv.blend_bwd_reference(
        *bwd, no_dist=no_dist, count_work=True)
    f_ref = bv.reduce_per_gaussian_reference(d_ref, b.sorted_gid, n)
    torch.cuda.synchronize()
    err_rows, err_flat = col_rel_err(d1, d_ref), col_rel_err(f1, f_ref)
    print(f"[kernel] {label} K2 {mode} E={E}: pairs={b.total_pairs} "
          f"(slot, pixel) evaluations={evals} contributions={hits} slots "
          f"reduced={slots}; per-slot rows {err_rows:.3g}, d_flat "
          f"{err_flat:.3g} of each column's max |value| (tol {K2_TOL:g}); "
          f"two runs bit for bit equal: {same}", flush=True)
    check(bool(torch.isfinite(d1).all() and torch.isfinite(f1).all()),
          f"{label} K2 {mode} E={E}: non-finite gradients")
    check(hits > 0, f"{label} K2 {mode} E={E}: no contribution")
    check(err_rows <= K2_TOL and err_flat <= K2_TOL,
          f"{label} K2 {mode} E={E}: rows {err_rows}, d_flat {err_flat}")
    check(same, f"{label} K2 {mode} E={E}: two runs differ")
    res = {"max_abs_err": float((d1 - d_ref).abs().max()),
           "flat_max_abs_err": float((f1 - f_ref).abs().max()),
           "rel_err": max(err_rows, err_flat)}
    if timing:
        D = 21 + E
        nt = b.tile_start.numel()
        pairs = b.sorted_gid.numel()
        res["ms"] = time_ms(lambda: bv.blend_bwd(*bwd, no_dist=no_dist), 20)
        res["plain_ms"] = time_ms(lambda: bv.blend_bwd_reference(
            *bwd, no_dist=no_dist), 1)
        bytes_ = (flat.numel() * 4 + pairs * 4 + 2 * nt * 4
                  + nt * (12 + E + 3 + 2) * 256 * 4 + pairs * D * 4)
        ops = (evals * OPS_EVAL
               + hits * (OPS_BWD_HIT + OPS_BWD_HIT_E * E
                         + (0 if no_dist else OPS_BWD_HIT_FULL))
               + (hits - slots) * D)
        res.update(bound(bytes_, ops), evals=evals, hits=hits, slots=slots)
        gid64 = b.sorted_gid.to(torch.int64)
        acc = torch.zeros((n, D), dtype=torch.float32, device=flat.device)
        seg = {"ms": time_ms(lambda: bv.reduce_per_gaussian(
                   d1, b.sorted_gid, n, runs), 20),
               "plain_ms": time_ms(lambda: bv.reduce_per_gaussian_reference(
                   d1, b.sorted_gid, n), 20),
               "library_ms": time_ms(lambda: acc.index_add_(0, gid64, d1),
                                     20),
               "max_abs_err": res["flat_max_abs_err"]}
        seg.update(bound(pairs * D * 4 + pairs * 4 + (n + 1) * 4
                         + n * D * 4, pairs * D))
        res["segment_sum"] = seg
    return res


def golden_check(dev):
    """The rasterizer on the card (K1 full) against the committed goldens
    of the JAX package's forward pass, at the golden test's own tolerances
    (tests/test_rasterizer.py), n_contrib exactly. The goldens have 4
    feature channels and the kernel is built for 0 or 16, so the features
    go in zero-padded to 16 (the padding must come out zero)."""
    import torch
    from instascene_tpu_torch.cameras import Camera
    from instascene_tpu_torch.data.synthetic import look_at
    from instascene_tpu_torch.ops.rasterize import (CameraMats,
                                                    RasterizeConfig,
                                                    rasterize)
    g = np.load(os.path.join(ROOT, "tests", "goldens", "forward.npz"))
    W, H = int(g["W"]), int(g["H"])
    R_w2c, t = look_at(np.array([0.0, -3.5, 1.0]), np.zeros(3))
    cam = Camera(uid=0, colmap_id=0, R=R_w2c.T, T=t, fovx=0.9, fovy=0.65,
                 image_name="g", width=W, height=H)
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    e = g["inputs_extra"].shape[1]
    extras = np.zeros((int(g["n"]), 16), np.float32)
    extras[:, :e] = g["inputs_extra"]
    out = rasterize(f(g["inputs_xyz"]), f(g["inputs_scales"]),
                    f(g["inputs_rots"]), f(g["inputs_opac"]),
                    CameraMats(f(cam.w2v), f(cam.full_proj),
                               f(cam.camera_center)),
                    [0.1, 0.2, 0.3], RasterizeConfig(W, H),
                    colors=f(g["inputs_color"]), extras=f(extras))
    worst = 0.0
    for key in ("color", "depth", "alpha", "normal", "median_depth",
                "distortion", "extra", "final_T"):
        got = getattr(out.blend, key).cpu().numpy()
        if key == "extra":
            check(not got[..., e:].any(), "zero feature padding came out "
                  "non-zero")
            got = got[..., :e]
        excess = np.abs(got - g[key]) - (2e-5 + 1e-4 * np.abs(g[key]))
        worst = max(worst, float(excess.max()))
    nc_mism = int((out.blend.n_contrib.cpu().numpy() != g["n_contrib"]).sum())
    print(f"[golden] {W}x{H}, {int(g['n'])} gaussians, E={e} padded to 16: "
          f"pairs={out.total_pairs}, worst excess over atol 2e-5 + rtol "
          f"1e-4 = {worst:.3g}, n_contrib mismatches={nc_mism}", flush=True)
    check(worst <= 0 and nc_mism == 0,
          "the card's rasterizer does not match tests/goldens/forward.npz")


def main_path(p_full, tmp) -> int:
    """Serve the scene through the headless CLI and the engine, with the
    launch counts reset just before and read just after; check what came
    out, then time the orbit frames. Returns the kernels' launches on the
    path (counts())."""
    import torch
    import instascene_tpu_torch.ops.blend_visits as bv
    from instascene_tpu_torch import semantic_gui
    from instascene_tpu_torch.data.ply import read_ply
    from instascene_tpu_torch.models.gaussians import save_ply
    from instascene_tpu_torch.render import render
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    width, height = FULL["width"], FULL["height"]
    ply = os.path.join(tmp, "scene.ply")
    save_ply(p_full, ply)
    torch.cuda.synchronize()
    common = ["-p", ply, "--headless", "--width", str(width), "--height",
              str(height), "--camera_radius", "4", "--out_dir", tmp,
              "--device", DEVICE]

    reset_counts()
    t0 = time.perf_counter()
    semantic_gui.main(common + ["--render_mode", "depth"])
    t1 = time.perf_counter()
    engine = semantic_gui.main(common + ["--click", CLICKS,
                                         "--score_threshold",
                                         SCORE_THRESHOLD])
    t2 = time.perf_counter()
    engine.reload()           # back to the whole scene for the orbit
    orbit = OrbitCamera(width, height, r=4.0)
    frames, cams, frame_s = [], [], []
    for _ in range(4):
        orbit.orbit(400.0, 60.0)
        cams.append(orbit.minicam())
        tf = time.perf_counter()
        frames.append(engine.render_view(cams[-1]))   # ends in D2H copies
        frame_s.append(time.perf_counter() - tf)
    torch.cuda.synchronize()
    launches = counts()
    print(f"[main] launches on the serving path: {launches}; host wall: "
          f"depth preview CLI {t1 - t0:.3f} s, click-to-segment CLI "
          f"{t2 - t1:.3f} s (both include the PLY load), orbit viewer "
          f"frames with D2H {', '.join(f'{s * 1e3:.1f}' for s in frame_s)}"
          f" ms", flush=True)
    check(launches["K1 full"] + launches["K1 viewer"] > 0,
          "the serving path never launched K1")

    mask = np.load(os.path.join(tmp, "default", "segment_0_mask.npy"))
    seg = read_ply(os.path.join(tmp, "default", "segment_0.ply"))
    n_seg = int(mask.sum())
    print(f"[main] segmented {n_seg} gaussians; segment_0.ply holds "
          f"{len(seg['vertex'])}", flush=True)
    check(n_seg > 0 and len(seg["vertex"]) == n_seg,
          "segmentation saved no gaussians or a different count")
    for name in ("preview_rgb.png", "preview_feat.png", "preview_depth.png"):
        check(os.path.getsize(os.path.join(tmp, name)) > 1000,
              f"{name} missing")
    for f in frames:
        for k, v in f.items():
            check(np.isfinite(v).all(), f"frame map {k} not finite")
            check(v.shape[:2] == (height, width),
                  f"frame map {k} shape {v.shape}")
    print("[main] every map finite", flush=True)

    # device times of the orbit frames (after the counted window)
    p = engine.params
    pairs, r_ms, k_ms, stages = [], [], [], []
    for c in cams:
        stages.append(stage_ms(p, c, width, height))
        flat, b, gx = frame_inputs(p, c, width, height, True)
        pairs.append(b.total_pairs)
        k_ms.append(time_ms(lambda: bv.blend_fwd(
            flat, b.sorted_gid, b.tile_start, b.tile_end, gx, 16,
            viewer=True), 10))
        r_ms.append(time_ms(lambda: render(c, p, engine.pipe,
                                           engine.bg_color, viewer=True), 5))
        del flat, b
    print(f"[main] orbit frames: pairs {pairs}; K1 viewer median "
          f"{np.median(k_ms):.4f} ms; render() median {np.median(r_ms):.4f}"
          f" ms (CUDA events)", flush=True)
    st_med = {k: float(np.median([x[k] for x in stages])) for k in stages[0]}
    st_med["K1 viewer"] = float(np.median(k_ms))
    st_med["rest (activations, maps, host)"] = (
        float(np.median(r_ms)) - sum(st_med.values()))
    print("[main] render() stages, median ms: " + ", ".join(
        f"{k} {v:.4f}" for k, v in st_med.items()), flush=True)
    return launches


def reset_counts():
    """Every kernel's launch count, by mode, to 0."""
    from instascene_tpu_torch.ops import blend_visits as bv
    for k in bv.LAUNCHES:
        bv.LAUNCHES[k] = 0


def counts():
    """A copy of the kernels' launch counts, by kernel and mode."""
    from instascene_tpu_torch.ops import blend_visits as bv
    return dict(bv.LAUNCHES)


def train_scene(st, dev):
    """The benchmark scene as geometry training takes it: no features."""
    from instascene_tpu_torch.models.gaussians import from_numpy
    return from_numpy({**st, "seg_feature": None}, dev)


def train_frame_kernels(p, make_cam):
    """K1 no_dist, K2 in both modes and the segment sum on the first
    training frame (976x728), against their plain versions, timed."""
    W, H = TRAIN["width"], TRAIN["height"]
    flat, b, gx = frame_inputs(p, make_cam(0, W, H), W, H, False)
    k1 = compare_kernel("train-frame", flat, b, gx, 0, "no_dist",
                        exact=False, timing=True)
    print(f"[kernel] train-frame no_dist E=0: K1 {k1['ms']:.4f} ms, plain "
          f"{k1['plain_ms']:.1f} ms, bound {k1['bound_ms']:.4f} ms "
          f"({k1['bound_by']}: {k1['bytes']} bytes, {k1['evals']} of at "
          f"most {k1['max_evals']} evaluations, {k1['hits']} contributions, "
          f"{k1['ops']} FP32 ops)", flush=True)
    k2 = {}
    for no_dist in (True, False):
        r = compare_k2("train-frame", flat, b, gx, 0, no_dist, timing=True)
        mode = "no_dist" if no_dist else "full"
        sg = r["segment_sum"]
        print(f"[kernel] train-frame K2 {mode} E=0: K2 {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} FP32 ops); "
              f"segment sum {sg['ms']:.4f} ms, plain {sg['plain_ms']:.4f} "
              f"ms, index_add_ {sg['library_ms']:.4f} ms, bound "
              f"{sg['bound_ms']:.4f} ms ({sg['bound_by']})", flush=True)
        k2[mode] = r
    return k1, k2


class StageClock:
    """CUDA events recorded as a train step's stages end (train_step's
    on_stage), and around K2 and the segment sum inside its backward."""

    current = None

    def __init__(self):
        import torch
        self.torch = torch
        self.events = []
        self.mark("start")

    def mark(self, name):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.events.append((name, e))

    def split(self):
        """Stage ms of the step (call after a synchronize)."""
        ev = dict(self.events)
        el = lambda a, b: ev[a].elapsed_time(ev[b])
        k2 = el("k2_start", "k2")
        red = el("reduce_start", "reduce")
        return {"step": el("start", "adam"),
                "forward render": el("start", "render"),
                "losses": el("render", "loss"),
                "K2": k2, "reduction": red,
                "rest of backward": el("loss", "backward") - k2 - red,
                "Adam + densify stats": el("backward", "adam")}


def clocked(fn, before, after):
    """fn with CUDA events recorded (StageClock.current) around each call."""
    def call(*args, **kw):
        StageClock.current.mark(before)
        out = fn(*args, **kw)
        StageClock.current.mark(after)
        return out
    return call


def train_phase(p0, make_cam, dev):
    """train_step at the benchmark's size in both recipes, with the stage
    split of every timed step. Returns {recipe: summary}."""
    import torch
    from instascene_tpu_torch.config import OptimizationParams
    from instascene_tpu_torch.models import densify as dens
    from instascene_tpu_torch.models.optimizer import (geometry_lrs,
                                                       init_adam_state)
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train import (camera_tensors,
                                                      train_step)
    W, H = TRAIN["width"], TRAIN["height"]
    cams = [camera_tensors(make_cam(i, W, H), dev)
            for i in range(TRAIN["cams"])]
    gt = torch.as_tensor(np.random.default_rng(2).random(
        (H, W, 3)).astype(np.float32), device=dev)
    for ct in cams:
        ct.gt_image = gt
    lrs = geometry_lrs(OptimizationParams(), 1.0, 1e-4)
    bg = torch.zeros(3, device=dev)
    results = {}
    orig = (bv.blend_bwd, bv.reduce_per_gaussian)
    bv.blend_bwd = clocked(orig[0], "k2_start", "k2")
    bv.reduce_per_gaussian = clocked(orig[1], "reduce_start", "reduce")
    try:
        for recipe, dist, steps in (("no_dist", False, TRAIN["steps"]),
                                    ("dist", True, TRAIN["dist_steps"])):
            cfg = RasterizeConfig(W, H, no_depth_dist=not dist)
            lam = dict(lambda_dssim=0.2, lambda_dist=100.0 if dist else 0.0,
                       lambda_normal=0.05, lambda_normal_prior=0.0)
            state = (p0, init_adam_state(p0),
                     dens.init_stats(p0.capacity, dev))
            splits, losses, pairs = [], [], []
            for i in range(TRAIN["warm"] + steps):
                StageClock.current = clock = StageClock()
                *state, m = train_step(
                    *state, cams[i % len(cams)], bg, lrs, cfg=cfg,
                    depth_ratio=0.0 if dist else 1.0, on_stage=clock.mark,
                    **lam)
                torch.cuda.synchronize()
                if i >= TRAIN["warm"]:
                    splits.append(clock.split())
                    losses.append(float(m["loss"]))
                    pairs.append(int(m["total_pairs"]))
            med = {k: float(np.median([x[k] for x in splits]))
                   for k in splits[0]}
            print(f"[train] {recipe} at {W}x{H}, {p0.n_alive()} gaussians: "
                  f"{steps} timed steps, pairs per step {pairs}; losses "
                  f"{losses[0]:.5f} → {losses[-1]:.5f}", flush=True)
            print(f"[train] {recipe} median ms (CUDA events): " + ", ".join(
                f"{k} {v:.3f}" for k, v in med.items()), flush=True)
            check(all(np.isfinite(losses)), f"{recipe}: non-finite loss")
            results[recipe] = {"median_ms": med, "pairs": pairs,
                               "losses": losses}
    finally:
        bv.blend_bwd, bv.reduce_per_gaussian = orig
        StageClock.current = None
    return results


def write_colmap_scene(st, make_cam, dev, root):
    """A COLMAP scene written with the port's writers: CLI_CAMS orbit
    cameras at the training size with PNG images rendered by the port from
    the benchmark scene, and the scene's centres (with their base colors)
    as points3D.bin."""
    import torch
    from instascene_tpu_torch.cameras import fov2focal
    from instascene_tpu_torch.config import PipelineParams
    from instascene_tpu_torch.data import colmap
    from instascene_tpu_torch.ops.sh import C0
    from instascene_tpu_torch.render import render
    from instascene_tpu_torch.utils.image import write_png
    W, H = TRAIN["width"], TRAIN["height"]
    sparse = os.path.join(root, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(root, "images"))
    p = train_scene(st, dev)
    images = {}
    for i in range(CLI_CAMS):
        cam = make_cam(2 * i, W, H)
        with torch.no_grad():
            rgb = render(cam, p, PipelineParams(), torch.zeros(3, device=dev),
                         viewer=True)["render"]
        name = f"{i:03d}.png"
        write_png(os.path.join(root, "images", name),
                  (rgb.clamp(0, 1) * 255 + 0.5).to(torch.uint8).cpu().numpy())
        images[i + 1] = colmap.ColmapImage(
            id=i + 1, qvec=colmap.rotmat2qvec(cam.R.T),
            tvec=np.asarray(cam.T, np.float64), camera_id=1, name=name,
            xys=np.zeros((0, 2)), point3D_ids=np.zeros(0, np.int64))
    cam = make_cam(0, W, H)
    colmap.write_cameras_binary({1: colmap.ColmapCamera(
        id=1, model="PINHOLE", width=W, height=H, params=np.array(
            [fov2focal(cam.fovx, W), fov2focal(cam.fovy, H), W / 2, H / 2]))},
        os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    rgb = np.clip(st["features_dc"][:, 0] * C0 + 0.5, 0, 1)
    colmap.write_points3D_binary(st["xyz"].astype(np.float64),
                                 (rgb * 255).astype(np.uint8),
                                 os.path.join(sparse, "points3D.bin"))


def cli_phase(st, make_cam, tmp):
    """The training CLI on a COLMAP scene at the training size: grows,
    improves, saves a PLY that loads back, and resumes from its
    checkpoint. At each densification it prints how many visible
    gaussians reach the gradient threshold, and the reference's."""
    import torch
    from instascene_tpu_torch import train
    from instascene_tpu_torch.models import densify as dens
    from instascene_tpu_torch.models.gaussians import load_ply
    root = os.path.join(tmp, "data", "orbit", "scene")
    t0 = time.perf_counter()
    write_colmap_scene(st, make_cam, DEVICE, root)
    t1 = time.perf_counter()
    model = os.path.join(tmp, "model")
    common = ["-s", root, "-m", model, "--device", DEVICE,
              "--disable_viewer"]
    orig = dens.densify_and_prune

    def watched(params, opt_state, stats, eps, max_grad, min_opacity, *args,
                **kw):
        vis = params.alive & (stats.denom > 0)
        g = (stats.xyz_gradient_accum / stats.denom.clamp(min=1.0))[vis]
        # the same step at the reference's thresholds, for the record only
        ref = orig(params, opt_state, stats, eps, REF_DENSIFY[0],
                   REF_DENSIFY[1], *args, **kw)[0].n_alive()
        out = orig(params, opt_state, stats, eps, max_grad, min_opacity,
                   *args, **kw)
        print(f"[cli] densify: {int(vis.sum())} alive gaussians seen; mean "
              f"screen grad p50 {float(g.median()):.3g}, p99 "
              f"{float(torch.quantile(g, 0.99)):.3g}, max "
              f"{float(g.max()):.3g}; at or above {max_grad:g}: "
              f"{int((g >= max_grad).sum())}, at or above the reference's "
              f"{REF_DENSIFY[0]:g}: {int((g >= REF_DENSIFY[0]).sum())}; "
              f"n_alive {params.n_alive()} → {out[0].n_alive()} at "
              f"({max_grad:g}, cull {min_opacity:g}), would be {ref} at the "
              f"reference's ({REF_DENSIFY[0]:g}, cull {REF_DENSIFY[1]:g})",
              flush=True)
        return out

    dens.densify_and_prune = watched
    try:
        tr = train.main(common + [
            "--iterations", str(CLI_ITERS), "--densify_from_iter", "10",
            "--densification_interval", "10", "--densify_until_iter",
            str(CLI_ITERS + 1), *CLI_DENSIFY, "--test_iterations", "10",
            str(CLI_ITERS),
            "--save_iterations", str(CLI_ITERS), "--checkpoint_iterations",
            str(CLI_ITERS)])
    finally:
        dens.densify_and_prune = orig
    t2 = time.perf_counter()
    n0 = len(st["xyz"])
    n1 = tr.params.n_alive()
    psnr = {it: tr.reports[it]["train"]["psnr"] for it in sorted(tr.reports)}
    ply = os.path.join(model, "point_cloud", f"iteration_{CLI_ITERS}",
                       "point_cloud.ply")
    n_ply = len(load_ply(ply, device="cpu").xyz)
    tr2 = train.main(common + [
        "--iterations", str(CLI_ITERS + 1), "--start_checkpoint",
        os.path.join(model, f"chkpnt{CLI_ITERS}.npz"), "--test_iterations",
        str(CLI_ITERS + 1)])
    print(f"[cli] scene written in {t1 - t0:.1f} s; train.main "
          f"{CLI_ITERS} iterations in {t2 - t1:.1f} s host wall (scene load, "
          f"KNN init, densification and evaluations included); gaussians "
          f"{n0} → {n1} (capacity {tr.params.capacity}); train-view PSNR "
          + ", ".join(f"iter {k} {v:.3f}" for k, v in psnr.items())
          + f"; PLY holds {n_ply}; resumed to Adam count "
          f"{tr2.opt_state.count}", flush=True)
    check(n1 > n0, "densification did not grow the gaussians")
    check(psnr[CLI_ITERS] > psnr[10], f"PSNR did not rise: {psnr}")
    check(n_ply == n1, f"the PLY holds {n_ply}, the trainer {n1}")
    check(tr2.opt_state.count == CLI_ITERS + 1,
          "the resume did not take one more step")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, "instascene_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository (the "
              "instascene_tpu_torch package is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from instascene_tpu_torch import cuda_build
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy

    # ---- 1. device and build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output", flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {kind} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}", flush=True)
    build_s = cuda_build.build_all()
    print(f"[build] nvcc built {sorted(cuda_build.BUILD_LOG)} in "
          f"{build_s:.1f} s", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    dev = torch.device(DEVICE)
    with torch.no_grad():
        # ---- 2. kernel vs plain, and the goldens
        golden_check(dev)
        st, make_cam = make_bench_scene(n=MID["n"], seed=0,
                                        profile="trained")
        p_mid = from_numpy(st, device=dev)
        cam = make_cam(0, MID["width"], MID["height"])
        for E, mode in ((16, "full"), (0, "full"), (16, "viewer"),
                        (0, "no_dist")):
            flat, b, gx = frame_inputs(p_mid, cam, MID["width"],
                                       MID["height"], E > 0)
            compare_kernel("mid-size", flat, b, gx, E, mode, exact=True)
        for E in (0, 16):
            flat, b, gx = frame_inputs(p_mid, cam, MID["width"],
                                       MID["height"], E > 0)
            for no_dist in (True, False):
                compare_k2("mid-size", flat, b, gx, E, no_dist)
        del p_mid, flat, b

        st, make_cam = make_bench_scene(n=FULL["n"], seed=0,
                                        profile="trained")
        p_full = from_numpy(st, device=dev)
        cam = make_cam(0, FULL["width"], FULL["height"])
        full = {}
        for E, mode in ((16, "full"), (0, "full"), (16, "viewer")):
            flat, b, gx = frame_inputs(p_full, cam, FULL["width"],
                                       FULL["height"], E > 0)
            full[(E, mode)] = compare_kernel(
                "full-width", flat, b, gx, E, mode, exact=False,
                timing=E == 16)
            if E == 16:
                r = full[(E, mode)]
                print(f"[kernel] full-width {mode} E=16: K1 {r['ms']:.4f} "
                      f"ms, plain {r['plain_ms']:.1f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_by']}: "
                      f"{r['bytes']} bytes, {r['evals']} of at most "
                      f"{r['max_evals']} (pair, pixel) evaluations, "
                      f"{r['hits']} contributions, {r['ops']} FP32 ops)",
                      flush=True)
            del flat, b

        # ---- 3. the serving path at full width
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            serve = main_path(p_full, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del p_full

        # ---- 4. the training frame's kernels
        p_train = train_scene(st, dev)
        k1_train, k2_train = train_frame_kernels(p_train, make_cam)

    # ---- 5. the training path at full width
    reset_counts()
    steps = train_phase(p_train, make_cam, dev)
    step_counts = counts()
    del p_train
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        cli_phase(st, make_cam, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    train_counts = counts()
    print(f"[train] launches on the training path: train steps "
          f"{step_counts}; with the CLI {train_counts}", flush=True)
    check(train_counts["K1 no_dist"] > 0 and train_counts["K1 full"] > 0,
          "the training path did not launch K1 in both its modes")
    check(train_counts["K2 no_dist"] > 0 and train_counts["K2 full"] > 0,
          "the training path did not launch K2 in both its modes")
    check(train_counts["segment_sum"] > 0,
          "the training path never launched the segment sum")

    # ---- 6. the kernels' line and the result
    frame = (f"{TRAIN['width']}x{TRAIN['height']}, {len(st['xyz'])} "
             f"gaussians, E=0")
    full_err = max(v["max_abs_err"] for v in full.values())

    def k1_entry(mode, r, where, launches):
        return {"name": "blend_fwd", "route": "cuda",
                "source": "instascene_tpu_torch/csrc/blend_fwd.cu",
                "replaces": "instascene_tpu/ops/blend_visits.py:62",
                "mode": f"{mode}, {where}", "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    def k2_entry(mode):
        r = k2_train[mode]
        return {"name": "blend_bwd", "route": "cuda",
                "source": "instascene_tpu_torch/csrc/blend_bwd.cu",
                "replaces": "instascene_tpu/ops/blend_visits.py:395",
                "mode": f"{mode}, {frame}",
                "launches": train_counts[f"K2 {mode}"],
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None}

    where_1080 = f"E=16, {FULL['width']}x{FULL['height']}"
    sg = k2_train["no_dist"]["segment_sum"]
    kernels = [
        dict(k1_entry("viewer", full[(16, "viewer")], where_1080,
                      serve["K1 viewer"]), max_abs_err=full_err),
        dict(k1_entry("full", full[(16, "full")], where_1080,
                      serve["K1 full"] + train_counts["K1 full"]),
             max_abs_err=full_err),
        k1_entry("no_dist", k1_train, frame, train_counts["K1 no_dist"]),
        k2_entry("no_dist"), k2_entry("full"),
        {"name": "segment_sum", "route": "cuda",
         "source": "instascene_tpu_torch/csrc/blend_bwd.cu",
         "replaces": "instascene_tpu/ops/blend_visits.py:729",
         "mode": f"d_flat of K2 no_dist, {frame}",
         "launches": train_counts["segment_sum"],
         "max_abs_err": sg["max_abs_err"], "ms": sg["ms"],
         "plain_ms": sg["plain_ms"], "bound_ms": sg["bound_ms"],
         "bound_by": sg["bound_by"], "library_ms": sg["library_ms"]}]
    print(json.dumps({"kernels": kernels, "train_step_median_ms": {
        k: v["median_ms"] for k, v in steps.items()}}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0

if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL {e}", file=sys.stderr)
        sys.exit(1)
