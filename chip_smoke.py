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
   Phase 2 also holds K1 `track` (E=0 and 16), K1 `extras_only` (E=16)
   without and with a ~2,000-pixel done0 mask (sampled pixels bit for bit
   `full`'s, the others T = 1, 0, n_contrib 0), K2 `extras_only` on
   each, K1/K2 over a list of 8 random tiles (K3/K4; listed rows bit for
   bit the whole frame's), K5/K6 on 2,000 random draws (bit for bit K1
   extras_only with the same pixels freed) and K1/K2 `tiles_per_view`
   over three views concatenated (bit for bit each view's own render)
   against their plain versions at mid size;
6. the semantic frame at 976x728 (the same scene with its features, E=16):
   K1 extras_only with a 32k-pixel done0 and without, K2 extras_only, the
   segment sum at D=16, K1 track, K5/K6 on 32k draws, K3/K4 on bench.py's
   128 tiles of each window view (with the chunks the JAX package's capped
   mini bundles would cut) and K1/K2 tiles_per_view over the 5-view window
   against their plain versions, timed, with their bounds;
7. the semantic path at full width: semantic_train_step with bench.py's
   inputs (3 warm-up and 20 timed plain steps, 3 warm-up and 6 timed
   steps with the 5-view window) with the stage split and the sustained
   it/s, launch counts reset just before the steps and read just after
   (K1 and K2 extras_only and the segment sum must have launched); the
   same for each multi-view variant, with its own counts: the window
   tile-subsampled (K3/K4), merged (K1/K2 tiles_per_view), and sparse
   pixels (K5/K6, 20 plain steps too; no dense fallback); the tracker
   view's s/view; then the semantic CLI (train_semantic.main) on a scene
   written with the port's writers (the geometry CLI's 8 views,
   point_cloud.ply, sam/mask maps from the port's tracker render):
   priors, 30 iterations, a save, the HDBSCAN export, launch counts reset
   just before main and read just after. It must find >= 2 instances and
   write output_dict.npy, sam/mask_sorted, a PLY with segfeat_0..15 that
   loads back finite and point_cloud_labels.ply; K1 extras_only and
   track, K2 extras_only and the segment sum must have launched in it.
   Then the CLI three times more on that scene, each with its own counts:
   with --mv_tile_subsample 128 --sparse_px 1 at 256 draws per set (K3,
   K4, K5 and K6 must launch), the same at the reference's 32k draws
   (K3/K4 must launch; the sparse steps that fall back to the dense path
   are printed beside the K5/K6 launches) and with --mv_merged 1 (K1/K2
   tiles_per_view must launch), each with a PLY that loads back finite.
   Each phase prints its seconds;
   Phase 2 also holds, at mid size, K7/K8 over the padded layout (E=16 and
   0; bit for bit K1/K2 `full` on the same binning, d(packed) twice bit for
   bit), K1/K2 `clip_rect` in full, no_dist, viewer and extras_only over
   the binning dilated by one tile (bit for bit the fresh binning's
   render and d_flat), K3/K4 full/viewer over 8 random tiles, and the
   run-time feature widths E = 4 and 8 on K1, K2, K5/K6 and K7/K8;
8. the padded and cached-superset paths at full width, launch counts
   reset just before their entry points and read just after:
   rasterize_padded_fwd (K7) at 1920x1080 on camera 0 and four orbit
   frames (held against render()'s K1 full), the padded layout's
   differentiable frame (pack_inputs + blend_padded_diff, K7/K8) at
   976x728 without and with features (loss and gradients held against
   rasterize's K1/K2), rasterize with clip_rect over a cache dilated by
   one tile at camera 0 (full and extras_only, held against the fresh
   render) and at an orbit step inside its envelope (printed), rasterize
   over bench.py's 128 tiles of view 1 (K3/K4 full, K3 viewer; bit for bit
   the whole frame) and rasterize with conic_cull at 1080p (pairs, stage
   times, maps held against the unculled render). K7, K8, K1/K2
   clip_rect and K3/K4 full/viewer must launch. Then K7 and K1 full timed
   at 1080p (E=16 and 8), K8 and K2 full at 976x728 (E=0 and 16), the
   gather's backward (and whether two runs are bit for bit equal),
   K1/K2 clip_rect and K3/K4 with their bounds;
9. one JSON line with the kernels' numbers, then the last line
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
# the packed columns the splat and its mask read: A, B, C, Tw, xy, opacity
# (not the view normal or the color)
SPLAT_COLS = 15


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


def frame_stages(p, cam, width, height, with_extras, n_extra=16):
    """The stages of one frame before K1, as calls over the state's
    activated tensors (activations are not part of any stage): returns
    (preprocess(), bin(pre), pack(pre)); with_extras packs the first
    n_extra feature channels."""
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, p.device)
    opac = p.opacity_activated()[:, 0]
    args = (p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
            cm.full_proj, cm.campos, width, height, opac)
    kw = dict(shs=p.features(), sh_degree=p.active_sh_degree, alive=p.alive)
    extras = (p.seg_feature_normed()[:, :n_extra].contiguous()
              if with_extras else None)
    return (lambda: preprocess_gaussians(*args, **kw),
            lambda pre: bin_gaussians(pre, width, height),
            lambda pre: pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac,
                                       pre.color, extras))


def frame_inputs(p, cam, width, height, with_extras, n_extra=16):
    """Preprocess + bin + pack of one frame, on the state's device."""
    preprocess, binning, pack = frame_stages(p, cam, width, height,
                                             with_extras, n_extra)
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


def time_ms(fn, reps, warm=True):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up call
    unless warm=False: the plain versions, whose launches an earlier call
    already warmed)."""
    import torch
    if warm:
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


def timed(fn):
    """(fn(), its CUDA-event ms): one call, no warm-up — the plain versions
    with their work counts, which take seconds at full width."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    res = fn()
    b.record()
    torch.cuda.synchronize()
    return res, a.elapsed_time(b)


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


def k1_bound(flat, b, E, mode, n_eval, n_hit, extra_bytes=0, extra_ops=0):
    """Least time for K1's work on these inputs: each input read once and
    each output written once over HBM bandwidth, against the FP32
    operations these inputs need at the FP32 SIMT peak — every pixel
    evaluates its tile's slots until it latches done (n_eval), and
    contributes n_hit times. `extras_only` needs only the splat and
    feature columns of flat and writes only final T, the features and
    n_contrib (the other rows are zeros that nothing reads). extra_bytes:
    a mode's other inputs and outputs (done0, the contributor buffer);
    extra_ops: a mode's other operations (clip_rect's rect tests)."""
    import torch
    nt = b.tile_start.numel()
    cols, rows, irows = ((SPLAT_COLS + E, 1 + E, 1) if mode == "extras_only"
                         else (flat.shape[1], 12 + E, 2))
    bytes_ = (flat.shape[0] * cols * 4 + b.sorted_gid.numel() * 4
              + 2 * nt * 4 + nt * (rows + irows) * 256 * 4 + extra_bytes)
    evals = int(n_eval.sum(dtype=torch.int64))
    hits = int(n_hit.sum(dtype=torch.int64))
    ops = (evals * OPS_EVAL + hits * (OPS_HIT + 2 * E + OPS_HIT_MODE[mode])
           + extra_ops)
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


def compare_k2(label, flat, b, grid_x, E, mode, timing=False, fwd=None,
               **sel):
    """K2 in `mode` (full, no_dist or extras_only) and the segment sum on
    the card against their plain versions on the same inputs (K1's own
    forward in that mode, or the given fwd = (out, iout), and one seeded
    random cotangent), then both kernels a second time: d_sorted and d_flat
    bit for bit equal. The segment sum's d_flat is also torch.equal to its
    plain version run on the CPU on the kernel's own d_sorted (both add in
    slot order). sel: tile_ids (K4) or tiles_per_view, passed to both
    versions."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    kw = dict(no_dist=mode == "no_dist", extras_only=mode == "extras_only",
              **sel)
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    out, iout = fwd if fwd is not None else bv.blend_fwd(*args, **kw)
    saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                        dim=1).contiguous()
    gen = torch.Generator(device=flat.device).manual_seed(5 + E)
    gout = torch.randn(out.shape, generator=gen, device=flat.device)
    n = flat.shape[0]
    runs = (b.gid_order, b.run_start)
    bwd = (*args, gout, saved, iout)
    d1 = bv.blend_bwd(*bwd, **kw)
    f1 = bv.reduce_per_gaussian(d1, b.sorted_gid, n, runs)
    d2 = bv.blend_bwd(*bwd, **kw)
    f2 = bv.reduce_per_gaussian(d2, b.sorted_gid, n, runs)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2) and torch.equal(f1, f2))
    seg_exact = bool(torch.equal(f1.cpu(), bv.reduce_per_gaussian_reference(
        d1.cpu(), b.sorted_gid.cpu(), n)))
    (d_ref, (evals, hits, slots)), plain_ms = timed(
        lambda: bv.blend_bwd_reference(*bwd, count_work=True, **kw))
    f_ref = bv.reduce_per_gaussian_reference(d_ref, b.sorted_gid, n)
    torch.cuda.synchronize()
    err_rows, err_flat = col_rel_err(d1, d_ref), col_rel_err(f1, f_ref)
    print(f"[kernel] {label} K2 {mode} E={E}: pairs={b.total_pairs} "
          f"(slot, pixel) evaluations={evals} contributions={hits} slots "
          f"reduced={slots}; per-slot rows {err_rows:.3g}, d_flat "
          f"{err_flat:.3g} of each column's max |value| (tol {K2_TOL:g}); "
          f"two runs bit for bit equal: {same}; segment sum torch.equal to "
          f"its plain version on the CPU: {seg_exact}", flush=True)
    check(bool(torch.isfinite(d1).all() and torch.isfinite(f1).all()),
          f"{label} K2 {mode} E={E}: non-finite gradients")
    check(hits > 0, f"{label} K2 {mode} E={E}: no contribution")
    check(err_rows <= K2_TOL and err_flat <= K2_TOL,
          f"{label} K2 {mode} E={E}: rows {err_rows}, d_flat {err_flat}")
    check(same, f"{label} K2 {mode} E={E}: two runs differ")
    check(seg_exact, f"{label} K2 {mode} E={E}: the segment sum's d_flat is "
          f"not its plain version's bits")
    res = {"max_abs_err": float((d1 - d_ref).abs().max()),
           "flat_max_abs_err": float((f1 - f_ref).abs().max()),
           "rel_err": max(err_rows, err_flat)}
    if timing:
        D = d1.shape[1]
        nt = out.shape[0]           # gout's rows (the listed tiles for K4)
        pairs = b.sorted_gid.numel()
        res["ms"] = time_ms(lambda: bv.blend_bwd(*bwd, **kw), 20)
        res["plain_ms"] = plain_ms      # one call, work counts included
        # extras_only reads the splat columns of flat and per pixel gout's
        # E feature rows, final T and n_contrib; the other modes all of
        # flat, gout, saved (T, m1, m2) and iout. Over a tile list (K4)
        # only the listed tiles' pairs, their gaussians and their d_sorted
        # rows (the zeros of the other slots are the wrapper's fill)
        walk, gauss = ((pairs, flat.shape[0]) if "tile_ids" not in sel
                       else walked(sel["tile_ids"], b))
        cols, rows = ((SPLAT_COLS, E + 2) if mode == "extras_only"
                      else (flat.shape[1], 12 + E + 3 + 2))
        bytes_ = (gauss * cols * 4 + walk * 4
                  + (3 if "tile_ids" in sel else 2) * nt * 4
                  + nt * rows * 256 * 4 + walk * D * 4)
        per_hit = (OPS_BWD_EXTRAS_HIT + E if mode == "extras_only" else
                   OPS_BWD_HIT + OPS_BWD_HIT_E * E
                   + (OPS_BWD_HIT_FULL if mode == "full" else 0))
        ops = evals * OPS_EVAL + hits * per_hit + (hits - slots) * D
        if sel.get("clip_rect"):
            ops += walk * RECT_OPS       # each slot's rect test
        res.update(bound(bytes_, ops), evals=evals, hits=hits, slots=slots,
                   longest_run=int((b.run_start[1:] - b.run_start[:-1])
                                   .max()),
                   largest_tile=int((b.tile_end - b.tile_start).max()))
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
    for mode in ("no_dist", "full"):
        r = compare_k2("train-frame", flat, b, gx, 0, mode, timing=True)
        sg = r["segment_sum"]
        print(f"[kernel] train-frame K2 {mode} E=0: K2 {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} FP32 ops); "
              f"segment sum {sg['ms']:.4f} ms, plain {sg['plain_ms']:.4f} "
              f"ms, index_add_ {sg['library_ms']:.4f} ms, bound "
              f"{sg['bound_ms']:.4f} ms ({sg['bound_by']}); longest run "
              f"{r['longest_run']} slots, largest tile {r['largest_tile']} "
              f"slots", flush=True)
        k2[mode] = r
    return k1, k2


class StageClock:
    """CUDA events recorded as a step's stages end (the step's on_stage
    marks), and around every call of the stage functions wrapped with
    `wrapped` while a clock is current, summed per stage."""

    current = None

    def __init__(self):
        import torch
        self.torch = torch
        self.marks = {}
        self.spans = []          # (stage, start event, end event)
        self.mark("start")

    def event(self):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def mark(self, name):
        self.marks[name] = self.event()

    def ms(self, a, b):
        """ms from mark a to mark b (after a synchronize)."""
        return self.marks[a].elapsed_time(self.marks[b])

    def total(self, stage):
        """ms summed over the wrapped calls of `stage`."""
        return sum(a.elapsed_time(b) for s, a, b in self.spans if s == stage)


def wrapped(stages):
    """Context manager: {(module, name): stage} replaced by the function
    with events around each call into StageClock.current, restored on
    exit."""
    import contextlib

    def wrap(fn, stage):
        def call(*args, **kw):
            clock = StageClock.current
            if clock is None:
                return fn(*args, **kw)
            a = clock.event()
            out = fn(*args, **kw)
            clock.spans.append((stage, a, clock.event()))
            return out
        return call

    @contextlib.contextmanager
    def cm():
        saved = {k: getattr(*k) for k in stages}
        for (mod, name), stage in stages.items():
            setattr(mod, name, wrap(saved[(mod, name)], stage))
        try:
            yield
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
            StageClock.current = None
    return cm()


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
    with wrapped({(bv, "blend_bwd"): "K2",
                  (bv, "reduce_per_gaussian"): "reduction"}):
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
                    k2, red = clock.total("K2"), clock.total("reduction")
                    splits.append({
                        "step": clock.ms("start", "adam"),
                        "forward render": clock.ms("start", "render"),
                        "losses": clock.ms("render", "loss"),
                        "K2": k2, "reduction": red,
                        "rest of backward": clock.ms("loss", "backward")
                        - k2 - red,
                        "Adam + densify stats": clock.ms("backward",
                                                         "adam")})
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


# ---------------------------------------------------------------- semantic
# the semantic benchmark (bench.py:207-329): 976x728, six orbit cameras, a
# random 40-label segmap (rng(1)) and random 3D labels, batch 32k, 64
# labels, lambda (sv 1e-6, mv 1e-6, 3D 2.5e-6), the 5-view window (views
# 1-5) every 10th step; sustained it/s = 1 / (0.9 t_plain + 0.1 t_mv)
SEM = dict(width=976, height=728, cams=6, labels=40, batch=32 * 1024,
           max_labels=64, warm=3, steps=20, mv_steps=6, n_mv=5, mv_k=128)
SEM_CLI_ITERS = 30
# a reduced batch for the sparse CLI run that must launch K5/K6: the
# tracker masks cover part of each frame, so at the reference's 32k the
# draws crowd the covered tiles past the S slots pick_sparse_s sizes for
# uniform draws, and a step whose tile overflows takes the dense path, as
# the JAX package's does; at 256 the covered tiles hold a few draws each.
# A second run at the reference batch prints how many steps fall back.
SEM_CLI_SPARSE_BATCH = 256
# K1 extras_only adds per contribution the done test and the weight (4)
# and E features (2 each), no color; track is `full` plus the w > 0.1 test
OPS_HIT_MODE.update({"extras_only": -6, "track": 26})
# K2 extras_only per contribution: T recovered and w (3) + 1 per feature
OPS_BWD_EXTRAS_HIT = 3


def done0_of(idx, nt, width, dev):
    """[T, 1, 256] int32 done mask latching all but the flat pixels idx."""
    import torch
    d = torch.ones((nt, 1, 256), dtype=torch.int32, device=dev)
    gx = (width + 15) // 16
    y, x = idx // width, idx % width
    d[(y // 16) * gx + x // 16, 0, (y % 16) * 16 + x % 16] = 0
    return d


def compare_extras(label, flat, b, grid_x, width, height, n_sampled,
                   timing=False, E=16):
    """K1 extras_only (E=16) on the card against its plain version, without
    and with a done0 mask of n_sampled random pixels: final T and features
    within TOL, n_contrib exactly; at the sampled pixels T and features bit
    for bit K1 `full`'s, the others (T = 1, 0, n_contrib 0). Then K2
    extras_only on each forward against its plain version (K2_TOL of each
    column's largest |value|), the segment sum at D = 16, both twice (bit
    for bit equal). Returns the numbers for the kernels' line. E: another
    feature width (the run-time-width instantiation)."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    nt = b.tile_start.numel()
    gen = torch.Generator(device=flat.device).manual_seed(11)
    idx = torch.randint(0, width * height, (n_sampled,), generator=gen,
                        device=flat.device)
    d0 = done0_of(idx, nt, width, flat.device)
    full, ifull = bv.blend_fwd(*args)
    res = {}
    for tag, mask in (("", None), (" done0", d0)):
        out_k, iout_k = bv.blend_fwd(*args, extras_only=True, done0=mask)
        torch.cuda.synchronize()
        out_r, iout_r, n_eval, n_hit = bv.blend_fwd_reference(
            *args, extras_only=True, done0=mask, count_work=True)
        torch.cuda.synchronize()
        check(torch.equal(iout_k, iout_r),
              f"{label} extras_only{tag}: iout differs from the plain version")
        eT = float((out_k[:, 9] - out_r[:, 9]).abs().max())
        eF = float((out_k[:, 10:10 + E] - out_r[:, 10:10 + E]).abs().max())
        zero = [r for r in range(12 + E) if not 9 <= r < 10 + E]
        check(not out_k[:, zero].any() and not iout_k[:, 1].any(),
              f"{label} extras_only{tag}: a row it does not compute is "
              f"nonzero")
        check(eT <= TOL["final_T"] and eF <= TOL["features"],
              f"{label} extras_only{tag}: T {eT}, features {eF}")
        line = (f"[kernel] {label} extras_only{tag} E={E}: pairs="
                f"{b.total_pairs} final T {eT:.3g} (tol {TOL['final_T']:g}),"
                f" features {eF:.3g} (tol {TOL['features']:g}), n_contrib "
                f"equal")
        if mask is not None:
            s = mask[:, 0] == 0
            bit = all(torch.equal(out_k[:, r][s], full[:, r][s])
                      for r in range(9, 10 + E)) and torch.equal(
                iout_k[:, 0][s], ifull[:, 0][s])
            rest = bool((out_k[:, 9][~s] == 1).all()
                        and not out_k[:, 10:10 + E].transpose(1, 2)[~s].any()
                        and not iout_k[:, 0][~s].any())
            line += (f"; {int(s.sum())} sampled pixels bit for bit K1 full's:"
                     f" {bit}; the others (1, 0, 0): {rest}")
            check(bit and rest, f"{label} extras_only done0: sampled pixels "
                  f"differ from full or latched ones are not (1, 0, 0)")
        print(line, flush=True)
        r = {"max_abs_err": max(eT, eF)}
        if timing:
            r["ms"] = time_ms(lambda: bv.blend_fwd(
                *args, extras_only=True, done0=mask), 20)
            r["plain_ms"] = time_ms(lambda: bv.blend_fwd_reference(
                *args, extras_only=True, done0=mask), 1, warm=False)
            r.update(k1_bound(flat, b, E, "extras_only", n_eval, n_hit,
                              extra_bytes=0 if mask is None
                              else mask.numel() * 4))
        res[tag.strip() or "plain"] = r
        res.setdefault("k2", {})[tag.strip() or "plain"] = compare_k2(
            label + tag, flat, b, grid_x, E, "extras_only", timing,
            fwd=(out_k, iout_k))
    return res


def compare_track(label, flat, b, grid_x, E, timing=False):
    """K1 track on the card against its plain version: contributor ids
    exactly, weights within 1e-6, out and iout equal to K1 `full`'s."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    out, iout, ids, w = bv.blend_fwd(*args, track=True)
    full, ifull = bv.blend_fwd(*args)
    torch.cuda.synchronize()
    _, _, rids, rw, n_eval, n_hit = bv.blend_fwd_reference(
        *args, track=True, count_work=True)
    torch.cuda.synchronize()
    same_ids = bool(torch.equal(ids, rids))
    ew = float((w - rw).abs().max())
    as_full = bool(torch.equal(out, full) and torch.equal(iout, ifull))
    print(f"[kernel] {label} track E={E}: pairs={b.total_pairs} tracked "
          f"slots {int((ids >= 0).sum())}, ids equal: {same_ids}, weights "
          f"{ew:.3g} (tol 1e-6), out/iout equal to full's: {as_full}",
          flush=True)
    check(same_ids and ew <= 1e-6 and as_full,
          f"{label} track E={E}: ids {same_ids}, w {ew}, full {as_full}")
    res = {"max_abs_err": ew}
    if timing:
        res["ms"] = time_ms(lambda: bv.blend_fwd(*args, track=True), 20)
        res["plain_ms"] = time_ms(lambda: bv.blend_fwd_reference(
            *args, track=True), 1, warm=False)
        res.update(k1_bound(flat, b, E, "track", n_eval, n_hit,
                            extra_bytes=ids.numel() * 8))
    return res


def walked(sel, b):
    """The pairs a walk over the tile list sel [K] of binning b reads
    (K3/K4): (their count, the number of distinct gaussians among them)."""
    import torch
    from instascene_tpu_torch.ops.binning import select_tiles
    ts = select_tiles(sel, b)
    gids = torch.cat([b.sorted_gid[s0:s1] for s0, s1 in zip(
        ts.tile_start.tolist(), ts.tile_end.tolist())])
    return gids.numel(), int(torch.unique(gids).numel())


def compare_selected(label, flat, b, grid_x, sel, E=16, timing=False):
    """K1 extras_only over a tile list (K3) on the card against its plain
    version (iout equal, T and features within TOL) and bit for bit the
    whole frame's K1 extras_only rows of those tiles; then K2 extras_only
    over the list (K4) and the segment sum against theirs (compare_k2).
    sel = ("views", T, views) instead of a list: the merged window of the
    frames views [(flat, BinningOut)] (K1/K2 tiles_per_view, flat and b
    from ops/binning.merge_binnings), bit for bit each view's own
    render."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    merged = isinstance(sel, tuple)
    kw = (dict(tiles_per_view=sel[1]) if merged
          else dict(tile_ids=sel))
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    out, iout = bv.blend_fwd(*args, extras_only=True, **kw)
    torch.cuda.synchronize()
    (out_r, iout_r, n_eval, n_hit), plain_ms = timed(
        lambda: bv.blend_fwd_reference(*args, extras_only=True,
                                       count_work=True, **kw))
    eT = float((out[:, 9] - out_r[:, 9]).abs().max())
    eF = float((out[:, 10:10 + E] - out_r[:, 10:10 + E]).abs().max())
    check(torch.equal(iout, iout_r) and eT <= TOL["final_T"]
          and eF <= TOL["features"],
          f"{label} {'merged' if merged else 'K3'}: iout equal "
          f"{torch.equal(iout, iout_r)}, T {eT}, features {eF}")
    if merged:
        T = sel[1]
        n = sel[2][0][0].shape[0]
        bit = True
        for v, (f, vb) in enumerate(sel[2]):
            o, io = bv.blend_fwd(f, vb.sorted_gid, vb.tile_start,
                                 vb.tile_end, grid_x, E, extras_only=True)
            bit = bit and torch.equal(out[v * T:(v + 1) * T], o) \
                and torch.equal(iout[v * T:(v + 1) * T], io)
        what = f"{len(sel[2])} views of {T} tiles ({n} gaussians each)"
    else:
        full, ifull = bv.blend_fwd(*args, extras_only=True)
        rows = sel.long()
        bit = torch.equal(out, full[rows]) and torch.equal(iout, ifull[rows])
        what = f"{sel.numel()} tiles"
    print(f"[kernel] {label} {'K1 tiles_per_view' if merged else 'K3'} "
          f"extras_only E={E}, {what}: pairs={b.total_pairs}, final T "
          f"{eT:.3g}, features {eF:.3g}, iout equal; bit for bit the "
          f"{'views' if merged else 'whole frame'}' own K1 extras_only: "
          f"{bit}", flush=True)
    check(bit, f"{label}: the selected/merged rows differ from K1's own")
    res = {"max_abs_err": max(eT, eF)}
    if timing:
        res["ms"] = time_ms(lambda: bv.blend_fwd(*args, extras_only=True,
                                                 **kw), 10)
        res["plain_ms"] = plain_ms      # one call, work counts included
        # the rows the walk needs: the listed tiles' pairs (all of them for
        # the merged window), their gaussians' splat + feature columns,
        # the tile ranges (and list), final T, the features, n_contrib
        pairs, gauss = ((b.total_pairs, flat.shape[0]) if merged
                        else walked(sel, b))
        nrows = out.shape[0]
        bytes_ = (gauss * (SPLAT_COLS + E) * 4 + pairs * 4 + 3 * nrows * 4
                  + nrows * (E + 2) * 256 * 4)
        evals = int(n_eval.sum(dtype=torch.int64))
        hits = int(n_hit.sum(dtype=torch.int64))
        res.update(bound(bytes_, evals * OPS_EVAL + hits * (
            OPS_HIT + 2 * E + OPS_HIT_MODE["extras_only"])), evals=evals,
            hits=hits, pairs_walked=pairs)
    res["k2"] = compare_k2(label + (" merged" if merged else " tile list"),
                           flat, b, grid_x, E, "extras_only", timing,
                           fwd=(out, iout), **kw)
    return res


def compare_sparse(label, flat, b, grid_x, width, height, n_draws, E=16,
                   timing=False):
    """K5 and K6 on n_draws random pixels (slots from spix_from_idx): K5
    against its plain version (n_contrib exactly, T and features within
    TOL) and at every drawn pixel bit for bit K1 extras_only with a done0
    that frees the same pixels; K6 and the segment sum at D = E against
    theirs (K2_TOL of each column's largest |value|), twice, bit for bit
    equal."""
    import torch
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops import blend_visits as bv
    dev = flat.device
    nt = b.tile_start.numel()
    gen = torch.Generator(device=dev).manual_seed(13)
    idx = torch.randint(0, width * height, (n_draws,), generator=gen,
                        device=dev)
    S = bs.pick_sparse_s(n_draws, nt)
    spix, _, _, ov = bs.spix_from_idx(idx, width, height, 16, S)
    check(not bool(ov), f"{label}: {n_draws} draws overflow S = {S}")
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, spix, grid_x, E)
    feat, aux = bs.blend_sparse_fwd(*args)
    torch.cuda.synchronize()
    (feat_r, aux_r, n_eval, n_hit), plain5 = timed(
        lambda: bs.blend_sparse_fwd_reference(*args, count_work=True))
    eT = float((aux[..., 0] - aux_r[..., 0]).abs().max())
    eF = float((feat - feat_r).abs().max())
    nc_eq = torch.equal(aux[..., 1], aux_r[..., 1])
    t_i, s_i = torch.nonzero(spix >= 0, as_tuple=True)
    p_i = spix[t_i, s_i].long()
    d0 = torch.ones((nt, 1, 256), dtype=torch.int32, device=dev)
    d0[t_i, 0, p_i] = 0
    out, iout = bv.blend_fwd(flat, b.sorted_gid, b.tile_start, b.tile_end,
                             grid_x, E, extras_only=True, done0=d0)
    bit = (torch.equal(feat[t_i, s_i], out[t_i, 10:10 + E, p_i])
           and torch.equal(aux[t_i, s_i, 0], out[t_i, 9, p_i])
           and torch.equal(aux[t_i, s_i, 1], iout[t_i, 0, p_i].float()))
    gout = torch.randn(feat.shape, generator=gen, device=dev)
    runs = (b.gid_order, b.run_start)
    n = flat.shape[0]
    d1 = bs.blend_sparse_bwd(*args, gout, aux)
    f1 = bv.reduce_per_gaussian(d1, b.sorted_gid, n, runs)
    d2 = bs.blend_sparse_bwd(*args, gout, aux)
    f2 = bv.reduce_per_gaussian(d2, b.sorted_gid, n, runs)
    torch.cuda.synchronize()
    same = torch.equal(d1, d2) and torch.equal(f1, f2)
    (d_ref, (evals6, hits6, slots6)), plain6 = timed(
        lambda: bs.blend_sparse_bwd_reference(*args, gout, aux,
                                              count_work=True))
    f_ref = bv.reduce_per_gaussian_reference(d_ref, b.sorted_gid, n)
    torch.cuda.synchronize()
    e6 = max(col_rel_err(d1, d_ref), col_rel_err(f1, f_ref))
    print(f"[kernel] {label} K5/K6 E={E}: {n_draws} draws in {t_i.numel()} "
          f"slots, S={S}, pairs={b.total_pairs}; K5 final T {eT:.3g}, "
          f"features {eF:.3g} (tol {TOL['final_T']:g}, "
          f"{TOL['features']:g}), n_contrib equal {nc_eq}; bit for bit K1 "
          f"extras_only + done0 at the drawn pixels: {bit}; K6 rows and "
          f"d_flat {e6:.3g} of each column's max |value| (tol {K2_TOL:g}), "
          f"two runs bit for bit equal: {same}", flush=True)
    check(nc_eq and eT <= TOL["final_T"] and eF <= TOL["features"],
          f"{label} K5 differs from its plain version")
    check(bit, f"{label} K5 differs from K1 extras_only at the drawn pixels")
    check(e6 <= K2_TOL and same and hits6 > 0,
          f"{label} K6: {e6}, repeatable {same}, {hits6} contributions")
    res = {"k5": {"max_abs_err": max(eT, eF)},
           "k6": {"max_abs_err": float((d1 - d_ref).abs().max())},
           "S": S, "slots": t_i.numel()}
    if timing:
        P = b.sorted_gid.numel()
        # both walk the frame's pairs: the splat (+ feature, K5) columns of
        # the gaussians, the pair list and ranges, spix; K5 writes feat and
        # aux, K6 reads gout and aux and writes d_sorted
        common = P * 4 + 2 * nt * 4 + spix.numel() * 4
        evals = int(n_eval.sum(dtype=torch.int64))
        hits = int(n_hit.sum(dtype=torch.int64))
        r5 = res["k5"]
        r5["ms"] = time_ms(lambda: bs.blend_sparse_fwd(*args), 20)
        r5["plain_ms"] = plain5         # one call, work counts included
        r5.update(bound(n * (SPLAT_COLS + E) * 4 + common
                        + feat.numel() * 4 + aux.numel() * 4,
                        evals * OPS_EVAL + hits * (
                            OPS_HIT + 2 * E + OPS_HIT_MODE["extras_only"])),
                  evals=evals, hits=hits)
        r6 = res["k6"]
        r6["ms"] = time_ms(lambda: bs.blend_sparse_bwd(*args, gout, aux), 20)
        r6["plain_ms"] = plain6
        r6.update(bound(n * SPLAT_COLS * 4 + common + gout.numel() * 4
                        + aux.numel() * 4 + P * E * 4,
                        evals6 * OPS_EVAL
                        + hits6 * (OPS_BWD_EXTRAS_HIT + E)
                        + (hits6 - slots6) * E),
                  evals=evals6, hits=hits6, slots=slots6)
    return res


def semantic_frame_kernels(p, make_cam):
    """The semantic step's kernels on camera 0 at 976x728 (300k gaussians,
    E=16): K1 extras_only with a 32k-pixel done0 and without, K2
    extras_only, the segment sum at D = 16 and K1 track, against their
    plain versions, timed, with their bounds."""
    W, H = SEM["width"], SEM["height"]
    flat, b, gx = frame_inputs(p, make_cam(0, W, H), W, H, True)
    res = compare_extras("semantic-frame", flat, b, gx, W, H, SEM["batch"],
                         timing=True)
    for tag in ("done0", "plain"):
        r = res[tag]
        print(f"[kernel] semantic-frame extras_only ({tag}) E=16: K1 "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} bytes, "
              f"{r['evals']} evaluations, {r['hits']} contributions, "
              f"{r['ops']} FP32 ops)", flush=True)
        k2 = res["k2"][tag]
        sg = k2["segment_sum"]
        print(f"[kernel] semantic-frame K2 extras_only ({tag}) E=16: "
              f"{k2['ms']:.4f} ms, plain {k2['plain_ms']:.1f} ms, bound "
              f"{k2['bound_ms']:.4f} ms ({k2['bound_by']}: {k2['bytes']} "
              f"bytes, {k2['ops']} FP32 ops); segment sum D=16 "
              f"{sg['ms']:.4f} ms, plain {sg['plain_ms']:.4f} ms, index_add_ "
              f"{sg['library_ms']:.4f} ms, bound {sg['bound_ms']:.4f} ms "
              f"({sg['bound_by']}); longest run {k2['longest_run']} slots, "
              f"largest tile {k2['largest_tile']} slots", flush=True)
    tr = compare_track("semantic-frame", flat, b, gx, 16, timing=True)
    print(f"[kernel] semantic-frame track E=16: K1 {tr['ms']:.4f} ms, plain "
          f"{tr['plain_ms']:.1f} ms, bound {tr['bound_ms']:.4f} ms "
          f"({tr['bound_by']}: {tr['bytes']} bytes, {tr['ops']} FP32 ops)",
          flush=True)
    res["track"] = tr

    # K5/K6 on the single-view draws of the plain step (32k, no anchors)
    sp = compare_sparse("semantic-frame", flat, b, gx, W, H, SEM["batch"],
                        timing=True)
    del flat, b
    # K3/K4 on bench.py's 128 tiles of each window view, K1/K2
    # tiles_per_view over the whole window (views 1-5)
    from instascene_tpu_torch.ops.binning import merge_binnings, select_tiles
    sel = bench_tiles(W, H)
    views, capped, sub = [], 0, None
    for i, v in enumerate(range(1, 1 + SEM["n_mv"])):
        flat, b, _ = frame_inputs(p, make_cam(v, W, H), W, H, True)
        views.append((flat, b))
        capped += int(select_tiles(sel[i], b).jax_capped_chunks)
        r = compare_selected(f"semantic-frame view {v}", flat, b, gx,
                             sel[i], timing=i == 0)
        sub = sub or r
    print(f"[kernel] semantic-frame tile subsets: the JAX package's mini "
          f"bundles (8 chunks of 128 pairs per tile) would cut {capped} "
          f"chunks over the {SEM['n_mv']} views' {SEM['mv_k']} tiles; K3/K4 "
          f"walk them whole", flush=True)
    fm, bm, T = merge_binnings(views)
    mg = compare_selected("semantic-frame", fm, bm, gx, ("views", T, views),
                          timing=True)
    for name, r in (("K3 (view 1)", sub), ("K4 (view 1)", sub["k2"]),
                    ("K1 tiles_per_view", mg),
                    ("K2 tiles_per_view", mg["k2"]),
                    ("K5", sp["k5"]), ("K6", sp["k6"])):
        print(f"[kernel] semantic-frame {name} E=16: {r['ms']:.4f} ms, "
              f"plain {r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}: {r['bytes']} bytes, {r['ops']} FP32 ops)",
              flush=True)
    res.update(k3=sub, merged=mg, sparse=sp, jax_capped_chunks=capped)
    return res


def bench_tiles(width, height):
    """bench.py:258-263's tile subsets: SEM["mv_k"] sorted unique tiles per
    window view from numpy's default_rng(7), as int32 on the card."""
    import torch
    nt = ((width + 15) // 16) * ((height + 15) // 16)
    rng = np.random.default_rng(7)
    return torch.as_tensor(np.stack([np.sort(rng.choice(
        nt, SEM["mv_k"], replace=False)).astype(np.int32)
        for _ in range(SEM["n_mv"])]), device=DEVICE)


def semantic_inputs(st, make_cam, dev):
    """bench.py's semantic inputs on the port: the 300k scene with its
    features, six orbit cameras with their binning, the random 40-label
    segmap as raw and sorted map, random 3D labels. Returns (params, cams,
    hyp, scfg, pairs per view)."""
    import torch
    from instascene_tpu_torch.config import OptimizationParams
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.models.optimizer import semantic_lrs
    from instascene_tpu_torch.ops.rasterize import (RasterizeConfig,
                                                    compute_binning_cache)
    from instascene_tpu_torch.pipelines import train_semantic as ts
    from instascene_tpu_torch.pipelines.train import camera_tensors
    from instascene_tpu_torch.semantic.contrastive import valid_ids_pack
    W, H = SEM["width"], SEM["height"]
    p = from_numpy(st, dev)
    rng = np.random.default_rng(1)
    segmap = torch.as_tensor(rng.integers(0, SEM["labels"], (H, W)).astype(
        np.int32), device=dev)
    lab3d = torch.as_tensor(rng.integers(0, SEM["labels"], p.capacity).astype(
        np.int32), device=dev)
    seg_pack = valid_ids_pack(segmap.reshape(-1) > 0)
    vis_pack = valid_ids_pack(lab3d > 0)
    seg_nv, vis_nv = int(seg_pack[-1]), int(vis_pack[-1])
    cams = []
    for i in range(SEM["cams"]):
        ct = camera_tensors(make_cam(i, W, H), dev)
        binning = compute_binning_cache(p, ct.mats, W, H)
        cams.append(ts.SemanticCamera(
            ct.w2v, ct.full_proj, ct.campos, segmap, segmap, binning,
            seg_pack, seg_pack, vis_pack, seg_nv, seg_nv, vis_nv))
    hyp = ts.SemanticHypers(
        bg=torch.zeros(3, device=dev),
        lrs=semantic_lrs(OptimizationParams()), lam_sv=1e-6, lam_mv=1e-6,
        lam_3d=2.5e-6, seg3d_labels=lab3d)
    scfg = ts.SemanticStepConfig(
        raster=RasterizeConfig(W, H, bwd_extras_only=True),
        batch=SEM["batch"], max_labels=SEM["max_labels"])
    return p, cams, hyp, scfg, [c.binning.total_pairs for c in cams]


def sem_stages():
    """The semantic step's stage functions for `wrapped`: preprocess and
    pack (called from the rasterizer and from the multi-view losses), the
    forward blend kernels (K1, K3; K5) and the backward ones (K2, K4; K6;
    the segment sum)."""
    from instascene_tpu_torch.ops import blend_sparse as bsp
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops import rasterize as rmod
    from instascene_tpu_torch.pipelines import train_semantic as ts
    return {(rmod, "preprocess_gaussians"): "preprocess",
            (ts, "preprocess_gaussians"): "preprocess",
            (rmod, "pack_flat_cols"): "pack",
            (bv, "blend_fwd"): "fwd", (bsp, "blend_sparse_fwd"): "fwd",
            (bv, "blend_bwd"): "bwd", (bsp, "blend_sparse_bwd"): "bwd",
            (bv, "reduce_per_gaussian"): "bwd"}


def run_steps(tag, state, cams, window, hyp, scfg, steps, gen):
    """SEM["warm"] warm-up and `steps` timed semantic_train_step calls
    (camera i mod 6, the window on every one when given), each with its
    stage split (inside `wrapped(sem_stages())`). Returns the medians and
    the losses."""
    import torch
    from instascene_tpu_torch.pipelines import train_semantic as ts
    splits, losses = [], []
    for i in range(SEM["warm"] + steps):
        StageClock.current = clock = StageClock()
        state[0], state[1], loss = ts.semantic_train_step(
            state[0], state[1], cams[i % len(cams)], window, hyp, scfg,
            generator=gen, on_stage=clock.mark)
        torch.cuda.synchronize()
        if i < SEM["warm"]:
            continue
        g = {k: clock.total(k) for k in ("preprocess", "pack", "fwd", "bwd")}
        splits.append({
            "step": clock.ms("start", "adam"),
            "preprocess + SH": g["preprocess"], "pack": g["pack"],
            "blend forward (K1/K3/K5)": g["fwd"],
            "losses, draws and the rest of the forward":
                clock.ms("start", "loss") - g["preprocess"] - g["pack"]
                - g["fwd"],
            "blend backward (K2/K4/K6) + segment sum": g["bwd"],
            "rest of backward": clock.ms("loss", "backward") - g["bwd"],
            "Adam": clock.ms("backward", "adam")})
        losses.append(float(loss))
    med = {k: float(np.median([x[k] for x in splits])) for k in splits[0]}
    print(f"[semantic] {tag}: {steps} timed steps; losses {losses[0]:.6g} → "
          f"{losses[-1]:.6g}", flush=True)
    print(f"[semantic] {tag} median ms (CUDA events): " + ", ".join(
        f"{k} {v:.3f}" for k, v in med.items()), flush=True)
    check(all(np.isfinite(losses)), f"semantic {tag}: non-finite loss")
    check(bool(torch.isfinite(state[0].seg_feature).all()),
          f"semantic {tag}: non-finite features")
    return {"median_ms": med, "losses": losses}


def semantic_phase(st, make_cam, dev):
    """semantic_train_step at the benchmark's size: 3 warm-up steps, 20
    timed plain steps, 3 more warm-up steps and 6 timed steps with the
    5-view window (views 1-5), each with its stage split, the launch
    counts reset just before the steps and read just after; the sustained
    it/s by bench.py's formula. Then each multi-view variant the same way,
    with its own launch counts: the window tile-subsampled (bench.py's 128
    tiles per view; K3/K4), merged (K1/K2 tiles_per_view), and with sparse
    pixels (K5/K6; 20 plain sparse steps too). Then the tracker view's
    s/view."""
    import dataclasses

    import torch
    from instascene_tpu_torch.models.optimizer import init_adam_state
    from instascene_tpu_torch.pipelines import train_semantic as ts
    W, H = SEM["width"], SEM["height"]
    p, cams, hyp, scfg, pairs = semantic_inputs(st, make_cam, dev)
    window = cams[1:1 + SEM["n_mv"]]
    mv = ts.SemanticMVBlock(window)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = [p, init_adam_state(p)]
    results = {}
    print(f"[semantic] at {W}x{H}, {p.n_alive()} gaussians, E=16, pairs per "
          f"view {pairs}", flush=True)
    reset_counts()
    with wrapped(sem_stages()):
        results["plain"] = run_steps("plain", state, cams, None, hyp, scfg,
                                     SEM["steps"], gen)
        results["mv"] = run_steps("mv", state, cams, mv, hyp, scfg,
                                  SEM["mv_steps"], gen)
    torch.cuda.synchronize()
    results["counts"] = counts()
    t_plain = results["plain"]["median_ms"]["step"]
    sustain = lambda tp, tw: 1e3 / (0.9 * tp + 0.1 * tw)
    sustained = sustain(t_plain, results["mv"]["median_ms"]["step"])
    print(f"[semantic] plain {1e3 / t_plain:.2f} it/s, with the window "
          f"{1e3 / results['mv']['median_ms']['step']:.2f} it/s, sustained "
          f"(bench.py:325-329) {sustained:.2f} it/s", flush=True)
    results.update(sustained_its=sustained, pairs=pairs)

    variants = (
        ("tiles", scfg, ts.SemanticMVBlock(window, bench_tiles(W, H)),
         ("K3 extras_only", "K4 extras_only")),
        ("merged", dataclasses.replace(scfg, mv_merged=True), mv,
         ("K1 tiles_per_view", "K2 tiles_per_view")),
        ("sparse", dataclasses.replace(scfg, sparse_px=True), mv,
         ("K5", "K6")))
    for tag, vcfg, vmv, must in variants:
        reset_counts()
        with wrapped(sem_stages()):
            r = {}
            if tag == "sparse":
                r["plain"] = run_steps(f"{tag} plain", state, cams, None,
                                       hyp, vcfg, SEM["steps"], gen)
            r["mv"] = run_steps(f"{tag} window", state, cams, vmv, hyp, vcfg,
                                SEM["mv_steps"], gen)
        torch.cuda.synchronize()
        r["counts"] = c = counts()
        tp = r["plain"]["median_ms"]["step"] if "plain" in r else t_plain
        r["sustained_its"] = sustain(tp, r["mv"]["median_ms"]["step"])
        print(f"[semantic] {tag}: window step "
              f"{r['mv']['median_ms']['step']:.3f} ms, plain step {tp:.3f} "
              f"ms, sustained {r['sustained_its']:.2f} it/s; launches "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        for k in must:
            check(c[k] > 0, f"the {tag} steps never launched {k}")
        check(c["sparse_fallback"] == 0, f"{tag}: {c['sparse_fallback']} "
              f"steps fell back to the dense path")
        results[tag] = r

    # the priors stage's tracker view (bench.py:478-511): full render with
    # fresh binning and contributor tracking, E=16
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    cfg = RasterizeConfig(W, H, track_contrib=True)
    view = lambda: ts.render_features(p, cams[0].mats, hyp.bg, cfg)
    results["tracker_s"] = time_ms(view, 5) * 1e-3
    print(f"[semantic] tracker view {W}x{H}, E=16: "
          f"{results['tracker_s']:.5f} s/view (CUDA events)", flush=True)
    return results


def write_semantic_scene(st, make_cam, dev, root):
    """The geometry CLI's COLMAP scene plus what the semantic stage reads:
    point_cloud.ply (the 300k scene without features) and sam/mask/<image>
    maps from the port's own tracker render — each pixel the true cluster +
    1 of its largest-weight tracked contributor, 0 where alpha < 0.5,
    nothing was tracked, the contributor is background, or another tracked
    contributor of the pixel belongs to another cluster. The last rule
    keeps a mask's gaussians on its own instance, as a segmenter's mask of
    an opaque object does: with the scene's semi-transparent splats mixed
    in, the spatial track judges nearly every mask undersegmented. It also
    cuts the masks along the true clusters, so the instances the stage
    finds show that the path runs, not how well the spatial track
    separates instances (tests/test_torch_spatial_track.py holds that to
    the JAX package's)."""
    import torch
    from instascene_tpu_torch.models.gaussians import save_ply
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig
    from instascene_tpu_torch.pipelines.train_semantic import render_features
    from instascene_tpu_torch.render import camera_mats
    from instascene_tpu_torch.utils.image import write_png
    W, H = TRAIN["width"], TRAIN["height"]
    write_colmap_scene(st, make_cam, dev, root)
    p = train_scene(st, dev)
    save_ply(p, os.path.join(root, "point_cloud.ply"))
    os.makedirs(os.path.join(root, "sam", "mask"))
    clusters = torch.as_tensor(make_cam.clusters, device=dev).long()
    bg = int(clusters.max())
    cfg = RasterizeConfig(W, H, track_contrib=True)
    for i in range(CLI_CAMS):
        with torch.no_grad():
            blend = render_features(p, camera_mats(make_cam(2 * i, W, H), dev),
                                    torch.zeros(3, device=dev), cfg).blend
        top = blend.contrib_w.argmax(dim=-1, keepdim=True)
        gid = torch.gather(blend.contrib_ids, -1, top)[..., 0].long()
        cl = clusters[gid.clamp(min=0)]
        ids = blend.contrib_ids.long()
        mixed = ((ids >= 0) & (clusters[ids.clamp(min=0)] != cl[..., None])
                 ).any(dim=-1)
        lab = torch.where((gid >= 0) & (blend.alpha >= 0.5) & (cl != bg)
                          & ~mixed, cl + 1, 0)
        write_png(os.path.join(root, "sam", "mask", f"{i:03d}.png"),
                  lab.to(torch.uint8).cpu().numpy())


def semantic_cli_phase(st, make_cam, tmp):
    """The semantic CLI at full width: priors (tracker renders, spatial
    track), SEM_CLI_ITERS contrastive iterations with the save at the
    last, the HDBSCAN export; the launch counts reset just before
    train_semantic.main and read just after."""
    import torch
    from instascene_tpu_torch import train_semantic
    from instascene_tpu_torch.data.ply import read_ply
    from instascene_tpu_torch.models.gaussians import load_ply
    root = os.path.join(tmp, "data", "orbit", "scene")
    t0 = time.perf_counter()
    write_semantic_scene(st, make_cam, DEVICE, root)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    reset_counts()
    seg = train_semantic.main([
        "-s", root, "-m", os.path.join(tmp, "out"), "--use_seg_feature",
        "--gram_feat_3d", "--iterations", str(SEM_CLI_ITERS), "--device",
        DEVICE])
    torch.cuda.synchronize()
    cli_counts = counts()
    t2 = time.perf_counter()
    m3d = seg.seg3d_masks
    clusters = make_cam.clusters
    purity = []
    for k in range(m3d.shape[1]):
        members = clusters[:len(m3d)][m3d[:, k]]
        purity.append(float(np.bincount(members).max() / max(len(members), 1))
                      if len(members) else 0.0)
    od = os.path.join(seg.model_path, "semantic_association",
                      "output_dict.npy")
    ply = os.path.join(seg.model_path, "point_cloud",
                       f"iteration_{SEM_CLI_ITERS}", "point_cloud.ply")
    names = read_ply(ply)["vertex"].dtype.names
    feats = load_ply(ply, seg_feat_dim=16, load_seg_feat=True,
                     device="cpu").seg_feature
    labels_ply = os.path.join(seg.model_path, "point_cloud",
                              f"iteration_{SEM_CLI_ITERS}_hdbscan",
                              "point_cloud_labels.ply")
    n_labels = len(np.unique(np.load(labels_ply.replace(".ply", ".npy"))))
    tm = seg.timings
    print("[semantic-cli] HDBSCAN stages, s: " + ", ".join(
        f"{k[8:]} {v:.2f}" for k, v in tm.items()
        if k.startswith("HDBSCAN ")), flush=True)
    print(f"[semantic-cli] scene written in {t1 - t0:.1f} s; "
          f"train_semantic.main in {t2 - t1:.1f} s host wall: tracker renders "
          f"{tm['tracker renders']:.2f} s, spatial track "
          f"{tm['spatial track']:.2f} s, training {tm['training']:.2f} s "
          f"({SEM_CLI_ITERS} iterations, last loss {seg.last_loss:.6g}), "
          f"HDBSCAN export {tm['hdbscan export']:.2f} s", flush=True)
    print(f"[semantic-cli] {m3d.shape[1]} instances, purity against the true "
          f"clusters (the masks were cut along them) " + ", ".join(
              f"{x:.3f}" for x in purity)
          + f"; HDBSCAN labels {n_labels}", flush=True)
    print(f"[semantic-cli] launches in train_semantic.main: {cli_counts}",
          flush=True)
    for k in ("K1 extras_only", "K1 track", "K2 extras_only", "segment_sum"):
        check(cli_counts[k] > 0, f"the semantic CLI never launched {k}")
    check(os.path.exists(od) and os.path.isdir(os.path.join(
        root, "sam", "mask_sorted")), "output_dict.npy or mask_sorted missing")
    check(m3d.shape[1] >= 2, f"only {m3d.shape[1]} instances")
    check(all(f"segfeat_{i}" in names for i in range(16)),
          "the PLY has no segfeat_0..15")
    check(feats is not None and bool(np.isfinite(feats.numpy()).all()),
          "the PLY's features do not load back finite")
    check(os.path.exists(labels_ply), "point_cloud_labels.ply missing")
    return {"instances": m3d.shape[1], "purity": purity,
            "counts": cli_counts, "root": root, **tm}


def semantic_cli_variant(root, out, tag, flags, must):
    """train_semantic.main again on the scene semantic_cli_phase wrote, with
    multi-view flags, the launch counts reset just before and read just
    after: every kernel of `must` launched, the PLY at the last iteration
    holds segfeat_0..15 that load back finite, the HDBSCAN export ran."""
    import torch
    from instascene_tpu_torch import train_semantic
    from instascene_tpu_torch.data.ply import read_ply
    from instascene_tpu_torch.models.gaussians import load_ply
    reset_counts()
    t0 = time.perf_counter()
    seg = train_semantic.main([
        "-s", root, "-m", out, "--use_seg_feature", "--gram_feat_3d",
        "--iterations", str(SEM_CLI_ITERS), "--device", DEVICE, *flags])
    torch.cuda.synchronize()
    c = counts()
    t1 = time.perf_counter()
    ply = os.path.join(out, "point_cloud", f"iteration_{SEM_CLI_ITERS}",
                       "point_cloud.ply")
    names = read_ply(ply)["vertex"].dtype.names
    feats = load_ply(ply, seg_feat_dim=16, load_seg_feat=True,
                     device="cpu").seg_feature
    tm = seg.timings
    print(f"[semantic-cli {tag}] {' '.join(flags)}: train_semantic.main in "
          f"{t1 - t0:.1f} s host wall: training {tm['training']:.2f} s "
          f"({SEM_CLI_ITERS} iterations, last loss {seg.last_loss:.6g}), "
          f"HDBSCAN export {tm['hdbscan export']:.2f} s; "
          f"{seg.seg3d_masks.shape[1]} instances; launches "
          f"{ {k: v for k, v in c.items() if v} }", flush=True)
    for k in must:
        check(c[k] > 0, f"the semantic CLI ({tag}) never launched {k}")
    check(all(f"segfeat_{i}" in names for i in range(16)),
          f"{tag}: the PLY has no segfeat_0..15")
    check(feats is not None and bool(np.isfinite(feats.numpy()).all()),
          f"{tag}: the PLY's features do not load back finite")
    check(os.path.exists(os.path.join(
        out, "point_cloud", f"iteration_{SEM_CLI_ITERS}_hdbscan",
        "point_cloud_labels.ply")), f"{tag}: point_cloud_labels.ply missing")
    return {"counts": c, **tm}



# ------------------------------------------------- padded layout, clip_rect
# K8 per contribution, as K2 `full` (the same walk)
OPS_BWD_FULL_HIT = OPS_BWD_HIT + OPS_BWD_HIT_FULL
# clip_rect's rect test per slot: 4 compares (the splat of a gated slot is
# not part of the function; the work counts leave it out)
RECT_OPS = 4


def k7_bound(b, E, n_eval, n_hit):
    """K7's least time: the real slots' columns of packed (not K's
    padding), tile_count and the outputs, against K1 `full`'s FP32
    operations on these inputs."""
    import torch
    nt = b.tile_start.numel()
    bytes_ = (b.total_pairs * (21 + E) * 4 + nt * 4
              + nt * (12 + E + 2) * 256 * 4)
    evals = int(n_eval.sum(dtype=torch.int64))
    hits = int(n_hit.sum(dtype=torch.int64))
    return dict(bound(bytes_, evals * OPS_EVAL + hits * (
        OPS_HIT + 2 * E + OPS_HIT_MODE["full"])), evals=evals, hits=hits)


def k8_bound(b, E, K, evals, hits, slots):
    """K8's least time: the real slots' columns of packed, tile_count,
    gout, saved and iout read once, and all of d(packed) [T, D, K]
    written (its zeros past each tile's slots are part of the function's
    output), against K2 `full`'s FP32 operations on these inputs."""
    nt = b.tile_start.numel()
    D = 21 + E
    bytes_ = (b.total_pairs * D * 4 + nt * 4
              + nt * (12 + E + 3 + 2) * 256 * 4 + nt * D * K * 4)
    return bound(bytes_, evals * OPS_EVAL
                 + hits * (OPS_BWD_FULL_HIT + OPS_BWD_HIT_E * E)
                 + (hits - slots) * D)


def compare_padded(label, flat, b, grid_x, E, exact=True, timing=False,
                   bwd=True):
    """K7 and K8 over the padded layout of binning b on the card against
    their plain versions: n_contrib and med_slot exactly (or on all but
    1e-5 of the pixels at full width), rows within TOL; d(packed) within
    K2_TOL of each column's largest |value| and bit for bit equal over two
    runs. Both also against K1/K2 `full` on the same binning, which walk
    the same rows in the same order: K7's out/iout and K8's per-slot rows
    bit for bit theirs. bwd=False: K7 alone."""
    import torch
    from instascene_tpu_torch.ops import blend_padded as bp
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import padded_layout
    idx, count = padded_layout(b)
    packed = bp.pack_inputs(flat, idx)
    T, D, K = packed.shape
    out, iout = bp.blend_fwd_padded(packed, count, grid_x, E)
    torch.cuda.synchronize()
    (out_r, iout_r, n_eval, n_hit), plain7 = timed(
        lambda: bp.blend_fwd_padded_reference(packed, count, grid_x, E,
                                              count_work=True))
    agree = iout[:, 0] == iout_r[:, 0]
    mism = int((~agree).sum())
    slot_mism = int(((iout[:, 1] != iout_r[:, 1]) & agree).sum())
    errs = row_errors(out, out_r, E, "full", agree)
    bargs = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    k1, ik1 = bv.blend_fwd(*bargs)
    as_k1 = bool(torch.equal(out, k1) and torch.equal(iout, ik1))
    print(f"[kernel] {label} K7 E={E}: pairs={b.total_pairs} K={K} packed "
          f"{packed.numel() * 4} bytes; n_contrib mismatches={mism}/"
          f"{agree.numel()} med_slot mismatches={slot_mism} "
          + " ".join(f"{k}={v[0]:.3g}(tol {v[1]:g})" for k, v in
                     errs.items())
          + f", bit for bit K1 full's: {as_k1}", flush=True)
    check(mism == 0 if exact else mism <= 1e-5 * agree.numel(),
          f"{label} K7 E={E}: {mism} n_contrib mismatches")
    check(slot_mism == 0, f"{label} K7 E={E}: med_slot differs")
    for k, (err, tol) in errs.items():
        check(err <= tol, f"{label} K7 E={E}: {k} error {err} > {tol}")
    check(as_k1, f"{label} K7 E={E}: not bit for bit K1 full's")
    res = {"k7": {"max_abs_err": max(e for e, _ in errs.values())},
           "K": K, "packed_bytes": packed.numel() * 4}
    if timing:
        r7 = res["k7"]
        r7["ms"] = time_ms(lambda: bp.blend_fwd_padded(packed, count,
                                                       grid_x, E), 20)
        r7["k1_ms"] = time_ms(lambda: bv.blend_fwd(*bargs), 20)
        r7["plain_ms"] = plain7
        r7.update(k7_bound(b, E, n_eval, n_hit))
    if not bwd:
        return res
    saved = torch.stack([out[:, 9], out[:, 10 + E], out[:, 11 + E]],
                        dim=1).contiguous()
    gen = torch.Generator(device=flat.device).manual_seed(17 + E)
    gout = torch.randn(out.shape, generator=gen, device=flat.device)
    d1 = bp.blend_bwd_padded(packed, count, grid_x, E, gout, saved, iout)
    d2 = bp.blend_bwd_padded(packed, count, grid_x, E, gout, saved, iout)
    torch.cuda.synchronize()
    same = bool(torch.equal(d1, d2))
    (d_ref, (evals, hits, slots)), plain8 = timed(
        lambda: bp.blend_bwd_padded_reference(packed, count, grid_x, E, gout,
                                              saved, iout, count_work=True))
    rows = lambda d: d.permute(0, 2, 1).reshape(-1, D)
    err8 = col_rel_err(rows(d1), rows(d_ref))
    k2 = bv.blend_bwd(*bargs, gout, saved, iout)
    t_of = torch.repeat_interleave(torch.arange(T, device=flat.device),
                                   count.long())
    k_of = (torch.arange(b.total_pairs, device=flat.device)
            - b.tile_start.long()[t_of])
    as_k2 = bool(torch.equal(d1[t_of, :, k_of], k2))
    slot = torch.arange(K, device=flat.device)[None] < count[:, None]
    pad_zero = not bool(rows(d1)[~slot.reshape(-1)].any())
    print(f"[kernel] {label} K8 E={E}: d(packed) {err8:.3g} of each "
          f"column's max |value| (tol {K2_TOL:g}), two runs bit for bit "
          f"equal: {same}, bit for bit K2 full's rows: {as_k2}, zero past "
          f"the slots: {pad_zero}", flush=True)
    check(err8 <= K2_TOL and same and pad_zero and hits > 0,
          f"{label} K8 E={E}: {err8}, repeatable {same}, zero padding "
          f"{pad_zero}")
    check(as_k2, f"{label} K8 E={E}: not bit for bit K2 full's rows")
    r8 = res["k8"] = {"max_abs_err": float((d1 - d_ref).abs().max()),
                      "rel_err": err8}
    if timing:
        r8["ms"] = time_ms(lambda: bp.blend_bwd_padded(
            packed, count, grid_x, E, gout, saved, iout), 10)
        r8["k2_ms"] = time_ms(lambda: bv.blend_bwd(*bargs, gout, saved,
                                                   iout), 10)
        r8["plain_ms"] = plain8
        r8.update(k8_bound(b, E, K, evals, hits, slots), evals=evals,
                  hits=hits, slots=slots)
    return res


def superset_inputs(p, cam, width, height, E=16):
    """One frame's fresh inputs and its cached superset: (flat, fresh
    BinningOut, flat with the fresh rects, the binning dilated by one tile,
    grid_x)."""
    import torch
    from instascene_tpu_torch.ops.binning import bin_gaussians
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    preprocess, binning, pack = frame_stages(p, cam, width, height, E > 0, E)
    pre = preprocess()
    opac = p.opacity_activated()[:, 0]
    extras = p.seg_feature_normed()[:, :E].contiguous() if E else None
    rmax = torch.where((pre.tiles_touched > 0)[:, None], pre.rect_max,
                       pre.rect_min)
    flat_r = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                            extras, rect=(pre.rect_min, rmax))
    return (pack(pre), binning(pre), flat_r,
            bin_gaussians(pre, width, height, dilate_tiles=1),
            (width + 15) // 16)


def compare_clip(label, p, cam, width, height, E=16, modes=(
        "full", "no_dist", "viewer", "extras_only"), timing=()):
    """K1 clip_rect over the frame's binning dilated by one tile (flat
    carrying the fresh rects) against its plain version in each mode
    (iout equal, rows within TOL) and bit for bit K1's out over the fresh
    binning (a gated slot contributes nothing); K2 clip_rect (not viewer)
    against its plain version (compare_k2), and its d_flat bit for bit
    the fresh binning's. timing: the modes whose kernels are timed.
    Returns {mode: numbers}."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    flat, bf, flat_r, bd, gx = superset_inputs(p, cam, width, height, E)
    print(f"[kernel] {label} clip_rect E={E}: the dilated binning holds "
          f"{bd.total_pairs} pairs, {bd.total_pairs / bf.total_pairs:.3f}x "
          f"the fresh binning's {bf.total_pairs}", flush=True)
    args = (flat_r, bd.sorted_gid, bd.tile_start, bd.tile_end, gx, E)
    fargs = (flat, bf.sorted_gid, bf.tile_start, bf.tile_end, gx, E)
    n = flat.shape[0]
    res = {"pairs": bd.total_pairs, "fresh_pairs": bf.total_pairs}
    for mode in modes:
        kw = dict(viewer=mode == "viewer", no_dist=mode == "no_dist",
                  extras_only=mode == "extras_only")
        out, iout = bv.blend_fwd(*args, clip_rect=True, **kw)
        torch.cuda.synchronize()
        (out_r, iout_r, n_eval, n_hit), plain_ms = timed(
            lambda: bv.blend_fwd_reference(*args, clip_rect=True,
                                           count_work=True, **kw))
        errs = row_errors(out, out_r, E, mode, torch.ones_like(
            iout[:, 0], dtype=torch.bool))
        own, iown = bv.blend_fwd(*fargs, **kw)
        as_fresh = bool(torch.equal(out, own))
        print(f"[kernel] {label} K1 {mode} clip_rect E={E}: iout equal to "
              f"the plain version's: {torch.equal(iout, iout_r)} "
              + " ".join(f"{k}={v[0]:.3g}(tol {v[1]:g})" for k, v in
                         errs.items())
              + f"; out bit for bit the fresh binning's: {as_fresh}",
              flush=True)
        check(torch.equal(iout, iout_r), f"{label} K1 {mode} clip_rect: "
              f"iout differs from the plain version")
        for k, (err, tol) in errs.items():
            check(err <= tol, f"{label} K1 {mode} clip_rect: {k} {err}")
        check(as_fresh, f"{label} K1 {mode} clip_rect: differs from the "
              f"fresh binning's render")
        r = {"max_abs_err": max(e for e, _ in errs.values())}
        if mode in timing:
            r["ms"] = time_ms(lambda: bv.blend_fwd(*args, clip_rect=True,
                                                   **kw), 20)
            r["fresh_ms"] = time_ms(lambda: bv.blend_fwd(*fargs, **kw), 20)
            r["plain_ms"] = plain_ms
            r.update(k1_bound(flat_r, bd, E, mode, n_eval, n_hit,
                              extra_ops=bd.total_pairs * RECT_OPS))
        if mode != "viewer":
            r["k2"] = compare_k2(f"{label} clip_rect", flat_r, bd, gx, E,
                                 mode, mode in timing, fwd=(out, iout),
                                 clip_rect=True)
            runs = (bd.gid_order, bd.run_start)
            bkw = dict(no_dist=mode == "no_dist",
                       extras_only=mode == "extras_only")
            saved = lambda o: torch.stack(
                [o[:, 9], o[:, 10 + E], o[:, 11 + E]], dim=1).contiguous()
            gen = torch.Generator(device=flat.device).manual_seed(5 + E)
            gout = torch.randn(out.shape, generator=gen, device=flat.device)
            f_c = bv.reduce_per_gaussian(bv.blend_bwd(
                *args, gout, saved(out), iout, clip_rect=True, **bkw),
                bd.sorted_gid, n, runs)
            f_f = bv.reduce_per_gaussian(bv.blend_bwd(
                *fargs, gout, saved(own), iown, **bkw), bf.sorted_gid, n,
                (bf.gid_order, bf.run_start))
            torch.cuda.synchronize()
            grad_fresh = bool(torch.equal(f_c[:, :f_f.shape[1]], f_f))
            print(f"[kernel] {label} K2 {mode} clip_rect E={E}: d_flat bit "
                  f"for bit the fresh binning's: {grad_fresh}", flush=True)
            check(grad_fresh, f"{label} K2 {mode} clip_rect: d_flat differs "
                  f"from the fresh binning's")
        res[mode] = r
    return res


def compare_tile_modes(label, flat, b, grid_x, sel, E=16, timing=False):
    """K1 over the tile list sel (K3) in `full` and `viewer` against its
    plain version (iout equal, rows within TOL) and bit for bit K1's whole
    frame rows of those tiles; K2 `full` over the list (K4) against its
    plain version (compare_k2). Returns {"full", "viewer", "k4"}."""
    import torch
    from instascene_tpu_torch.ops import blend_visits as bv
    args = (flat, b.sorted_gid, b.tile_start, b.tile_end, grid_x, E)
    res = {}
    for mode in ("full", "viewer"):
        kw = dict(viewer=mode == "viewer", tile_ids=sel)
        out, iout = bv.blend_fwd(*args, **kw)
        torch.cuda.synchronize()
        (out_r, iout_r, n_eval, n_hit), plain_ms = timed(
            lambda: bv.blend_fwd_reference(*args, count_work=True, **kw))
        errs = row_errors(out, out_r, E, mode, torch.ones_like(
            iout[:, 0], dtype=torch.bool))
        full, ifull = bv.blend_fwd(*args, viewer=mode == "viewer")
        rows = sel.long()
        bit = bool(torch.equal(out, full[rows])
                   and torch.equal(iout, ifull[rows]))
        print(f"[kernel] {label} K3 {mode} E={E}, {sel.numel()} tiles: "
              f"iout equal: {torch.equal(iout, iout_r)} "
              + " ".join(f"{k}={v[0]:.3g}(tol {v[1]:g})" for k, v in
                         errs.items())
              + f"; bit for bit the whole frame's rows: {bit}", flush=True)
        check(torch.equal(iout, iout_r) and bit,
              f"{label} K3 {mode}: iout or the listed rows differ")
        for k, (err, tol) in errs.items():
            check(err <= tol, f"{label} K3 {mode}: {k} error {err}")
        r = {"max_abs_err": max(e for e, _ in errs.values())}
        if timing:
            pairs, gauss = walked(sel, b)
            nrows = out.shape[0]
            r["ms"] = time_ms(lambda: bv.blend_fwd(*args, **kw), 10)
            r["plain_ms"] = plain_ms
            evals = int(n_eval.sum(dtype=torch.int64))
            hits = int(n_hit.sum(dtype=torch.int64))
            r.update(bound(gauss * flat.shape[1] * 4 + pairs * 4
                           + 3 * nrows * 4 + nrows * (14 + E) * 256 * 4,
                           evals * OPS_EVAL + hits * (
                               OPS_HIT + 2 * E + OPS_HIT_MODE[mode])),
                     evals=evals, hits=hits, pairs_walked=pairs)
        res[mode] = r
        if mode == "full":
            fwd = (out, iout)
    res["k4"] = compare_k2(f"{label} tile list", flat, b, grid_x, E, "full",
                           timing, fwd=fwd, tile_ids=sel)
    return res


def mid_size_layouts_and_widths(p_mid, make_cam, dev):
    """Phase 2's checks of the padded layout, clip_rect, the tile list's
    full/viewer modes and the run-time widths, at mid size, against the
    plain versions:
    K7/K8 (E=16 and 0), K1/K2 clip_rect in full, no_dist, viewer and
    extras_only, K3/K4 full/viewer over 8 random tiles, and the run-time
    feature widths E=4 and 8 on K1 (full, extras_only ± done0), K2 (full,
    extras_only), K5/K6 and K7/K8."""
    import torch
    W, H = MID["width"], MID["height"]
    cam = make_cam(0, W, H)
    for E in (16, 0):
        flat, b, gx = frame_inputs(p_mid, cam, W, H, E > 0)
        compare_padded("mid-size", flat, b, gx, E)
    compare_clip("mid-size", p_mid, cam, W, H)
    flat, b, gx = frame_inputs(p_mid, cam, W, H, True)
    sel = torch.as_tensor(np.sort(np.random.default_rng(4).choice(
        b.tile_start.numel(), 8, replace=False)).astype(np.int32),
        device=dev)
    compare_tile_modes("mid-size", flat, b, gx, sel)
    for E in (4, 8):
        flat, b, gx = frame_inputs(p_mid, cam, W, H, True, E)
        compare_kernel("mid-size", flat, b, gx, E, "full", exact=True)
        compare_k2("mid-size", flat, b, gx, E, "full")
        compare_extras("mid-size", flat, b, gx, W, H, 2000, E=E)
        compare_sparse("mid-size", flat, b, gx, W, H, 2000, E=E)
        compare_padded("mid-size", flat, b, gx, E)


def maps_of(blend):
    """A BlendOut's maps by the names maps_from_tiles gives them."""
    return {"color": blend.color, "depth": blend.depth,
            "normal": blend.normal, "median_depth": blend.median_depth,
            "distortion": blend.distortion, "final_T": blend.final_T,
            "extra": blend.extra, "n_contrib": blend.n_contrib}


# item 1's tolerances, K7's maps against render()'s (K1 full)
MAP_TOL = {"color": 3e-4, "normal": 3e-4, "depth": 3e-3,
           "median_depth": 3e-3, "distortion": 3e-3, "final_T": 2e-5,
           "extra": 5e-4}


def compare_maps(label, got, want, n_contrib=True):
    """Largest |got − want| per map over the pixels where n_contrib agrees
    (n_contrib itself may differ on at most 1e-5 of the pixels); checks
    MAP_TOL. Returns (errors, mismatches, bit for bit)."""
    import torch
    agree = got["n_contrib"] == want["n_contrib"]
    mism = int((~agree).sum())
    errs, bit = {}, True
    for k, tol in MAP_TOL.items():
        if got[k] is None:
            continue
        d = (got[k] - want[k]).abs()
        bit = bit and bool(torch.equal(got[k], want[k]))
        errs[k] = float(d[agree].max()) if n_contrib else float(d.max())
        check(errs[k] <= tol, f"{label}: {k} error {errs[k]} > {tol}")
    if n_contrib:
        check(mism <= 1e-5 * agree.numel(),
              f"{label}: {mism} n_contrib mismatches")
    return errs, mism, bit


def render_k1(p, cam, width, height, E, **kw):
    """rasterize (render()'s path, K1/K2) of p at cam → RasterizeOut."""
    import torch
    from instascene_tpu_torch.ops.rasterize import RasterizeConfig, rasterize
    from instascene_tpu_torch.render import camera_mats
    cfg_kw = {k: kw.pop(k) for k in ("clip_rect", "conic_cull",
                                     "bwd_extras_only", "fwd_viewer")
              if k in kw}
    return rasterize(p.xyz, p.scaling_activated(), p.rotation_normalized(),
                     p.opacity_activated()[:, 0],
                     camera_mats(cam, p.device), torch.zeros(3),
                     RasterizeConfig(width, height, **cfg_kw),
                     shs=p.features(), sh_degree=p.active_sh_degree,
                     extras=p.seg_feature_normed()[:, :E].contiguous()
                     if E else None, alive=p.alive, **kw)


def render_padded(p, cam, width, height, E):
    """The padded-layout frame a user composes for gradients: preprocess,
    binning, padded_layout, pack, pack_inputs, blend_padded_diff (K7/K8)
    → (maps, K)."""
    from instascene_tpu_torch.ops.binning import bin_gaussians, padded_layout
    from instascene_tpu_torch.ops.blend_padded import (blend_padded_diff,
                                                       pack_inputs)
    from instascene_tpu_torch.ops.blend_visits import pack_flat_cols
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.ops.rasterize import maps_from_tiles
    from instascene_tpu_torch.render import camera_mats
    cm = camera_mats(cam, p.device)
    opac = p.opacity_activated()[:, 0]
    pre = preprocess_gaussians(
        p.xyz, p.scaling_activated(), p.rotation_normalized(), cm.w2v,
        cm.full_proj, cm.campos, width, height, opac, shs=p.features(),
        sh_degree=p.active_sh_degree, alive=p.alive)
    idx, count = padded_layout(bin_gaussians(pre, width, height))
    flat = pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac, pre.color,
                          p.seg_feature_normed()[:, :E].contiguous()
                          if E else None)
    out, iout = blend_padded_diff(pack_inputs(flat, idx), count,
                                  (width + 15) // 16, E)
    maps = maps_from_tiles(out, iout, width, height, E)
    maps["color"] = maps["color_nobg"]          # a zero background
    return maps, idx.shape[1]


GRAD_FIELDS = ("xyz", "scaling", "rotation", "opacity", "features_dc",
               "seg_feature")


def with_grads(p):
    """A copy of p whose parameter tensors require gradients."""
    import dataclasses
    return dataclasses.replace(p, **{
        f: getattr(p, f).detach().clone().requires_grad_(True)
        for f in GRAD_FIELDS if getattr(p, f) is not None})


def map_loss(maps, weights):
    """Σ over the maps of weights·map, summed in float64."""
    return sum((maps[k].double() * w).sum() for k, w in weights.items())


def map_weights(maps, seed, dev):
    import torch
    gen = torch.Generator(device=dev).manual_seed(seed)
    return {k: torch.randn(maps[k].shape, generator=gen, device=dev).double()
            for k in MAP_TOL if maps.get(k) is not None and maps[k].numel()}


def grads_of(p, loss):
    """{field: d loss / d field} of a with_grads copy."""
    import torch
    fields = [f for f in GRAD_FIELDS if getattr(p, f) is not None]
    gs = torch.autograd.grad(loss, [getattr(p, f) for f in fields])
    return dict(zip(fields, gs))


def grad_rel_err(got, want):
    """Largest |got − want| over want's largest |value|, per gradient."""
    return {k: float((got[k] - want[k]).abs().max()
                     / want[k].abs().max().clamp(min=1e-30)) for k in want}


def envelope_misses(p, cam, width, height, pre0):
    """test_coherent.py:75-90's rule, as the number of gaussians that break
    it (0: cam is inside the envelope): every gaussian with pairs at cam
    had pairs at the cache camera, and its fresh rect lies inside the
    cached dilated rect."""
    import torch
    from instascene_tpu_torch.ops.binning import dilate_rects
    gx, gy = (width + 15) // 16, (height + 15) // 16
    dmin, dmax, _ = dilate_rects(pre0.rect_min, pre0.rect_max,
                                 pre0.tiles_touched, gx, gy, 1)
    pre = frame_stages(p, cam, width, height, False)[0]()
    need = pre.tiles_touched > 0
    ok = ((pre0.tiles_touched > 0) & (pre.rect_min >= dmin).all(-1)
          & (pre.rect_max <= dmax).all(-1))
    return int((need & ~ok).sum())


def padded_superset_phase(st, make_cam, dev):
    """Phase 8: the padded and cached-superset paths at full width, launch
    counts reset just before their entry points and read just after:
    rasterize_padded_fwd (K7) at 1920x1080 on camera 0 and four orbit
    frames; the padded layout's differentiable frame (K7/K8) at 976x728
    without and with features; rasterize with clip_rect over a cache
    dilated by one tile at camera 0 (K1/K2 clip_rect, full and
    extras_only) and at an orbit step inside its envelope; rasterize over
    bench.py's 128 tiles of view 1 (K3/K4 full, K3 viewer); rasterize with
    conic_cull at 1080p. Then each against its reference and the kernels
    timed with their bounds. Returns the numbers for the kernels' line."""
    import torch
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops.rasterize import compute_binning_cache
    from instascene_tpu_torch.ops.rasterize_padded import (
        rasterize_padded_fwd)
    from instascene_tpu_torch.render import camera_mats
    from instascene_tpu_torch.viewer.gui import OrbitCamera
    FW, FH = FULL["width"], FULL["height"]
    SW, SH = SEM["width"], SEM["height"]
    p16 = from_numpy(st, dev)
    p0 = train_scene(st, dev)
    orbit = OrbitCamera(FW, FH, r=4.0)
    cams = [make_cam(0, FW, FH)]
    for _ in range(4):
        orbit.orbit(400.0, 60.0)
        cams.append(orbit.minicam())
    sem0, sem1 = make_cam(0, SW, SH), make_cam(1, SW, SH)
    sel = bench_tiles(SW, SH)[0]
    res = {}

    # ---- the entry points, counted
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        padded = []
        for c in cams:
            cm = camera_mats(c, dev)
            maps = rasterize_padded_fwd(
                p16.xyz, p16.scaling_activated(), p16.rotation_normalized(),
                p16.opacity_activated()[:, 0], cm, torch.zeros(3), FW, FH,
                shs=p16.features(), sh_degree=p16.active_sh_degree,
                extras=p16.seg_feature_normed(), alive=p16.alive)[0]
            check(all(bool(torch.isfinite(v).all()) for v in maps.values()),
                  "rasterize_padded_fwd: non-finite maps")
            padded.append(maps)
    diff = {}
    for tag, p, E in (("E=0", p0, 0), ("E=16", p16, 16)):
        pg = with_grads(p)
        maps, K = render_padded(pg, sem0, SW, SH, E)
        w = map_weights(maps, 31 + E, dev)
        loss = map_loss(maps, w)
        diff[tag] = (pg, float(loss), grads_of(pg, loss), w, K)
    cache0 = compute_binning_cache(p16, camera_mats(sem0, dev), SW, SH,
                                   dilate_tiles=1)
    clip = {}
    for mode in ("full", "extras_only"):
        pg = with_grads(p16)
        o = render_k1(pg, sem0, SW, SH, 16, clip_rect=True,
                      cached_binning=cache0,
                      bwd_extras_only=mode == "extras_only")
        w = map_weights(maps_of(o.blend), 41, dev)
        if mode == "extras_only":
            w = {"extra": w["extra"], "final_T": w["final_T"]}
        loss = map_loss(maps_of(o.blend), w)
        clip[mode] = (maps_of(o.blend), grads_of(pg, loss), w)
    pre0 = frame_stages(p16, sem0, SW, SH, False)[0]()
    step, misses = None, {}
    for i in (0.02, 0.01, 0.005, 0.002, 0.001, 0.0005, 0.0002, 0.0001):
        c = make_cam(i, SW, SH)
        misses[i] = envelope_misses(p16, c, SW, SH, pre0)
        if not misses[i]:
            with torch.no_grad():
                step = (i, c, maps_of(render_k1(
                    p16, c, SW, SH, 16, clip_rect=True,
                    cached_binning=cache0).blend))
            break
    cache1 = compute_binning_cache(p16, camera_mats(sem1, dev), SW, SH)
    pg = with_grads(p16)
    o = render_k1(pg, sem1, SW, SH, 16, cached_binning=cache1, tile_ids=sel)
    w = map_weights(maps_of(o.blend), 51, dev)
    tiles = (maps_of(o.blend), grads_of(pg, map_loss(maps_of(o.blend), w)),
             w)
    with torch.no_grad():
        tiles_viewer = maps_of(render_k1(p16, sem1, SW, SH, 16,
                                         cached_binning=cache1,
                                         tile_ids=sel, fwd_viewer=True).blend)
        culled = render_k1(p16, cams[0], FW, FH, 16, conic_cull=True)
    torch.cuda.synchronize()
    launches = counts()
    print(f"[padded] launches on the padded and cached-superset paths: "
          f"{launches}; host wall {time.perf_counter() - t0:.3f} s",
          flush=True)
    for k in ("K7", "K8", "K1 full clip_rect", "K2 full clip_rect",
              "K1 extras_only clip_rect", "K2 extras_only clip_rect",
              "K3 full", "K3 viewer", "K4 full", "K1 full"):
        check(launches[k] > 0, f"phase 8 never launched {k}")
    res["launches"] = launches

    # ---- 1. K7's 1080p maps against render()'s rasterizer (K1 full)
    with torch.no_grad():
        for i, (c, got) in enumerate(zip(cams, padded)):
            want = maps_of(render_k1(p16, c, FW, FH, 16).blend)
            errs, mism, bit = compare_maps(f"K7 1080p frame {i}", got, want)
            print(f"[padded] 1080p frame {i}: K7's maps against render()'s "
                  f"K1: " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
                  + f", n_contrib mismatches {mism}, bit for bit: {bit}",
                  flush=True)
        flat, b, gx = frame_inputs(p16, cams[0], FW, FH, True)
        r = compare_padded("full-width", flat, b, gx, 16, exact=False,
                           timing=True, bwd=False)
        flat, b, gx = frame_inputs(p16, cams[0], FW, FH, True, 8)
        r8 = compare_padded("full-width", flat, b, gx, 8, exact=False,
                            timing=True, bwd=False)
        del flat, b
    k7 = r["k7"]
    print(f"[padded] 1080p camera 0, E=16: K={r['K']}, packed "
          f"{r['packed_bytes']} bytes; K7 {k7['ms']:.4f} ms, K1 full "
          f"{k7['k1_ms']:.4f} ms, plain {k7['plain_ms']:.1f} ms, bound "
          f"{k7['bound_ms']:.4f} ms ({k7['bound_by']}: {k7['bytes']} bytes, "
          f"{k7['evals']} evaluations, {k7['hits']} contributions); E=8: K7 "
          f"{r8['k7']['ms']:.4f} ms, K1 full {r8['k7']['k1_ms']:.4f} ms, "
          f"bound {r8['k7']['bound_ms']:.4f} ms", flush=True)
    res["k7"] = dict(k7, K=r["K"], packed_bytes=r["packed_bytes"],
                     ms_E8=r8["k7"]["ms"], k1_ms_E8=r8["k7"]["k1_ms"],
                     bound_ms_E8=r8["k7"]["bound_ms"])

    # ---- 2. K8: the padded frame's gradients against rasterize's (K1/K2)
    for tag, p, E in (("E=0", p0, 0), ("E=16", p16, 16)):
        pg, loss, grads, w, K = diff[tag]
        pk = with_grads(p)
        o = render_k1(pk, sem0, SW, SH, E)
        want = maps_of(o.blend)
        lk = map_loss(want, w)
        gk = grads_of(pk, lk)
        rel = grad_rel_err(grads, gk)
        lrel = abs(loss - float(lk)) / abs(float(lk))
        print(f"[padded] 976x728 {tag}: K={K}; loss through K7/K8 {loss!r}, "
              f"through K1/K2 {float(lk)!r} (rel {lrel:.3g}, tol 1e-4); "
              f"gradients " + " ".join(f"{k} {v:.3g}" for k, v in
                                       rel.items()) + " of the largest "
              f"(tol 3e-3)", flush=True)
        check(lrel <= 1e-4 and max(rel.values()) <= 3e-3,
              f"K7/K8 {tag}: loss {lrel}, gradients {rel}")
    with torch.no_grad():
        res["k8"] = {}
        for tag, p, E in (("E=0", p0, 0), ("E=16", p16, 16)):
            flat, b, gx = frame_inputs(p, sem0, SW, SH, E > 0, E)
            r = compare_padded(f"976x728 {tag}", flat, b, gx, E, exact=False,
                               timing=True)
            res["k8"][tag] = dict(r["k8"], K=r["K"],
                                  packed_bytes=r["packed_bytes"],
                                  k7_ms=r["k7"]["ms"])
            del flat, b
    from instascene_tpu_torch.ops.binning import padded_layout
    from instascene_tpu_torch.ops.blend_padded import pack_inputs
    flat, b, gx = frame_inputs(p16, sem0, SW, SH, True)
    idx, _ = padded_layout(b)
    fl = flat.detach().requires_grad_(True)
    packed = pack_inputs(fl, idx)
    dp = torch.randn(packed.shape, device=dev)
    g1 = torch.autograd.grad(packed, fl, dp, retain_graph=True)[0]
    g2 = torch.autograd.grad(packed, fl, dp, retain_graph=True)[0]
    gather_det = bool(torch.equal(g1, g2))
    gather_ms = time_ms(lambda: torch.autograd.grad(
        packed, fl, dp, retain_graph=True), 5)
    del flat, b, fl, packed, dp, g1, g2
    for tag in ("E=0", "E=16"):
        r = res["k8"][tag]
        print(f"[padded] 976x728 {tag}: K={r['K']}, packed "
              f"{r['packed_bytes']} bytes; K8 {r['ms']:.4f} ms, K2 full "
              f"{r['k2_ms']:.4f} ms, plain {r['plain_ms']:.1f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}: {r['bytes']} bytes, "
              f"{r['ops']} FP32 ops); K7 {r['k7_ms']:.4f} ms", flush=True)
    print(f"[padded] 976x728 E=16: the gather's backward (pack_inputs, "
          f"torch autograd) {gather_ms:.4f} ms; two runs bit for bit equal: "
          f"{gather_det}", flush=True)
    res["gather_backward"] = {"ms": gather_ms, "deterministic": gather_det}

    # ---- 3. clip_rect at camera 0 against the fresh render, an orbit step
    for mode in ("full", "extras_only"):
        pf = with_grads(p16)
        o = render_k1(pf, sem0, SW, SH, 16,
                      bwd_extras_only=mode == "extras_only")
        got_maps, got_grads, w = clip[mode]
        want = maps_of(o.blend)
        gf = grads_of(pf, map_loss(want, w))
        errs = {k: float((got_maps[k] - want[k]).abs().max())
                for k in MAP_TOL if want[k] is not None}
        rel = grad_rel_err(got_grads, gf)
        print(f"[superset] 976x728 camera 0, {mode}: {cache0.total_pairs} "
              f"cached pairs; clip_rect maps against the fresh render "
              + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
              + " (tol 2e-6); gradients " + " ".join(
                  f"{k} {v:.3g}" for k, v in rel.items())
              + " of the largest (tol 3e-3)", flush=True)
        check(max(errs.values()) <= 2e-6 and max(rel.values()) <= 3e-3,
              f"clip_rect {mode} at the cache camera: maps {errs}, "
              f"gradients {rel}")
    if step is None:
        print(f"[superset] no orbit step stayed inside the dilated "
              f"envelope; gaussians outside it by step (in camera steps of "
              f"2π/16): {misses}", flush=True)
    else:
        i, c, got = step
        with torch.no_grad():
            want = maps_of(render_k1(p16, c, SW, SH, 16).blend)
        print(f"[superset] orbit step {i} (inside the envelope): largest "
              f"map difference against the fresh render " + " ".join(
                  f"{k}={float((got[k] - want[k]).abs().max()):.3g}"
                  for k in MAP_TOL), flush=True)
    with torch.no_grad():
        res["clip"] = compare_clip("976x728", p16, sem0, SW, SH,
                                   modes=("full", "extras_only"),
                                   timing=("full", "extras_only"))
    for mode in ("full", "extras_only"):
        r = res["clip"][mode]
        k2 = r["k2"]
        print(f"[superset] 976x728 {mode} clip_rect: K1 {r['ms']:.4f} ms "
              f"(fresh binning {r['fresh_ms']:.4f}), plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}); K2 {k2['ms']:.4f} ms, plain "
              f"{k2['plain_ms']:.1f} ms, bound {k2['bound_ms']:.4f} ms "
              f"({k2['bound_by']})", flush=True)

    # ---- 4. K3/K4 full, K3 viewer over bench.py's 128 tiles of view 1
    with torch.no_grad():
        want = maps_of(render_k1(p16, sem1, SW, SH, 16,
                                 cached_binning=cache1).blend)
        pix = torch.zeros(((SH + 15) // 16) * ((SW + 15) // 16),
                          dtype=torch.bool, device=dev)
        pix[sel.long()] = True
        gxs = (SW + 15) // 16
        pix = pix.reshape(-1, 1, gxs, 1).expand(-1, 16, gxs, 16).reshape(
            -1, gxs * 16)[:SH, :SW]
        bit = all(bool(torch.equal(tiles[0][k][pix], want[k][pix]))
                  for k in MAP_TOL)
        bitv = all(bool(torch.equal(tiles_viewer[k][pix], want[k][pix]))
                   for k in ("color", "final_T", "extra"))
        print(f"[tiles] view 1, {sel.numel()} tiles: rasterize(tile_ids=) "
              f"full maps bit for bit the whole frame's: {bit}, viewer "
              f"color/T/features: {bitv}", flush=True)
        check(bit and bitv, "rasterize(tile_ids=) differs from the whole "
              "frame on its tiles")
        flat, b, gx = frame_inputs(p16, sem1, SW, SH, True)
        res["tiles"] = compare_tile_modes("976x728 view 1", flat, b, gx, sel,
                                          timing=True)
        del flat, b
    for mode in ("full", "viewer"):
        r = res["tiles"][mode]
        print(f"[tiles] view 1 K3 {mode}: {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})", flush=True)
    r = res["tiles"]["k4"]
    print(f"[tiles] view 1 K4 full: {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']})", flush=True)

    # ---- 5. conic culling at 1080p
    with torch.no_grad():
        want = render_k1(p16, cams[0], FW, FH, 16)
        # culled slots shift the slot numbers: n_contrib is not a map here
        errs, mism, bit = compare_maps("conic_cull 1080p",
                                       maps_of(culled.blend),
                                       maps_of(want.blend), n_contrib=False)
        cm = camera_mats(cams[0], dev)
        args = (p16.xyz, p16.scaling_activated(), p16.rotation_normalized(),
                cm.w2v, cm.full_proj, cm.campos, FW, FH,
                p16.opacity_activated()[:, 0])
        kw = dict(shs=p16.features(), sh_degree=p16.active_sh_degree,
                  alive=p16.alive)
        from instascene_tpu_torch.ops.binning import bin_gaussians
        from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
        times = {}
        for on in (False, True):
            pre = preprocess_gaussians(*args, conic_cull=on, **kw)
            times[on] = (time_ms(lambda: preprocess_gaussians(
                *args, conic_cull=on, **kw), 5),
                time_ms(lambda: bin_gaussians(pre, FW, FH), 5))
    print(f"[conic] 1080p camera 0: pairs {want.total_pairs} without, "
          f"{culled.total_pairs} with conic_cull "
          f"({1 - culled.total_pairs / want.total_pairs:.3%} fewer); "
          f"preprocess + binning {times[False][0]:.4f} + "
          f"{times[False][1]:.4f} ms without, {times[True][0]:.4f} + "
          f"{times[True][1]:.4f} ms with; maps against the unculled "
          f"render " + " ".join(f"{k}={v:.3g}" for k, v in errs.items())
          + f" (n_contrib differs on {mism} pixels: culling renumbers the "
          f"slots), bit for bit: {bit}", flush=True)
    check(culled.total_pairs < want.total_pairs,
          "conic_cull removed no pair at 1080p")
    res["conic"] = {"pairs": want.total_pairs,
                    "pairs_culled": culled.total_pairs,
                    "ms": times[False], "ms_culled": times[True]}
    return res


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
    from instascene_tpu_torch.ops.binning import merge_binnings

    # ---- 1. device and build
    phase_s = {}
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi_line = smi[0] if smi else "nvidia-smi: no output"
    print(smi_line, flush=True)
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
    phase_s["device and build"] = time.perf_counter() - t_phase

    dev = torch.device(DEVICE)
    with torch.no_grad():
        # ---- 2. kernel vs plain, and the goldens
        t_phase = time.perf_counter()
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
            for mode in ("no_dist", "full"):
                compare_k2("mid-size", flat, b, gx, E, mode)
            compare_track("mid-size", flat, b, gx, E)
        # K1 extras_only without and with a ~2,000-pixel done0, and K2
        # extras_only on each (E=16, the last frame_inputs above)
        compare_extras("mid-size", flat, b, gx, MID["width"], MID["height"],
                       2000)
        # K3/K4 over 8 random tiles, K5/K6 on ~2,000 draws, K1/K2
        # tiles_per_view over three views concatenated (E=16)
        sel = torch.as_tensor(np.sort(np.random.default_rng(3).choice(
            b.tile_start.numel(), 8, replace=False)).astype(np.int32),
            device=dev)
        compare_selected("mid-size", flat, b, gx, sel)
        compare_sparse("mid-size", flat, b, gx, MID["width"], MID["height"],
                       2000)
        views = [frame_inputs(p_mid, make_cam(v, MID["width"], MID["height"]),
                              MID["width"], MID["height"], True)[:2]
                 for v in range(3)]
        fm, bm, T = merge_binnings(views)
        compare_selected("mid-size", fm, bm, gx, ("views", T, views))
        del flat, b, views, fm, bm
        # the padded layout, clip_rect, K3/K4 full/viewer, E = 4 and 8
        mid_size_layouts_and_widths(p_mid, make_cam, dev)
        del p_mid

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
        phase_s["kernels vs plain, goldens"] = time.perf_counter() - t_phase

        # ---- 3. the serving path at full width
        t_phase = time.perf_counter()
        tmp = tempfile.mkdtemp(prefix="chip_smoke_")
        try:
            serve = main_path(p_full, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del p_full
        phase_s["serving"] = time.perf_counter() - t_phase

        # ---- 4. the training frame's kernels
        t_phase = time.perf_counter()
        p_train = train_scene(st, dev)
        k1_train, k2_train = train_frame_kernels(p_train, make_cam)
        phase_s["training frame kernels"] = time.perf_counter() - t_phase

    # ---- 5. the training path at full width
    t_phase = time.perf_counter()
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
    phase_s["training (steps and CLI)"] = time.perf_counter() - t_phase
    print(f"[train] launches on the training path: train steps "
          f"{step_counts}; with the CLI {train_counts}", flush=True)
    check(train_counts["K1 no_dist"] > 0 and train_counts["K1 full"] > 0,
          "the training path did not launch K1 in both its modes")
    check(train_counts["K2 no_dist"] > 0 and train_counts["K2 full"] > 0,
          "the training path did not launch K2 in both its modes")
    check(train_counts["segment_sum"] > 0,
          "the training path never launched the segment sum")

    # ---- 6. the semantic frame's kernels at full width
    t_phase = time.perf_counter()
    with torch.no_grad():
        sem_k = semantic_frame_kernels(from_numpy(st, dev), make_cam)
    phase_s["semantic frame kernels"] = time.perf_counter() - t_phase

    # ---- 7. the semantic path at full width: steps, then the CLI (each
    # with its own launch counts)
    t_phase = time.perf_counter()
    sem = semantic_phase(st, make_cam, dev)
    n_steps = 2 * SEM["warm"] + SEM["steps"] + SEM["mv_steps"]
    print(f"[semantic] launches in the {n_steps} semantic_train_step calls: "
          f"{sem['counts']}", flush=True)
    for k in ("K1 extras_only", "K2 extras_only", "segment_sum"):
        check(sem["counts"][k] > 0, f"the semantic steps never launched {k}")
    phase_s["semantic steps"] = time.perf_counter() - t_phase
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        sem_cli = semantic_cli_phase(st, make_cam, tmp)
        cli_tiles = semantic_cli_variant(
            sem_cli["root"], os.path.join(tmp, "out_tiles_sparse"),
            "tile subsample + sparse",
            ["--mv_tile_subsample", str(SEM["mv_k"]), "--sparse_px", "1",
             "--sample_batchsize", str(SEM_CLI_SPARSE_BATCH)],
            ("K3 extras_only", "K4 extras_only", "K5", "K6"))
        # the same flags at the reference batch, where the tracker masks'
        # covered tiles overflow their slots and steps take the dense path
        cli_ref = semantic_cli_variant(
            sem_cli["root"], os.path.join(tmp, "out_tiles_sparse_ref"),
            "tile subsample + sparse, reference batch",
            ["--mv_tile_subsample", str(SEM["mv_k"]), "--sparse_px", "1"],
            ("K3 extras_only", "K4 extras_only"))
        cr, ct = cli_ref["counts"], cli_tiles["counts"]
        print(f"[semantic-cli] K5/K6 launches with --sparse_px over "
              f"{SEM_CLI_ITERS} iterations: at {SEM_CLI_SPARSE_BATCH} draws "
              f"per set (a reduced batch) K5 {ct['K5']}, K6 {ct['K6']}, "
              f"dense fallbacks {ct['sparse_fallback']}; at the reference's "
              f"{SEM['batch']} K5 {cr['K5']}, K6 {cr['K6']}, dense "
              f"fallbacks {cr['sparse_fallback']}", flush=True)
        cli_merged = semantic_cli_variant(
            sem_cli["root"], os.path.join(tmp, "out_merged"), "merged",
            ["--mv_merged", "1"], ("K1 tiles_per_view", "K2 tiles_per_view"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    sem_counts = sem_cli["counts"]
    phase_s["semantic CLI (4 runs)"] = time.perf_counter() - t_phase

    # ---- 8. the padded and cached-superset paths at full width
    t_phase = time.perf_counter()
    pad = padded_superset_phase(st, make_cam, dev)
    phase_s["padded and cached superset"] = time.perf_counter() - t_phase
    print("[phases] seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()), flush=True)

    # ---- 9. the card again (the start of a long log may be cut), the
    # kernels' line and the result
    print(smi_line, flush=True)
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
         "bound_by": sg["bound_by"], "library_ms": sg["library_ms"],
         "longest_run": k2_train["no_dist"]["longest_run"]}]
    sframe = (f"{SEM['width']}x{SEM['height']}, {len(st['xyz'])} gaussians, "
              f"E=16")
    x0, xp = sem_k["done0"], sem_k["plain"]
    kernels.append(dict(
        k1_entry("extras_only", x0, f"done0 of {SEM['batch']} pixels, "
                 f"{sframe}", sem_counts["K1 extras_only"]),
        ms_no_done0=xp["ms"], plain_ms_no_done0=xp["plain_ms"],
        bound_ms_no_done0=xp["bound_ms"], bound_by_no_done0=xp["bound_by"],
        max_abs_err=max(x0["max_abs_err"], xp["max_abs_err"])))
    kernels.append(k1_entry("track", sem_k["track"], sframe,
                            sem_counts["K1 track"]))
    k2x = sem_k["k2"]["done0"]
    kernels.append({
        "name": "blend_bwd", "route": "cuda",
        "source": "instascene_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "instascene_tpu/ops/blend_visits.py:395",
        "mode": f"extras_only, on the done0 forward, {sframe}",
        "launches": sem_counts["K2 extras_only"],
        "max_abs_err": max(k2x["max_abs_err"],
                           sem_k["k2"]["plain"]["max_abs_err"]),
        "ms": k2x["ms"], "plain_ms": k2x["plain_ms"],
        "bound_ms": k2x["bound_ms"], "bound_by": k2x["bound_by"],
        "library_ms": None})
    sg16 = k2x["segment_sum"]
    kernels.append({
        "name": "segment_sum", "route": "cuda",
        "source": "instascene_tpu_torch/csrc/blend_bwd.cu",
        "replaces": "instascene_tpu/ops/blend_visits.py:729",
        "mode": f"d_flat of K2 extras_only (D=16), {sframe}",
        "launches": sem_counts["segment_sum"],
        "max_abs_err": sg16["max_abs_err"], "ms": sg16["ms"],
        "plain_ms": sg16["plain_ms"], "bound_ms": sg16["bound_ms"],
        "bound_by": sg16["bound_by"], "library_ms": sg16["library_ms"],
        "longest_run": k2x["longest_run"]})
    cm = cli_merged["counts"]

    def entry(name, source, replaces, mode, launches, r, **more):
        return {"name": name, "route": "cuda",
                "source": f"instascene_tpu_torch/csrc/{source}",
                "replaces": replaces, "mode": mode, "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": None, **more}

    def ref_batch(k):
        # K5/K6's launches come from the CLI at a reduced batch; these are
        # the run at the reference batch
        return {"launches_batch": SEM_CLI_SPARSE_BATCH,
                "launches_at_reference_batch": cr[k],
                "dense_fallbacks_at_reference_batch": cr["sparse_fallback"]}

    tiles = (f"extras_only over bench.py's {SEM['mv_k']} tiles of view 1, "
             f"{sframe}")
    window = f"extras_only, the {SEM['n_mv']}-view window merged, {sframe}"
    draws = f"{SEM['batch']} draws, S={sem_k['sparse']['S']}, {sframe}"
    kernels += [
        entry("blend_fwd (K3: tile list)", "blend_fwd.cu",
              "instascene_tpu/ops/blend_pallas.py:546", tiles,
              ct["K3 extras_only"], sem_k["k3"]),
        entry("blend_bwd (K4: tile list)", "blend_bwd.cu",
              "instascene_tpu/ops/blend_pallas.py:785", tiles,
              ct["K4 extras_only"], sem_k["k3"]["k2"]),
        entry("sparse_fwd (K5)", "blend_sparse.cu",
              "instascene_tpu/ops/blend_sparse.py:146", draws, ct["K5"],
              sem_k["sparse"]["k5"], **ref_batch("K5")),
        entry("sparse_bwd (K6)", "blend_sparse.cu",
              "instascene_tpu/ops/blend_sparse.py:251", draws, ct["K6"],
              sem_k["sparse"]["k6"], **ref_batch("K6")),
        entry("blend_fwd", "blend_fwd.cu",
              "instascene_tpu/ops/blend_visits.py:62",
              f"tiles_per_view ({window})", cm["K1 tiles_per_view"],
              sem_k["merged"]),
        entry("blend_bwd", "blend_bwd.cu",
              "instascene_tpu/ops/blend_visits.py:395",
              f"tiles_per_view ({window})", cm["K2 tiles_per_view"],
              sem_k["merged"]["k2"])]
    # K7/K8 and the clip_rect and tile-list modes of K1-K4, launches on
    # phase 8's path; E=8 times beside E=16 where both ran
    pl = pad["launches"]
    k7, k8 = pad["k7"], pad["k8"]
    sframe0 = f"{SEM['width']}x{SEM['height']}, camera 0"
    kernels += [
        entry("blend_fwd_padded (K7)", "blend_padded.cu",
              "instascene_tpu/ops/blend_pallas.py:185",
              f"full over the padded layout, {where_1080}, camera 0, K="
              f"{k7['K']}", pl["K7"], k7, k1_full_ms=k7["k1_ms"],
              ms_E8=k7["ms_E8"], k1_full_ms_E8=k7["k1_ms_E8"],
              bound_ms_E8=k7["bound_ms_E8"],
              packed_bytes=k7["packed_bytes"]),
        entry("blend_bwd_padded (K8)", "blend_padded.cu",
              "instascene_tpu/ops/blend_pallas.py:333",
              f"full over the padded layout, {sframe0}, E=0, K="
              f"{k8['E=0']['K']}", pl["K8"], k8["E=0"],
              k2_full_ms=k8["E=0"]["k2_ms"],
              **{f"{f}_E16": k8["E=16"][k]
                 for f, k in (("ms", "ms"), ("k2_full_ms", "k2_ms"),
                              ("bound_ms", "bound_ms"),
                              ("plain_ms", "plain_ms"))},
              gather_backward_ms=pad["gather_backward"]["ms"],
              gather_backward_deterministic=pad["gather_backward"][
                  "deterministic"])]
    for mode in ("full", "extras_only"):
        r = pad["clip"][mode]
        where = (f"{mode} clip_rect, {sframe0}, a binning dilated by one "
                 f"tile ({pad['clip']['pairs']} pairs, fresh "
                 f"{pad['clip']['fresh_pairs']})")
        kernels += [
            entry("blend_fwd", "blend_fwd.cu",
                  "instascene_tpu/ops/blend_visits.py:62", where,
                  pl[f"K1 {mode} clip_rect"], r, fresh_binning_ms=r[
                      "fresh_ms"]),
            entry("blend_bwd", "blend_bwd.cu",
                  "instascene_tpu/ops/blend_visits.py:395", where,
                  pl[f"K2 {mode} clip_rect"], r["k2"])]
    t1 = f"over bench.py's {SEM['mv_k']} tiles of view 1, {sframe}"
    kernels += [
        entry("blend_fwd (K3: tile list)", "blend_fwd.cu",
              "instascene_tpu/ops/blend_pallas.py:546", f"full {t1}",
              pl["K3 full"], pad["tiles"]["full"]),
        entry("blend_fwd (K3: tile list)", "blend_fwd.cu",
              "instascene_tpu/ops/blend_pallas.py:546", f"viewer {t1}",
              pl["K3 viewer"], pad["tiles"]["viewer"]),
        entry("blend_bwd (K4: tile list)", "blend_bwd.cu",
              "instascene_tpu/ops/blend_pallas.py:785", f"full {t1}",
              pl["K4 full"], pad["tiles"]["k4"])]
    kernels[1]["ms_E8"] = k7["k1_ms_E8"]
    variants = {k: {"window_step_median_ms": sem[k]["mv"]["median_ms"],
                    "plain_step_median_ms": (sem[k]["plain"]["median_ms"]
                                             if "plain" in sem[k] else None),
                    "sustained_its": sem[k]["sustained_its"]}
                for k in ("tiles", "merged", "sparse")}
    print(json.dumps({"kernels": kernels, "train_step_median_ms": {
        k: v["median_ms"] for k, v in steps.items()},
        "semantic_step_median_ms": {k: sem[k]["median_ms"]
                                    for k in ("plain", "mv")},
        "semantic_sustained_its": sem["sustained_its"],
        "semantic_variants": variants,
        "jax_capped_chunks": sem_k["jax_capped_chunks"],
        "conic_cull_1080p": pad["conic"],
        "tracker_s_per_view": sem["tracker_s"],
        "semantic_cli_s": {k: sem_cli[k] for k in (
            "tracker renders", "spatial track", "training",
            "hdbscan export")},
        "semantic_cli_variant_s": {
            tag: {k: r[k] for k in ("training", "hdbscan export")}
            for tag, r in (("tiles+sparse", cli_tiles),
                           ("tiles+sparse, reference batch", cli_ref),
                           ("merged", cli_merged))}}), flush=True)
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
