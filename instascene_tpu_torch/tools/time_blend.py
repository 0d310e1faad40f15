"""Time the blend kernels in each of their modes on the benchmark frames,
with a digest of each output, for the package of one source tree: an A/B
of two trees on one card.

    python3 time_blend.py --root <tree>   # e.g. a checkout of the parent

--root names the directory that holds `instascene_tpu_torch/` (the
kernels are built from its csrc/). It uses only entry points every
version since the padded-layout slice has (blend_fwd and blend_bwd with
their mode flags, reduce_per_gaussian, blend_sparse_fwd/_bwd,
blend_fwd_padded, the binning helpers), on the 300k-gaussian `trained`
scene:
  * 1920x1080 camera 0, E=16: K1 full, viewer; K7 (padded layout);
  * 976x728 camera 0, E=0: K1 no_dist, K7, K2 full, no_dist; E=16: K1
    extras_only without and with a 32k-pixel done0, track, K7, K2 full,
    no_dist, extras_only; E=8 (the run-time width): K1 full, K2 full,
    no_dist, extras_only. After each K2 mode the segment sum runs on its
    d_sorted (D = 21, 37, 16, 29, 8), and index_add_ on the same rows is
    timed beside it (a yardstick; the port never calls it);
  * the semantic frame's other kernels at 976x728, E=16: K3 (K1 over
    bench.py's 128 tiles of view 1) in extras_only, full and viewer, K1
    tiles_per_view over the 5-view window (views 1-5), K1 clip_rect full
    and extras_only over camera 0's binning dilated by one tile, K5 and
    K6 on 32k draws (S from pick_sparse_s), at E=16 and at E=8 (the
    run-time width), and K5 and K6 at the sparse semantic CLI run's
    reduced batch: its two single-view sets of 256 draws (512 pixels, S
    from pick_sparse_s).
Each time is the CUDA-event span of 20 back-to-back launches over 20,
after a warm-up, so the host's enqueue overlaps the kernels. Each output
gets the first 16 hex digits of the sha256 of its bytes: equal digests in
two trees are the same bits. Beside them: the longest range each
selection walks (`walked`: its largest tile, in pairs) and the time of a
stable argsort of its range lengths (`argsort_ms`, the cost of walking
the tiles longest first), with the same span. Prints the card and one
JSON line {"root": ..., "ms": {...}, "sha256": {...}, "runs": {...},
"walked": {...}, "argsort_ms": {...}}. Run two trees in turns in one call
(A, B, B, A) and compare within it.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

import numpy as np

REPS = 20
N_GAUSS = 300_000
DEVICE = "cuda"            # a CPU rehearsal of the flow sets "cpu"
# (width, height, E, K1 modes timed, K2 modes timed with the segment sum)
FRAMES = ((1920, 1080, 16, ("full", "viewer"), ()),
          (976, 728, 0, ("no_dist",), ("full", "no_dist")),
          (976, 728, 16, ("extras_only",), ("full", "no_dist",
                                            "extras_only")),
          (976, 728, 8, ("full",), ("full", "no_dist", "extras_only")))
SEM_W, SEM_H, SEM_E = 976, 728, 16
DRAWS = 32 * 1024          # the semantic step's batch of sampled pixels
CLI_DRAWS = 2 * 256        # chip_smoke.py's sparse CLI run: 2 sets of 256
N_MV, MV_K = 5, 128        # bench.py's window: views, tiles per view


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if DEVICE == "cuda" and not torch.cuda.is_available():
        print("time_blend: no CUDA device", file=sys.stderr)
        return 1
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops import blend_padded as bp
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import (bin_gaussians,
                                                  merge_binnings,
                                                  padded_layout)
    from instascene_tpu_torch.ops.preprocess import preprocess_gaussians
    from instascene_tpu_torch.render import camera_mats

    def span(fn):
        fn()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(REPS):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / REPS

    dev = torch.device(DEVICE)
    st, make_cam = make_bench_scene(n=N_GAUSS, seed=0, profile="trained")
    p = from_numpy(st, dev)
    g = p.raster_inputs()
    ms, sha, runs, walked, argsort_ms = {}, {}, {}, {}, {}

    def frame(cam, W, H, E, rects=False):
        """(flat, binning, grid_x) of camera `cam`; rects: flat with the
        fresh rects and the binning dilated by one tile (clip_rect)."""
        cm = camera_mats(make_cam(cam, W, H), dev)
        pre = preprocess_gaussians(
            g.xyz, g.scales, g.rotations, cm.w2v, cm.full_proj, cm.campos,
            W, H, g.opacities, shs=p.features(), sh_degree=3, alive=p.alive)
        extras = p.seg_feature_normed()[:, :E].contiguous() if E else None
        if not rects:
            return (bv.pack_flat_cols(pre.T, pre.xy, pre.normal_view,
                                      g.opacities, pre.color, extras),
                    bin_gaussians(pre, W, H), (W + 15) // 16)
        rmax = torch.where((pre.tiles_touched > 0)[:, None], pre.rect_max,
                           pre.rect_min)
        return (bv.pack_flat_cols(pre.T, pre.xy, pre.normal_view,
                                  g.opacities, pre.color, extras,
                                  rect=(pre.rect_min, rmax)),
                bin_gaussians(pre, W, H, dilate_tiles=1), (W + 15) // 16)

    def lengths_of(key, lengths):
        """The longest range a selection walks, and the stable argsort of
        its range lengths that orders the walk longest first."""
        walked[key] = int(lengths.max())
        argsort_ms[key] = span(lambda: torch.argsort(
            lengths, descending=True, stable=True))

    def time_k1(key, a, **kw):
        ms[key] = span(lambda: bv.blend_fwd(*a, **kw))
        sha[key] = digest(*bv.blend_fwd(*a, **kw))

    def time_k7(key, flat, b, gx, E):
        idx, count = padded_layout(b)
        packed = bp.pack_inputs(flat, idx)
        ms[key] = span(lambda: bp.blend_fwd_padded(packed, count, gx, E))
        sha[key] = digest(*bp.blend_fwd_padded(packed, count, gx, E))
        lengths_of(key, count)

    with torch.no_grad():
        for W, H, E, fwd, bwd in FRAMES:
            flat, b, gx = frame(0, W, H, E)
            n = flat.shape[0]
            args_ = (flat, b.sorted_gid, b.tile_start, b.tile_end, gx, E)
            fr = f"{W}x{H}"
            runs[fr] = {
                "pairs": int(b.sorted_gid.numel()),
                "longest_run": int((b.run_start[1:] - b.run_start[:-1])
                                   .max()),
                "largest_tile": int((b.tile_end - b.tile_start).max())}
            lengths_of(f"{fr} E={E}", b.tile_end - b.tile_start)
            for mode in fwd:
                time_k1(f"K1 {mode} E={E} {fr}", args_,
                        **({mode: True} if mode != "full" else {}))
            if E != 8:
                time_k7(f"K7 E={E} {fr}", flat, b, gx, E)
            for mode in bwd:
                kw = {mode: True} if mode != "full" else {}
                out, iout = bv.blend_fwd(*args_, **kw)
                saved = torch.stack([out[:, 9], out[:, 10 + E],
                                     out[:, 11 + E]], 1).contiguous()
                gen = torch.Generator(device=dev).manual_seed(5)
                gout = torch.randn(out.shape, generator=gen, device=dev)
                key = f"K2 {mode} E={E} {fr}"
                ms[key] = span(
                    lambda: bv.blend_bwd(*args_, gout, saved, iout, **kw))
                d = bv.blend_bwd(*args_, gout, saved, iout, **kw)
                sha[key] = digest(d)
                D = d.shape[1]
                runs_ = (b.gid_order, b.run_start)
                key = f"segment_sum D={D} (K2 {mode} E={E}) {fr}"
                ms[key] = span(lambda: bv.reduce_per_gaussian(
                    d, b.sorted_gid, n, runs_))
                sha[key] = digest(bv.reduce_per_gaussian(
                    d, b.sorted_gid, n, runs_))
                acc = torch.zeros((n, D), dtype=torch.float32, device=dev)
                gid64 = b.sorted_gid.to(torch.int64)
                ms[f"index_add_ D={D} (K2 {mode} E={E}) {fr}"] = span(
                    lambda: acc.index_add_(0, gid64, d))

        # the semantic frame: done0, track, K5/K6 on camera 0
        W, H, E = SEM_W, SEM_H, SEM_E
        fr = f"{W}x{H}"
        flat, b, gx = frame(0, W, H, E)
        args_ = (flat, b.sorted_gid, b.tile_start, b.tile_end, gx, E)
        nt = b.tile_start.numel()
        gen = torch.Generator(device=dev).manual_seed(11)
        idx = torch.randint(0, W * H, (DRAWS,), generator=gen, device=dev)
        d0 = torch.ones((nt, 1, 256), dtype=torch.int32, device=dev)
        y, x = idx // W, idx % W
        d0[(y // 16) * gx + x // 16, 0, (y % 16) * 16 + x % 16] = 0
        time_k1(f"K1 extras_only done0 E={E} {fr}", args_, extras_only=True,
                done0=d0)
        time_k1(f"K1 track E={E} {fr}", args_, track=True)

        def time_sparse(tag, flat_e, E_, draws):
            """K5 and K6 on `draws` uniform pixels of camera 0."""
            S = bs.pick_sparse_s(draws, nt)
            gen = torch.Generator(device=dev).manual_seed(13)
            idx = torch.randint(0, W * H, (draws,), generator=gen,
                                device=dev)
            spix = bs.spix_from_idx(idx, W, H, 16, S)[0]
            sargs = (flat_e, b.sorted_gid, b.tile_start, b.tile_end, spix,
                     gx, E_)
            key = f"K5 {tag}S={S} E={E_} {fr}"
            ms[key] = span(lambda: bs.blend_sparse_fwd(*sargs))
            feat, aux = bs.blend_sparse_fwd(*sargs)
            sha[key] = digest(feat, aux)
            gout = torch.randn(feat.shape, generator=gen, device=dev)
            key = f"K6 {tag}S={S} E={E_} {fr}"
            ms[key] = span(lambda: bs.blend_sparse_bwd(*sargs, gout, aux))
            sha[key] = digest(bs.blend_sparse_bwd(*sargs, gout, aux))

        time_sparse("", flat, E, DRAWS)
        time_sparse(f"{CLI_DRAWS} draws ", flat, E, CLI_DRAWS)
        time_sparse("", frame(0, W, H, 8)[0], 8, DRAWS)
        del flat, b, d0

        # K3 over bench.py's first tile set on view 1 (bench.py:258-263),
        # K1 tiles_per_view over the window (views 1-5)
        rng = np.random.default_rng(7)
        sels = [torch.as_tensor(np.sort(rng.choice(nt, MV_K, replace=False))
                                .astype(np.int32), device=dev)
                for _ in range(N_MV)]
        views = [frame(v, W, H, E)[:2] for v in range(1, 1 + N_MV)]
        flat, b = views[0]
        args_ = (flat, b.sorted_gid, b.tile_start, b.tile_end, gx, E)
        lengths_of(f"K3 {MV_K} tiles of view 1",
                   (b.tile_end - b.tile_start)[sels[0].long()])
        for mode in ("extras_only", "full", "viewer"):
            time_k1(f"K3 {mode} E={E} {fr} view 1", args_, tile_ids=sels[0],
                    **({mode: True} if mode != "full" else {}))
        fm, bm, T = merge_binnings(views)
        margs = (fm, bm.sorted_gid, bm.tile_start, bm.tile_end, gx, E)
        lengths_of(f"K1 tiles_per_view {N_MV} views",
                   bm.tile_end - bm.tile_start)
        time_k1(f"K1 tiles_per_view E={E} {fr} {N_MV} views", margs,
                extras_only=True, tiles_per_view=T)
        del views, flat, b, fm, bm

        # clip_rect over camera 0's binning dilated by one tile
        flat_r, bd, gx = frame(0, W, H, E, rects=True)
        cargs = (flat_r, bd.sorted_gid, bd.tile_start, bd.tile_end, gx, E)
        lengths_of(f"clip_rect dilated {fr}", bd.tile_end - bd.tile_start)
        for mode in ("full", "extras_only"):
            time_k1(f"K1 {mode} clip_rect E={E} {fr}", cargs, clip_rect=True,
                    **({mode: True} if mode != "full" else {}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"root": args.root, "ms": ms, "sha256": sha,
                      "runs": runs, "walked": walked,
                      "argsort_ms": argsort_ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
