"""The system's own numbers on the GPU, as one JSON line:

    python -m instascene_tpu_torch.bench [--n 300000] [--iters 20]
        [--warmup 12] [--seed 0] [--scale 1] [--device cpu]

Port of the root bench.py:118-609. The same paths on the same inputs, each
rebuilt on the port's modules:
  * the semantic step (bench.py:207-329, pipelines/train_semantic.
    semantic_train_step) at 976x728 on six orbit cameras with cached
    binning: the plain step (K1/K2 extras_only with the sampled-pixel done0
    mask, the segment sum), the step with the 5-view window in full (K1/K2
    extras_only per view) and tile-subsampled (K3/K4 over 128 tiles per
    view); sustained it/s = 1 / (0.9·t_plain + 0.1·t_window);
  * the geometry step (bench.py:332-403, pipelines/train.train_step) at
    976x728 on four orbit cameras: the reference defaults (K1/K2 no_dist)
    and the 2DGS bounded recipe (λ_dist 100, depth_ratio 0; K1/K2 full);
  * frames (bench.py:406-475, ops/rasterize.rasterize) with fresh binning,
    SH 3, camera 0: 1080p `full`, 1080p `viewer` with the 16 normalised
    feature channels, and 3840x2160 `full` in one launch (the JAX
    package's tile slabs are TPU scheduling and are not ported);
  * the tracker view (bench.py:478-511): rasterize with contributor
    tracking (K1 track), E=16, at 976x728, in seconds per view;
  * the `trained` profile's 1080p frames and geometry step (bench.py:
    575-593).
The headline and the keys under "extra" are bench.py's, with its meanings.
Beside them the line carries the device (the card's name, count and
power limit from nvidia-smi, or "cpu"), each path's samples, median and
min/max per-iteration ms, window wall and kernel launches (ops/
cuda_build.LAUNCHES over the timed window), the pair counts per frame,
and the peak device memory.

Timing: each path runs --warmup untimed iterations, then its timed window,
each iteration between two CUDA events (on the CPU the host clock around
each iteration, whose ops are synchronous); the window's host wall ends in
a synchronize. A rate is 1000 over the median ms. --iters is bench.py's
BENCH_ITERS: the plain semantic step's samples; the windowed variants take
max(5, iters // 3), and the other paths bench.py's own counts (geometry 10,
1080p 20, 4K 8, tracker 5). What bench.py does for the TPU is not ported:
RTT differencing, pair-cap probing and slow-roll re-rolls (bench.py:31-115
and the caps in each function); the port's binning is exact. Nor is its
catch-all around each path: a path that raises ends the run with no line.

Runs on the GPU unless --device cpu (the kernels' plain versions: a smoke
of the flow whose numbers are the CPU's, not the card's). --scale divides
every width and height, for a run at small size.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch

from . import resolve_device

# the reference's rate: 10,000 semantic iterations in ~20 min on an A100
# 40GB (BASELINE.md)
BASELINE_SEMANTIC_ITS = 10_000 / (20 * 60)
# bench.py:207-294's semantic inputs: six orbit cameras, a 40-label random
# segmap and 3D labels (default_rng(1), in that order), the window of views
# 1-5 and its tile subsets (default_rng(7), mv_k sorted tiles per view)
SEM = dict(width=976, height=728, cams=6, labels=40, batch=32 * 1024,
           max_labels=64, n_mv=5, mv_k=128, lam_sv=1e-6, lam_mv=1e-6,
           lam_3d=2.5e-6)
# bench.py:332-403: four orbit cameras, a random target (default_rng(2)),
# λ (dssim, normal) beside λ_dist 0 or 100
GEOM = dict(width=976, height=728, cams=4, lambda_dssim=0.2,
            lambda_normal=0.05, lambda_normal_prior=0.0, xyz_lr=1e-4)
FRAME_1080P = (1920, 1080)
FRAME_4K = (3840, 2160)
TRACKER = (976, 728)
# bench.py's samples of the paths --iters does not set
SAMPLES = dict(geometry=10, render=20, render_4k=8, tracker=5)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_path(step, samples: int, warmup: int, dev: torch.device) -> dict:
    """step() `warmup` times untimed, then `samples` times, each between two
    CUDA events (on the CPU: the host clock around each call). Returns the
    per-iteration ms (median, min, max), the window's host wall (ending in
    a synchronize) and the warm-up's, the kernel launches of the timed
    window by kernel and mode, the peak device memory over warm-up and
    window, and step()'s last result."""
    from .cuda_build import LAUNCHES
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    for _ in range(warmup):
        step()
    _sync(dev)
    warm_s = time.perf_counter() - t0
    LAUNCHES.clear()
    t0 = time.perf_counter()
    if dev.type == "cuda":
        ev = [torch.cuda.Event(enable_timing=True)
              for _ in range(samples + 1)]
        ev[0].record()
        for i in range(samples):
            last = step()
            ev[i + 1].record()
        torch.cuda.synchronize(dev)
        ms = [a.elapsed_time(b) for a, b in zip(ev, ev[1:])]
    else:
        ms = []
        for _ in range(samples):
            t = time.perf_counter()
            last = step()
            ms.append((time.perf_counter() - t) * 1e3)
    wall_s = time.perf_counter() - t0
    return {"samples": samples, "median_ms": float(np.median(ms)),
            "min_ms": float(min(ms)), "max_ms": float(max(ms)),
            "window_wall_s": wall_s, "warmup_wall_s": warm_s,
            "launches": {k: v for k, v in LAUNCHES.items() if v},
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else None),
            "last": last}


def _finite(name: str, x: torch.Tensor) -> None:
    if not bool(torch.isfinite(x).all()):
        raise RuntimeError(f"bench path {name}: non-finite output")


def scaled(width: int, height: int, scale: int):
    return max(1, width // scale), max(1, height // scale)


def bench_tiles(width: int, height: int, dev) -> torch.Tensor:
    """bench.py:258-263's tile subsets: min(mv_k, tiles) sorted unique tiles
    for each window view from numpy's default_rng(7), int32 [n_mv, K]."""
    nt = ((width + 15) // 16) * ((height + 15) // 16)
    rng = np.random.default_rng(7)
    return torch.as_tensor(np.stack([np.sort(rng.choice(
        nt, min(SEM["mv_k"], nt), replace=False)).astype(np.int32)
        for _ in range(SEM["n_mv"])]), device=dev)


def semantic_inputs(st, make_cam, dev, scale: int = 1):
    """bench.py's semantic inputs on the port: the scene with its features,
    six orbit cameras with their cached binning, the random 40-label segmap
    as raw and sorted map, random 3D labels. Returns (params, cams, hyp,
    scfg, pairs per view)."""
    from .config import OptimizationParams
    from .models.gaussians import from_numpy
    from .models.optimizer import semantic_lrs
    from .ops.rasterize import RasterizeConfig, compute_binning_cache
    from .pipelines import train_semantic as ts
    from .pipelines.train import camera_tensors
    from .semantic.contrastive import valid_ids_pack
    W, H = scaled(SEM["width"], SEM["height"], scale)
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
        lrs=semantic_lrs(OptimizationParams()), lam_sv=SEM["lam_sv"],
        lam_mv=SEM["lam_mv"], lam_3d=SEM["lam_3d"], seg3d_labels=lab3d)
    scfg = ts.SemanticStepConfig(
        raster=RasterizeConfig(W, H, bwd_extras_only=True),
        batch=SEM["batch"], max_labels=SEM["max_labels"])
    return p, cams, hyp, scfg, [c.binning.total_pairs for c in cams]


def semantic_windows(cams, scale: int, dev) -> dict:
    """bench.py's three semantic variants: no window (the plain step), the
    5-view window (views 1-5) in full, and tile-subsampled."""
    from .pipelines.train_semantic import SemanticMVBlock
    window = cams[1:1 + SEM["n_mv"]]
    W, H = scaled(SEM["width"], SEM["height"], scale)
    return {"semantic_plain": None,
            "semantic_mv": SemanticMVBlock(window),
            "semantic_mv_sub": SemanticMVBlock(window,
                                               bench_tiles(W, H, dev))}


def bench_semantic(st, make_cam, dev, args, paths: dict, pairs: dict):
    """bench.py:207-329: each variant from the same state and a generator
    seeded with --seed, camera i mod 6 at step i. Returns (plain it/s,
    sustained it/s with the full window, with the tile-subsampled one)."""
    from .models.optimizer import init_adam_state
    from .pipelines.train_semantic import semantic_train_step
    p0, cams, hyp, scfg, view_pairs = semantic_inputs(st, make_cam, dev,
                                                      args.scale)
    pairs["semantic_views"] = view_pairs
    opt0 = init_adam_state(p0)
    for name, mv in semantic_windows(cams, args.scale, dev).items():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        state = [p0, opt0, 0]

        def step():
            p, s, loss = semantic_train_step(state[0], state[1],
                                             cams[state[2] % len(cams)], mv,
                                             hyp, scfg, generator=gen)
            state[:] = [p, s, state[2] + 1]
            return loss
        n = args.iters if mv is None else max(5, args.iters // 3)
        paths[name] = time_path(step, n, args.warmup, dev)
        _finite(name, paths[name]["last"])
        _finite(name, state[0].seg_feature)
        _progress(name, paths[name])
    t = {k: paths[k]["median_ms"] * 1e-3 for k in
         ("semantic_plain", "semantic_mv", "semantic_mv_sub")}
    sustained = lambda tw: 1.0 / (0.9 * t["semantic_plain"] + 0.1 * tw)
    return (1.0 / t["semantic_plain"], sustained(t["semantic_mv"]),
            sustained(t["semantic_mv_sub"]))


def geometry_inputs(st, make_cam, dev, scale: int, dist: bool):
    """bench.py:332-403's geometry inputs: the scene without features, four
    orbit cameras sharing the random target of default_rng(2), fresh Adam
    state and densification stats, geometry_lrs(opt, 1.0, 1e-4), and the
    recipe's config and λ: the reference defaults (no_dist) or the 2DGS
    bounded recipe (dist). Returns (params, opt_state, stats, cams, lrs,
    kwargs of train_step)."""
    from .config import OptimizationParams
    from .models.densify import init_stats
    from .models.gaussians import from_numpy
    from .models.optimizer import geometry_lrs, init_adam_state
    from .ops.rasterize import RasterizeConfig
    from .pipelines.train import camera_tensors
    W, H = scaled(GEOM["width"], GEOM["height"], scale)
    p = from_numpy({**st, "seg_feature": None}, dev)
    cams = [camera_tensors(make_cam(i, W, H), dev)
            for i in range(GEOM["cams"])]
    gt = torch.as_tensor(np.random.default_rng(2).random(
        (H, W, 3)).astype(np.float32), device=dev)
    for ct in cams:
        ct.gt_image = gt
    lrs = geometry_lrs(OptimizationParams(), 1.0, GEOM["xyz_lr"])
    kw = dict(lambda_dssim=GEOM["lambda_dssim"],
              lambda_dist=100.0 if dist else 0.0,
              lambda_normal=GEOM["lambda_normal"],
              lambda_normal_prior=GEOM["lambda_normal_prior"],
              cfg=RasterizeConfig(W, H, no_depth_dist=not dist),
              depth_ratio=0.0 if dist else 1.0)
    return (p, init_adam_state(p), init_stats(p.capacity, dev), cams, lrs,
            kw)


def bench_geometry(st, make_cam, dev, args, paths: dict, pairs: dict,
                   name: str, dist: bool = False) -> float:
    """bench.py:332-403: chained train_step calls, camera i mod 4 at step i.
    Returns it/s."""
    from .pipelines.train import train_step
    p, opt, stats, cams, lrs, kw = geometry_inputs(st, make_cam, dev,
                                                   args.scale, dist)
    bg = torch.zeros(3, device=dev)
    state = [p, opt, stats, 0]
    step_pairs = []

    def step():
        i = state[3]
        p, o, s, m = train_step(state[0], state[1], state[2],
                                cams[i % len(cams)], bg, lrs, **kw)
        state[:] = [p, o, s, i + 1]
        step_pairs.append(m["total_pairs"])
        return m["loss"]
    paths[name] = time_path(step, SAMPLES["geometry"], args.warmup, dev)
    _finite(name, paths[name]["last"])
    pairs[name] = step_pairs[-GEOM["cams"]:]
    _progress(name, paths[name])
    return 1e3 / paths[name]["median_ms"]


def frame_setup(st, make_cam, dev, size, mode: str, scale: int = 1):
    """A bench frame's inputs (bench.py:406-511): the model, camera 0's
    matrices at `size` (divided by scale), the config of `mode` ("full",
    "viewer": colour, alpha and features, or "track": full plus the
    contributor buffer) and the features it splats (the 16 normalised
    channels in viewer and track, none in full)."""
    from .models.gaussians import from_numpy
    from .ops.rasterize import RasterizeConfig
    from .pipelines.train import camera_tensors
    W, H = scaled(*size, scale)
    p = from_numpy(st, dev)
    cfg = RasterizeConfig(W, H, fwd_viewer=mode == "viewer",
                          track_contrib=mode == "track")
    return (p, camera_tensors(make_cam(0, W, H), dev).mats, cfg,
            p.seg_feature_normed() if mode != "full" else None)


def frame(p, cam, cfg, extras=None):
    """One bench.py frame: rasterize with fresh binning, SH 3, black
    background."""
    from .ops.rasterize import rasterize
    return rasterize(*p.raster_inputs(), cam,
                     torch.zeros(3, device=p.device), cfg, shs=p.features(),
                     sh_degree=3, extras=extras)


def bench_frames(st, make_cam, dev, args, paths: dict, pairs: dict,
                 name: str, size, mode: str, samples: int) -> float:
    """bench.py:406-511: frames binned afresh, forward only — the `full`
    frame, the GUI's (viewer) or the priors stage's tracker view (track).
    Returns the median ms."""
    p, cam, cfg, extras = frame_setup(st, make_cam, dev, size, mode,
                                      args.scale)

    def step():
        out = frame(p, cam, cfg, extras)
        pairs[name] = out.total_pairs
        return out.blend.color
    with torch.no_grad():
        paths[name] = time_path(step, samples, args.warmup, dev)
    _finite(name, paths[name]["last"])
    _progress(name, paths[name])
    return paths[name]["median_ms"]


def _progress(name: str, r: dict) -> None:
    print(f"[bench] {name}: median {r['median_ms']:.4f} ms over "
          f"{r['samples']} (min {r['min_ms']:.4f}, max {r['max_ms']:.4f}); "
          f"launches {r['launches']}", file=sys.stderr, flush=True)


def _device(dev: torch.device):
    """The card's name and count and its nvidia-smi name and power limit,
    or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    info = {"name": torch.cuda.get_device_name(idx),
            "count": torch.cuda.device_count(), "power_limit": "not measured"}
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    if idx < len(lines):
        info["nvidia_smi"] = lines[idx]
        info["power_limit"] = lines[idx].rsplit(",", 1)[-1].strip()
    return info


def parser() -> ArgumentParser:
    ap = ArgumentParser(description="The port's bench: one JSON line")
    ap.add_argument("--n", type=int, default=300_000,
                    help="gaussians (bench.py's BENCH_N)")
    ap.add_argument("--iters", type=int, default=20,
                    help="plain semantic steps timed (BENCH_ITERS)")
    ap.add_argument("--warmup", type=int, default=12,
                    help="untimed iterations before each path's window "
                         "(BENCH_WARMUP)")
    ap.add_argument("--seed", type=int, default=0,
                    help="the scenes' seed and the pixel draws'")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide every width and height (small runs)")
    ap.add_argument("--device", type=str, default=None,
                    help="torch device (default: cuda; cpu runs the plain "
                         "versions, whose numbers are not the card's)")
    return ap


def main(argv=None) -> dict:
    """Run every path, print the JSON line and return it as a dict."""
    ap = parser()
    args = ap.parse_args(argv if argv is not None else sys.argv[1:])
    if min(args.n, args.iters, args.scale) < 1 or args.warmup < 0:
        ap.error("--n, --iters and --scale take values >= 1, --warmup >= 0")
    if args.device is None and not torch.cuda.is_available():
        raise RuntimeError(
            f"the bench runs on a CUDA device and {torch.cuda.device_count()}"
            f" are visible; pass --device cpu for the plain PyTorch path "
            f"(its numbers are not the card's)")
    dev = resolve_device(args.device)
    from .data.synthetic import make_bench_scene
    build_s = None
    if dev.type == "cuda":
        from . import cuda_build
        build_s = cuda_build.build_all()
    paths, pairs, extra = {}, {}, {}

    st, make_cam = make_bench_scene(n=args.n, seed=args.seed)
    plain_its, sem_its, sem_sub_its = bench_semantic(st, make_cam, dev, args,
                                                     paths, pairs)
    extra["semantic_plain_steps_its"] = plain_its
    extra["semantic_with_mv_subsampled_its"] = sem_sub_its
    extra["geometry_train_its"] = bench_geometry(
        st, make_cam, dev, args, paths, pairs, "geometry")
    extra["geometry_train_dist_its"] = bench_geometry(
        st, make_cam, dev, args, paths, pairs, "geometry_dist", dist=True)
    fps = lambda *a: 1e3 / bench_frames(*a)
    extra["render_1080p_fps"] = fps(st, make_cam, dev, args, paths, pairs,
                                    "render_1080p", FRAME_1080P, "full",
                                    SAMPLES["render"])
    extra["gui_feature_render_1080p_fps"] = fps(
        st, make_cam, dev, args, paths, pairs, "gui_1080p", FRAME_1080P,
        "viewer", SAMPLES["render"])
    extra["render_4k_fps"] = fps(st, make_cam, dev, args, paths, pairs,
                                 "render_4k", FRAME_4K, "full",
                                 SAMPLES["render_4k"])
    extra["tracker_view_s"] = 1e-3 * bench_frames(
        st, make_cam, dev, args, paths, pairs, "tracker", TRACKER, "track",
        SAMPLES["tracker"])
    del st
    tp, tp_cam = make_bench_scene(n=args.n, seed=args.seed,
                                  profile="trained")
    extra["trained_render_1080p_fps"] = fps(
        tp, tp_cam, dev, args, paths, pairs, "trained_render_1080p",
        FRAME_1080P, "full", SAMPLES["render"])
    extra["trained_gui_render_1080p_fps"] = fps(
        tp, tp_cam, dev, args, paths, pairs, "trained_gui_1080p",
        FRAME_1080P, "viewer", SAMPLES["render"])
    extra["trained_geometry_train_its"] = bench_geometry(
        tp, tp_cam, dev, args, paths, pairs, "trained_geometry")

    W, H = scaled(SEM["width"], SEM["height"], args.scale)
    for r in paths.values():
        del r["last"]
    peaks = [r["peak_memory_bytes"] for r in paths.values()]
    line = {
        "metric": f"semantic train iters/sec sustained incl. multi-view "
                  f"(waldo-scale synthetic, {args.n} gaussians, {W}x{H}, "
                  f"16ch)",
        "value": sem_its, "unit": "it/s",
        "vs_baseline": sem_its / BASELINE_SEMANTIC_ITS,
        "extra": extra, "device": _device(dev), "paths": paths,
        "pairs": pairs,
        "peak_memory_bytes": max(peaks) if dev.type == "cuda" else None,
        "build_s": build_s,
        "config": {k: getattr(args, k) for k in ("n", "iters", "warmup",
                                                 "seed", "scale")}}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
