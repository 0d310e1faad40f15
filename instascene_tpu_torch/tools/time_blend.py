"""Time K1 and K2 at the fixed feature widths (E = 0 and 16) in each of
their modes on the benchmark frames, for the package of one source tree:
an A/B of two trees on one card.

    python3 time_blend.py --root <tree>   # e.g. a checkout of the parent

--root names the directory that holds `instascene_tpu_torch/` (the
kernels are built from its csrc/). It uses only the entry points every
version since the geometry slice has (blend_fwd, blend_bwd with their
mode flags), on the 300k-gaussian `trained` scene: 1920x1080 camera 0
(E=16: K1 full, viewer) and 976x728 camera 0 (E=0: K1 no_dist, K2 full,
no_dist; E=16: K1 extras_only, K2 extras_only). Each time is the CUDA-event
span of 20 back-to-back launches over 20, after a warm-up, so the host's
enqueue overlaps the kernels. Prints the card and one JSON line
{"root": ..., "ms": {"K1 full E=16 1920x1080": ...}}. Run two trees in
turns in one call (A, B, B, A) and compare within it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPS = 20


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("time_blend: no CUDA device", file=sys.stderr)
        return 1
    from instascene_tpu_torch.data.synthetic import make_bench_scene
    from instascene_tpu_torch.models.gaussians import from_numpy
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import bin_gaussians
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

    dev = torch.device("cuda")
    st, make_cam = make_bench_scene(n=300_000, seed=0, profile="trained")
    p = from_numpy(st, dev)
    ms = {}
    with torch.no_grad():
        for W, H, E, fwd, bwd in (
                (1920, 1080, 16, ("full", "viewer"), ()),
                (976, 728, 0, ("no_dist",), ("full", "no_dist")),
                (976, 728, 16, ("extras_only",), ("extras_only",))):
            cm = camera_mats(make_cam(0, W, H), dev)
            opac = p.opacity_activated()[:, 0]
            pre = preprocess_gaussians(
                p.xyz, p.scaling_activated(), p.rotation_normalized(),
                cm.w2v, cm.full_proj, cm.campos, W, H, opac,
                shs=p.features(), sh_degree=3, alive=p.alive)
            b = bin_gaussians(pre, W, H)
            flat = bv.pack_flat_cols(pre.T, pre.xy, pre.normal_view, opac,
                                     pre.color, p.seg_feature_normed()
                                     if E else None)
            args_ = (flat, b.sorted_gid, b.tile_start, b.tile_end,
                     (W + 15) // 16, E)
            for mode in fwd:
                kw = {mode: True} if mode != "full" else {}
                ms[f"K1 {mode} E={E} {W}x{H}"] = span(
                    lambda: bv.blend_fwd(*args_, **kw))
            for mode in bwd:
                kw = {mode: True} if mode != "full" else {}
                out, iout = bv.blend_fwd(*args_, **kw)
                saved = torch.stack([out[:, 9], out[:, 10 + E],
                                     out[:, 11 + E]], 1).contiguous()
                gen = torch.Generator(device=dev).manual_seed(5)
                gout = torch.randn(out.shape, generator=gen, device=dev)
                ms[f"K2 {mode} E={E} {W}x{H}"] = span(
                    lambda: bv.blend_bwd(*args_, gout, saved, iout, **kw))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"root": args.root, "ms": ms}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
