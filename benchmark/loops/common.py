"""What the loops share: the program's model and cameras built from the
benchmark's inputs, the training window, the stage marks, and the
comparison of a training run with its reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.reference import render as R

FIELDS = ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "seg_feature")


def program_model(scene: dict, with_features: bool):
    """The program's GaussianModel over clones of the scene's tensors."""
    from instascene_tpu_torch.models.gaussians import GaussianModel
    c = {k: v.clone() for k, v in scene.items()}
    if not with_features:
        c["seg_feature"] = None
    return GaussianModel(active_sh_degree=3, max_sh_degree=3, **c)


def camera_tensors(view, dev, target=None):
    """The program's CameraTensors of a benchmark View."""
    from instascene_tpu_torch.pipelines.train import CameraTensors
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return CameraTensors(w2v=t(view.w2v), full_proj=t(view.full_proj),
                         campos=t(view.campos), c2w_rot=t(view.c2w_rot),
                         gt_image=target, normal_prior=None,
                         normal_mask=None, tanfovx=float(view.tanfovx),
                         tanfovy=float(view.tanfovy))


class Deck:
    """The trainer's camera order: each epoch a seeded shuffle of all
    cameras, popped one by one."""

    def __init__(self, n: int, rng: np.random.Generator):
        self.n, self.rng, self.stack = n, rng, []

    def next(self) -> int:
        if not self.stack:
            self.stack = list(self.rng.permutation(self.n))
        return int(self.stack.pop())


class HostEvent:
    """A CUDA event's interface on the host's clock, for the CPU, whose
    operations complete before they return (the benchmark's own tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def event(dev, timing: bool = True):
    if dev.type == "cuda":
        return torch.cuda.Event(enable_timing=timing)
    return HostEvent()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Stages:
    """Events at the step's own on_stage marks: stage → summed ms, and the
    steps seen."""

    def __init__(self, dev):
        self.dev = dev
        self.marks = []             # per step: [(name, event)]

    def begin(self):
        ev = event(self.dev)
        ev.record()
        self.marks.append([("start", ev)])

    def mark(self, name: str):
        ev = event(self.dev)
        ev.record()
        self.marks[-1].append((name, ev))

    def summary(self) -> dict:
        """Mean ms per step of each stage (from the previous mark to its
        own), over the steps that reached it."""
        tot, cnt = {}, {}
        for step in self.marks:
            for (_, a), (name, b) in zip(step, step[1:]):
                tot[name] = tot.get(name, 0.0) + a.elapsed_time(b)
                cnt[name] = cnt.get(name, 0) + 1
        return {k: tot[k] / cnt[k] for k in tot}


def training_window(step, seconds: float, traced: bool, dev) -> dict:
    """Closed loop: step(i, mark) until the host's clock passes `seconds`,
    then a synchronize closes the window; rate = steps / window seconds.
    With traced, each step's stage marks are CUDA events."""
    stages = Stages(dev) if traced else None
    sync(dev)
    t0 = time.perf_counter()
    n = 0
    while True:
        if stages:
            stages.begin()
        step(n, stages.mark if stages else None)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(dev)
    window_s = time.perf_counter() - t0
    return {"n": n, "window_s": window_s,
            "stage_ms": stages.summary() if stages else None}


def rel_gap(a: float, b: float, scale: float) -> float:
    return abs(a - b) / max(abs(scale), 1e-30)


def leaf_gaps(prog: dict, ref: dict, ref_grads: dict) -> float:
    """The worst leaf's gap between the program's and the reference's
    norms, against the larger of that leaf's reference norm and the
    median leaf's. Leaves whose reference gradient is under a thousandth
    of the median leaf's are left out (they move by round-off alone)."""
    med_g = float(np.median(list(ref_grads.values())))
    keep = [k for k in ref if ref_grads[k] >= 1e-3 * med_g]
    med = float(np.median([ref[k] for k in keep]))
    return max(rel_gap(prog[k], ref[k], max(ref[k], med)) for k in keep)


def norms(d: dict) -> dict:
    return {k: float(torch.linalg.norm(v.float())) for k, v in d.items()}


def floats(d: dict) -> dict:
    return {k: float(v) for k, v in d.items()}


def reference_precision(dtype):
    """Reference arithmetic: TF32 off, inputs cast to `dtype`."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dtype


def cast(d: dict, dtype) -> dict:
    return {k: (v.to(dtype) if torch.is_floating_point(v) else v)
            for k, v in d.items()}


def view_counts(scene: dict, view, E: int, dev):
    """The reference blend's work maps of one view of the scene (no
    gradient): per pixel the slots evaluated until the latch, the
    contributions and n_contrib, and the frame's pairs, tiles and slots
    reduced."""
    a = R.activated(scene)
    t = lambda x: torch.as_tensor(x, device=dev)
    with torch.no_grad():
        pre = R.preprocess(scene["xyz"], a["scaling"], a["rotation"],
                           t(view.w2v), t(view.full_proj), t(view.campos),
                           view.width, view.height, a["opacity"],
                           shs=a["shs"])
        bins = R.bin_pairs(pre, view.width, view.height)
        ext = R.normed(scene["seg_feature"]) if E else None
        flat = R.pack(pre.T, pre.xy, pre.normal_view, a["opacity"],
                      pre.color, ext)
        maps, _ = R.blend_maps(flat, bins, view.width, view.height, False)
    gx = (view.width + R.TILE - 1) // R.TILE
    gy = (view.height + R.TILE - 1) // R.TILE
    return {"n_eval": maps["n_eval"][..., 0], "n_hit": maps["n_hit"][..., 0],
            "n_contrib": maps["n_contrib"][..., 0],
            "pairs": bins.total_pairs, "tiles": gx * gy,
            "slots": maps["n_slots"], "n": scene["xyz"].shape[0]}
