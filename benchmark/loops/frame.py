"""The interactive viewer's frames: the program's render()
(instascene_tpu_torch/render.py) with viewer=True, the call the
segmentation engine's render_view makes, then the engine's per-pixel
feature normalisation and PCA colouring on the device; one client, closed
loop. Every frame takes the next of the orbit's poses at the viewer's size,
stepping round the ring (a user dragging the camera), from a seeded start
and direction. A frame is timed on the host's clock from the pose's
submission until an event recorded after its last operation has
completed. The engine's copies to the host are not in it.

The inputs follow instascene_tpu_torch/bench.py's `frame_setup` and
`frame` at commit e06f678 (SH 3, the 16 normalised feature channels, a
black background), with the engine's colouring of
instascene_tpu_torch/viewer/gui.py::render_view.

The check: frames drawn from the seed among the first of the window keep
their outputs (colour, alpha, the coloured features); once the window has
closed the reference (benchmark/reference/render.py) renders the same
poses from the same inputs, and the widest relative L2 gap of each output
over those frames is compared.
"""

from __future__ import annotations

import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import counts as C
from benchmark.loops import common
from benchmark.reference import render as R
from benchmark.scene import make_scene, orbit_view, pca_projection


class FrameCell:
    def __init__(self, cfg, mix, seed, dev, warm=True):
        from instascene_tpu_torch.render import render
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self._render = render
        W, H = cfg["viewer_width"], cfg["viewer_height"]
        P = mix["poses"]
        rng = np.random.default_rng(int(seed))
        self.k0 = int(rng.integers(0, P))
        self.dir = 1 if rng.random() < 0.5 else -1
        self.sampled = set(int(i) for i in rng.choice(
            mix["sample_among"], mix["samples"], replace=False))
        self.views = [orbit_view(2 * math.pi * k / P, cfg, W, H,
                                 cfg["viewer_fovy"]) for k in range(P)]
        self.cams = [SimpleNamespace(w2v=v.w2v, full_proj=v.full_proj,
                                     camera_center=v.campos, width=W,
                                     height=H) for v in self.views]
        scene = make_scene(cfg, seed, dev)
        self.params = common.program_model(scene, with_features=True)
        self.proj = pca_projection(scene["seg_feature"])
        self.bg = torch.zeros(3, device=dev)
        self.kept = {}
        self.poses = []
        # warm-up: every pose once
        for k in range(P if warm else 0):
            self._frame(k)
        common.sync(dev)

    def _frame(self, k, render_events=None):
        if render_events is not None:
            render_events[0].record()
        pkg = self._render(self.cams[k], self.params, None, self.bg,
                           viewer=True)
        if render_events is not None:
            render_events[1].record()
        feat = pkg["seg_feature"]
        feat = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-6)
        feat_rgb = torch.clamp(feat @ self.proj * 0.5 + 0.5, 0, 1)
        return pkg["render"], pkg["rend_alpha"], feat_rgb

    def run_window(self, seconds: float, traced: bool) -> dict:
        P = self.mix["poses"]
        lat, render_ms = [], []
        common.sync(self.dev)
        t0 = time.perf_counter()
        i = 0
        while True:
            k = (self.k0 + self.dir * i) % P
            evs = ([common.event(self.dev) for _ in range(2)]
                   if traced else None)
            done = common.event(self.dev, timing=False)
            ts = time.perf_counter()
            out = self._frame(k, evs)
            done.record()
            done.synchronize()
            lat.append((time.perf_counter() - ts) * 1e3)
            if traced:
                render_ms.append(evs)
            if i in self.sampled:
                self.kept[i] = (k, [o.clone() for o in out])
            self.poses.append(k)
            i += 1
            if time.perf_counter() - t0 >= seconds:
                break
        common.sync(self.dev)
        window_s = time.perf_counter() - t0
        return {"n": i, "window_s": window_s, "latencies_ms": lat,
                "failed": 0,
                "render_ms": ([a.elapsed_time(b) for a, b in render_ms]
                              if traced else None)}

    def finish(self):
        pass

    def release(self):
        self.params = None

    def readings(self) -> dict:
        """The program's kept outputs: frame → (colour, alpha, features)."""
        return {i: o for i, (_, o) in self.kept.items()}

    def reference(self, dtype=torch.float32) -> dict:
        """The reference's outputs at the kept frames' poses: frame →
        (colour, alpha, coloured features)."""
        common.reference_precision(dtype)
        scene = common.cast(make_scene(self.cfg, self.seed, self.dev), dtype)
        a = R.activated(scene)
        ext = R.normed(scene["seg_feature"])
        t = lambda x: torch.as_tensor(x, device=self.dev).to(dtype)
        out = {}
        for i, (k, _) in sorted(self.kept.items()):
            v = self.views[k]
            with torch.no_grad():
                pre = R.preprocess(scene["xyz"], a["scaling"], a["rotation"],
                                   t(v.w2v), t(v.full_proj), t(v.campos),
                                   v.width, v.height, a["opacity"],
                                   shs=a["shs"])
                bins = R.bin_pairs(pre, v.width, v.height)
                flat = R.pack(pre.T, pre.xy, pre.normal_view, a["opacity"],
                              pre.color, ext)
                maps, _ = R.blend_maps(flat, bins, v.width, v.height, False)
                feat = maps["extra"]
                feat = feat / (torch.linalg.norm(feat, dim=-1, keepdim=True)
                               + 1e-6)
                out[i] = (maps["color"], 1.0 - maps["final_T"], torch.clamp(
                    feat @ self.proj.to(dtype) * 0.5 + 0.5, 0, 1))
        return out

    @staticmethod
    def gaps(got: dict, ref: dict) -> dict:
        """The widest relative L2 gap of each output over the frames."""
        gaps = {"rgb_gap": 0.0, "alpha_gap": 0.0, "feature_gap": 0.0}
        if not ref:
            return {k: math.inf for k in gaps}
        for i, outs in ref.items():
            for key, p, r in zip(gaps, got[i], outs):
                r = r.float()
                g = float(torch.linalg.norm(p.float() - r)
                          / torch.linalg.norm(r).clamp(min=1e-30))
                gaps[key] = max(gaps[key], g)
        return gaps

    def compare(self) -> dict:
        return self.gaps(self.readings(), self.reference())

    def counts(self, window) -> dict:
        """Per frame: K1 viewer's least time from the reference's work
        counts of its pose, and the frame's counted operations."""
        scene = make_scene(self.cfg, self.seed, self.dev)
        E, n = self.cfg["seg_feat_dim"], self.cfg["n_gaussians"]
        per_pose = {}
        for k in sorted(set(self.poses)):
            c = common.view_counts(scene, self.views[k], E, self.dev)
            k1 = C.k1_work(n, c["pairs"], c["tiles"], E, "viewer",
                           int(c["n_eval"].sum()), int(c["n_hit"].sum()))
            px = self.cfg["viewer_width"] * self.cfg["viewer_height"]
            per_pose[k] = (k1, k1["ops"] + C.eager_render_ops(n)
                           + px * (4 * E + 6 * E + 6))
        return {"bound_s": {"K1": sum(per_pose[k][0]["s"]
                                      for k in self.poses)},
                "flops": sum(per_pose[k][1] for k in self.poses)}


def setup(cfg, mix, seed, dev, warm=True):
    return FrameCell(cfg, mix, seed, dev, warm)
