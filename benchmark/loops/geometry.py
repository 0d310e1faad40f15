"""The geometry stage's loop: the program's train_step
(instascene_tpu_torch/pipelines/train.py) on the orbit's training views in
the trainer's order (a seeded shuffle of every camera per epoch), each
view with a random target image, fresh binning every step, the
densification statistics accumulated and no densify event; closed loop.

The inputs follow instascene_tpu_torch/bench.py's `geometry_inputs` at
commit e06f678 (random targets, the reference defaults' λ, no feature
channels), on the configuration's orbit of training views, every view's
target held on the device as the trainer holds them, made on the device
from the seed.

The check (training): set-up builds one model, Adam state and statistics,
drives them through the first three steps of the window's own call, and
hands the same objects to the window. The reference
(benchmark/reference/train.py) follows those three steps from the same
inputs; compared are each step's loss, the first gradient's norm per
leaf as Adam got it (its first moment over 1 − β1), the norm of each
leaf's change after three steps, and the sum of the statistics'
gradient accumulation (its norm is its few largest entries', and on some
seeds one surfel's screen gradient there differs by several per cent
between the two sides).

One step of the window, drawn from the seed among its first
`replay_among`, is checked too: just before it runs, its input state
(parameters, Adam's moments and count, the statistics) is copied on the
device; after it, its loss, the gradient as Adam got it (the change of
the first moment) and each leaf's change are kept as norms, the
statistics' increment as its sum. Once the window has closed the
reference replays that step from the copied state, and the same numbers
are compared
(`window_*`). A window too short to reach the step is run on, untimed,
until it has.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts as C
from benchmark.loops import common
from benchmark.reference import train as RT
from benchmark.scene import make_scene, train_view

CHECKED = 3
WARM_STEPS = 16
COUNT_VIEWS = 16
B1 = 0.9


class GeometryCell:
    def __init__(self, cfg, mix, seed, dev, warm=True):
        from instascene_tpu_torch.models.densify import init_stats
        from instascene_tpu_torch.models.optimizer import init_adam_state
        from instascene_tpu_torch.ops.rasterize import RasterizeConfig
        from instascene_tpu_torch.pipelines.train import train_step
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self._train_step = train_step
        W, H = cfg["train_width"], cfg["train_height"]
        nc = cfg["n_cameras"]
        self.views = [train_view(i, cfg) for i in range(nc)]
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) + 1)
        self.targets = torch.rand((nc, H, W, 3), generator=gen, device=dev)
        self.cts = [common.camera_tensors(v, dev, self.targets[i])
                    for i, v in enumerate(self.views)]
        scene = make_scene(cfg, seed, dev)
        self.params = common.program_model(scene, with_features=False)
        self.opt = init_adam_state(self.params)
        self.stats = init_stats(self.params.capacity, dev)
        self.bg = torch.zeros(3, device=dev)
        self.lrs = dict(mix["lrs"], seg_feature=0.0)
        self.kw = dict(lambda_dssim=mix["lambda_dssim"],
                       lambda_dist=mix["lambda_dist"],
                       lambda_normal=mix["lambda_normal"],
                       lambda_normal_prior=0.0,
                       cfg=RasterizeConfig(W, H, no_depth_dist=(
                           mix["lambda_dist"] == 0.0
                           and mix["depth_ratio"] == 1.0)),
                       depth_ratio=mix["depth_ratio"])
        self.deck = common.Deck(nc, np.random.default_rng(int(seed)))
        self.window_cams = []
        self.replay_at = int(np.random.default_rng(int(seed) + 5).integers(
            0, mix["replay_among"]))
        self.snap = None
        # the checked steps, through the window's own call
        p0 = {f: getattr(self.params, f).clone() for f in RT.GEOMETRY_FIELDS}
        self.checked_cams, losses = [], []
        for i in range(CHECKED):
            cam = self.deck.next()
            self.checked_cams.append(cam)
            losses.append(self._step(cam))
            if i == 0:
                self.prog_grad = common.norms(
                    {f: self.opt.m[f] / (1 - B1) for f in RT.GEOMETRY_FIELDS})
        self.prog = ([float(x) for x in losses], self.prog_grad,
                     common.norms({f: getattr(self.params, f) - p0[f]
                                   for f in RT.GEOMETRY_FIELDS}),
                     float(self.stats.xyz_gradient_accum.sum()))
        del p0
        # warm-up: nothing compiles; the allocator sees a step's buffers
        for _ in range(min(nc, WARM_STEPS) if warm else 0):
            self._step(self.deck.next())
        common.sync(dev)

    def _step(self, cam, mark=None):
        self.params, self.opt, self.stats, m = self._train_step(
            self.params, self.opt, self.stats, self.cts[cam], self.bg,
            self.lrs, **self.kw, on_stage=mark)
        return m["loss"]

    def _checked_step(self, i, cam, mark=None):
        """Window step i; the drawn one keeps its input state and results."""
        if i != self.replay_at:
            return self._step(cam, mark)
        F = RT.GEOMETRY_FIELDS
        snap = {"cam": cam, "count": self.opt.count,
                "p": {f: getattr(self.params, f).clone() for f in F},
                "m": {f: self.opt.m[f].clone() for f in F},
                "v": {f: self.opt.v[f].clone() for f in F},
                "accum": self.stats.xyz_gradient_accum.clone()}
        loss = self._step(cam, mark)
        nrm = torch.linalg.norm
        snap["got"] = (
            loss, {f: nrm((self.opt.m[f] - B1 * snap["m"][f]) / (1 - B1))
                   for f in F},
            {f: nrm(getattr(self.params, f) - snap["p"][f]) for f in F},
            (self.stats.xyz_gradient_accum - snap["accum"]).sum())
        self.snap = snap
        return loss

    def run_window(self, seconds: float, traced: bool) -> dict:
        last = []

        def step(i, mark):
            cam = self.deck.next()
            self.window_cams.append(cam)
            last[:] = [self._checked_step(i, cam, mark)]
        w = common.training_window(step, seconds, traced, self.dev)
        w["failed"] = 0 if bool(torch.isfinite(last[0])) else 1
        w["cams"] = list(self.window_cams)
        return w

    def finish(self):
        """Untimed steps after the window, until the drawn step has run."""
        i = len(self.window_cams)
        while self.snap is None:
            self._checked_step(i, self.deck.next())
            i += 1
        common.sync(self.dev)

    def release(self):
        self.params = self.opt = self.stats = self.cts = None

    def readings(self):
        """The program's numbers: the checked steps' and the drawn window
        step's."""
        loss, grad, change, accum = self.snap["got"]
        return {"checked": self.prog,
                "window": (float(loss), common.floats(grad),
                           common.floats(change), float(accum))}

    def reference(self, dtype=torch.float32, keep=None):
        """The reference's readings in `dtype`: its three steps from the
        seed's inputs and its replay of the drawn window step. keep: a
        fault's pixel mask for every step."""
        return {"checked": self._reference_checked(dtype, keep),
                "window": self._reference_window(dtype, keep)}

    def _reference_checked(self, dtype, keep):
        """(losses, first-gradient norms, change norms, accumulation
        sum) of the three steps."""
        common.reference_precision(dtype)
        scene = common.cast(make_scene(self.cfg, self.seed, self.dev), dtype)
        p = {f: scene[f] for f in RT.GEOMETRY_FIELDS}
        p0 = dict(p)
        m = {f: torch.zeros_like(v) for f, v in p.items()}
        v = {f: torch.zeros_like(x) for f, x in p.items()}
        accum = torch.zeros(p["xyz"].shape[0], device=self.dev, dtype=dtype)
        losses = []
        for i, cam in enumerate(self.checked_cams):
            loss, g, p, m, v, accum = RT.geometry_step(
                p, m, v, i, accum, self.views[cam],
                self.targets[cam].to(dtype), self.mix, keep)
            losses.append(float(loss))
            if i == 0:
                grad = common.norms(g)
        change = common.norms({f: p[f] - p0[f] for f in RT.GEOMETRY_FIELDS})
        return losses, grad, change, float(accum.float().sum())

    def _reference_window(self, dtype, keep):
        """(loss, gradient norms, change norms, accumulation increment) of
        the drawn window step, replayed from its copied input state."""
        common.reference_precision(dtype)
        s = self.snap
        p = common.cast(s["p"], dtype)
        acc0 = s["accum"].to(dtype)
        loss, g, p2, _, _, acc = RT.geometry_step(
            p, common.cast(s["m"], dtype), common.cast(s["v"], dtype),
            s["count"], acc0, self.views[s["cam"]],
            self.targets[s["cam"]].to(dtype), self.mix, keep)
        return (float(loss), common.norms(g),
                common.norms({f: p2[f] - p[f] for f in RT.GEOMETRY_FIELDS}),
                float((acc - acc0).float().sum()))

    @staticmethod
    def gaps(got, ref) -> dict:
        """The compared numbers of the program's readings `got` against the
        reference's."""
        (plosses, pgrad, pchange, paccum) = got["checked"]
        (losses, grad, change, accum) = ref["checked"]
        (wl, wg, wc, wa) = got["window"]
        (rl, rg, rc, ra) = ref["window"]
        return {
            "loss_gap": max(common.rel_gap(a, b, b) for a, b in
                            zip(plosses, losses)),
            "grad_gap": common.leaf_gaps(pgrad, grad, grad),
            "change_gap": common.leaf_gaps(pchange, change, grad),
            "accum_gap": common.rel_gap(paccum, accum, accum),
            "window_loss_gap": common.rel_gap(wl, rl, rl),
            "window_grad_gap": common.leaf_gaps(wg, rg, rg),
            "window_change_gap": common.leaf_gaps(wc, rc, rg),
            "window_accum_gap": common.rel_gap(wa, ra, ra)}

    def compare(self) -> dict:
        return self.gaps(self.readings(), self.reference())

    def counts(self, window) -> dict:
        """Per step of the window: K1's, K2's and the segment sum's least
        times, and the step's counted operations (kernels and eager work),
        from the reference's work counts of each view on the set-up's
        scene. Where the window saw more than COUNT_VIEWS views, that many
        drawn from the seed are counted, and a step on another view is
        given their mean."""
        scene = make_scene(self.cfg, self.seed, self.dev)
        scene["seg_feature"] = None
        mode = "no_dist" if self.kw["cfg"].no_depth_dist else "full"
        per_cam = {}
        W, H = self.cfg["train_width"], self.cfg["train_height"]
        n = self.cfg["n_gaussians"]
        params = sum(v.numel() for k, v in scene.items()
                     if k in RT.GEOMETRY_FIELDS)
        seen = sorted(set(window["cams"]))
        if len(seen) > COUNT_VIEWS:
            seen = sorted(int(c) for c in np.random.default_rng(
                int(self.seed) + 6).choice(seen, COUNT_VIEWS, replace=False))
        for cam in seen:
            c = common.view_counts(scene, self.views[cam], 0, self.dev)
            evals = int(c["n_eval"].sum())
            hits = int(c["n_hit"].sum())
            k2_evals = int(c["n_contrib"].sum())
            k1 = C.k1_work(n, c["pairs"], c["tiles"], 0, mode, evals, hits)
            k2 = C.k2_work(n, c["pairs"], c["tiles"], 0, mode, k2_evals,
                           hits, c["slots"])
            ss = C.segment_sum_work(n, c["pairs"], C.PACK_COLS)
            eager = (3 * C.eager_render_ops(n)
                     + 3 * C.OPS_GEOMETRY_LOSS_PX * W * H
                     + C.OPS_ADAM * params)
            per_cam[cam] = {"K1": k1, "K2": k2, "segment_sum": ss,
                            "flops": k1["ops"] + k2["ops"] + ss["ops"]
                            + eager}
        keys = ("K1", "K2", "segment_sum")
        val = {c: dict({k: w[k]["s"] for k in keys}, flops=w["flops"])
               for c, w in per_cam.items()}
        avg = {k: float(np.mean([v[k] for v in val.values()]))
               for k in keys + ("flops",)}
        tot = lambda key: sum(val.get(c, avg)[key] for c in window["cams"])
        return {"bound_s": {k: tot(k) for k in keys},
                "flops": tot("flops")}


def setup(cfg, mix, seed, dev, warm=True):
    return GeometryCell(cfg, mix, seed, dev, warm)
