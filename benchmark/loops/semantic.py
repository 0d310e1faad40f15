"""The semantic stage's loop: the program's semantic_train_step
(instascene_tpu_torch/pipelines/train_semantic.py) on the orbit's training
views in the trainer's order (a seeded shuffle of every camera per epoch),
with each view's binning cached in set-up (frozen geometry), and on every
tenth iteration the window of n_mv consecutive views in full
(SemanticMVBlock), as the trainer runs it; closed loop.

The pixel draws are the benchmark's: each step draws, from a generator on
the device seeded from --seed, `batch` pixels uniformly with replacement
among the view's labelled pixels (its SAM map's non-zero labels), `batch`
gaussians among those visible in the view with a non-zero 3D label, and on
a window step `batch` pixels among the window's labelled pixels; the
program gets them through the step's `draws`, the reference the same.

The inputs follow instascene_tpu_torch/bench.py's `semantic_inputs` at
commit e06f678 (random SAM labels and 3D labels, the cached binning per
view, bench.py's λ and batch), on the configuration's 16-view orbit and
made on the device from the seed.

The check (training): the first three steps of set-up, iterations 8, 9 and
10 of the trainer's schedule (the third with the window), go through the
window's own call on the model that the window then trains. The reference
(benchmark/reference/train.py) follows them from the same inputs;
compared are each step's loss, the first gradient's norm as Adam got it
and the norm of the features' change after three steps.

One window step is checked too: a step with the window (every
`mv_every`th iteration), drawn from the seed among the window's first
`replay_among`. Just before it runs the features and their Adam state
are copied on the device; after it its loss, the gradient as Adam got it
(the change of the first moment) and the features' change are kept as
norms. Once the window has closed the reference replays that step from
the copied state with the step's own draws, and the same numbers are
compared (`window_*`). A window too short to reach the step is run on,
untimed, until it has.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import counts as C
from benchmark.loops import common
from benchmark.reference import render as R
from benchmark.reference import train as RT
from benchmark.scene import make_scene, train_view

CHECKED = 3
FIRST_ITERATION = 8
B1 = 0.9


class SemanticCell:
    def __init__(self, cfg, mix, seed, dev, warm=True):
        from instascene_tpu_torch.models.optimizer import init_adam_state
        from instascene_tpu_torch.ops.rasterize import (
            RasterizeConfig, compute_binning_cache)
        from instascene_tpu_torch.pipelines import train_semantic as ts
        from instascene_tpu_torch.semantic.contrastive import valid_ids_pack
        self.cfg, self.mix, self.seed, self.dev = cfg, mix, seed, dev
        self.ts = ts
        W, H = cfg["train_width"], cfg["train_height"]
        nc = cfg["n_cameras"]
        self.hw = W * H
        self.views = [train_view(i, cfg) for i in range(nc)]
        scene = make_scene(cfg, seed, dev)
        self.params = common.program_model(scene, with_features=True)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed) + 2)
        L = mix["labels"]
        self.segmaps = torch.randint(0, L, (nc, H * W), generator=gen,
                                     device=dev, dtype=torch.int32)
        self.lab3d = torch.randint(0, L, (self.params.capacity,),
                                   generator=gen, device=dev,
                                   dtype=torch.int32)
        self.seg_valid = [torch.nonzero(s > 0)[:, 0] for s in self.segmaps]
        self.vis_valid = [torch.nonzero(self._visible(v) & (self.lab3d > 0))
                          [:, 0] for v in self.views]
        nm = mix["n_mv"]
        self.mv_valid = [torch.cat([self.seg_valid[v0 + k] + k * self.hw
                                    for k in range(nm)])
                         for v0 in range(nc - nm)]
        self.bundles = []
        for i, v in enumerate(self.views):
            ct = common.camera_tensors(v, dev)
            binning = compute_binning_cache(self.params, ct.mats, W, H)
            seg = self.segmaps[i].reshape(H, W)
            spack = valid_ids_pack(seg.reshape(-1) > 0)
            vis = torch.zeros(self.params.capacity, dtype=torch.bool,
                              device=dev)
            vis[self.vis_valid[i]] = True
            vpack = valid_ids_pack(vis)
            self.bundles.append(ts.SemanticCamera(
                ct.w2v, ct.full_proj, ct.campos, seg, seg, binning, spack,
                spack, vpack, len(self.seg_valid[i]), len(self.seg_valid[i]),
                len(self.vis_valid[i])))
        self.hyp = ts.SemanticHypers(
            bg=torch.zeros(3, device=dev),
            lrs={f: 0.0 for f in common.FIELDS} | {
                "seg_feature": mix["lr_seg_feature"]},
            lam_sv=mix["lam_sv"], lam_mv=mix["lam_mv"], lam_3d=mix["lam_3d"],
            seg3d_labels=self.lab3d)
        self.scfg = ts.SemanticStepConfig(
            raster=RasterizeConfig(W, H, bwd_extras_only=True),
            batch=mix["batch"], max_labels=mix["max_labels"])
        self.opt = init_adam_state(self.params)
        self.deck = common.Deck(nc, np.random.default_rng(int(seed)))
        self.host_rng = np.random.default_rng(int(seed) + 3)
        self.draw_gen = torch.Generator(device=dev)
        self.draw_gen.manual_seed(int(seed) + 4)
        self.it = FIRST_ITERATION
        self.window_steps = []
        self.replay_rng = np.random.default_rng(int(seed) + 5)
        self.replay_it, self.snap = None, None
        segf0 = self.params.seg_feature.clone()
        self.checked, losses = [], []
        for i in range(CHECKED):
            step = self._plan()
            self.checked.append(step)
            losses.append(self._run(step))
            if i == 0:
                self.prog_grad = common.norms(
                    {"seg_feature": self.opt.m["seg_feature"] / (1 - B1)})
        self.prog = ([float(x) for x in losses], self.prog_grad,
                     common.norms({"seg_feature": self.params.seg_feature
                                   - segf0}))
        del segf0
        # warm-up: every view once, and a window step
        while warm and self.it < FIRST_ITERATION + CHECKED + nc + 1:
            self._run(self._plan())
        common.sync(dev)

    def _visible(self, view):
        """The gaussians the view sees (the reference's preprocess: valid,
        radius > 0), the set the 3D loss draws from."""
        a = R.activated({k: getattr(self.params, k) for k in
                         ("scaling", "rotation", "opacity", "features_dc",
                          "features_rest")})
        t = lambda x: torch.as_tensor(x, device=self.dev)
        with torch.no_grad():
            pre = R.preprocess(self.params.xyz, a["scaling"], a["rotation"],
                               t(view.w2v), t(view.full_proj),
                               t(view.campos), view.width, view.height,
                               a["opacity"],
                               color=torch.zeros_like(self.params.xyz))
        return pre.valid & (pre.radius > 0)

    def _plan(self) -> dict:
        """The next iteration's view, window and draws."""
        B = self.mix["batch"]
        g = self.draw_gen
        cam = self.deck.next()
        pick = lambda pool: pool[torch.randint(0, len(pool), (B,),
                                               generator=g, device=self.dev)]
        step = {"it": self.it, "cam": cam, "sv": pick(self.seg_valid[cam]),
                "d3": pick(self.vis_valid[cam]), "mv": None}
        if self.it % self.mix["mv_every"] == 0:
            v0 = int(self.host_rng.integers(0, len(self.mv_valid)))
            step["mv"] = (v0, pick(self.mv_valid[v0]))
        self.it += 1
        return step

    def _run(self, step, mark=None):
        mv = None
        draws = {"sv": [step["sv"]], "d3": step["d3"]}
        if step["mv"] is not None:
            v0, idx = step["mv"]
            mv = self.ts.SemanticMVBlock(
                self.bundles[v0:v0 + self.mix["n_mv"]])
            draws["mv"] = idx
        self.params, self.opt, loss = self.ts.semantic_train_step(
            self.params, self.opt, self.bundles[step["cam"]], mv, self.hyp,
            self.scfg, draws=draws, on_stage=mark)
        return loss

    def _checked_run(self, step, mark=None):
        """A window step; the drawn one keeps its input state and results."""
        if step["it"] != self.replay_it:
            return self._run(step, mark)
        f = "seg_feature"
        snap = {"step": step, "count": self.opt.count,
                "p": getattr(self.params, f).clone(),
                "m": self.opt.m[f].clone(), "v": self.opt.v[f].clone()}
        loss = self._run(step, mark)
        nrm = torch.linalg.norm
        snap["got"] = (loss, nrm((self.opt.m[f] - B1 * snap["m"]) / (1 - B1)),
                       nrm(getattr(self.params, f) - snap["p"]))
        self.snap = snap
        return loss

    def run_window(self, seconds: float, traced: bool) -> dict:
        every, among = self.mix["mv_every"], self.mix["replay_among"]
        self.replay_it = int(self.replay_rng.choice(
            [it for it in range(self.it, self.it + among) if it % every == 0]))
        last = []

        def step(i, mark):
            s = self._plan()
            self.window_steps.append((s["cam"], s["mv"] is not None))
            if traced:
                self.window_steps[-1] += (s["sv"], s["mv"])
            last[:] = [self._checked_run(s, mark)]
        w = common.training_window(step, seconds, traced, self.dev)
        w["failed"] = 0 if bool(torch.isfinite(last[0])) else 1
        w["mv_steps"] = sum(1 for s in self.window_steps if s[1])
        return w

    def finish(self):
        """Untimed steps after the window, until the drawn step has run."""
        while self.snap is None:
            self._checked_run(self._plan())
        common.sync(self.dev)

    def release(self):
        self.params = self.opt = self.bundles = None

    def readings(self):
        """The program's numbers: the checked steps' and the drawn window
        step's."""
        loss, grad, change = self.snap["got"]
        return {"checked": self.prog,
                "window": (float(loss), {"seg_feature": float(grad)},
                           {"seg_feature": float(change)})}

    def reference(self, dtype=torch.float32, keep=None):
        """The reference's readings in `dtype`: its three steps and its
        replay of the drawn window step. keep: a fault's mask over each
        step's drawn pixels."""
        common.reference_precision(dtype)
        scene = common.cast(make_scene(self.cfg, self.seed, self.dev), dtype)
        geo = {k: scene[k] for k in ("xyz", "scaling", "rotation", "opacity",
                                     "features_dc", "features_rest")}
        maps = [s.reshape(-1) for s in self.segmaps]
        step = lambda segf, m, v, count, s: RT.semantic_step(
            geo, segf, m, v, count, self.views,
            dict(s, segmaps=maps, lab3d=self.lab3d), self.mix, keep)
        # the three checked steps from the seed's features
        segf = segf0 = scene["seg_feature"]
        m, v = torch.zeros_like(segf), torch.zeros_like(segf)
        losses = []
        for i, s in enumerate(self.checked):
            loss, g, segf, m, v = step(segf, m, v, i, s)
            losses.append(float(loss))
            if i == 0:
                grad = common.norms({"seg_feature": g})
        checked = (losses, grad,
                   common.norms({"seg_feature": segf - segf0}))
        # the drawn window step from its copied state
        sn = self.snap
        p = sn["p"].to(dtype)
        loss, g, p2, _, _ = step(p, sn["m"].to(dtype), sn["v"].to(dtype),
                                 sn["count"], sn["step"])
        window = (float(loss), common.norms({"seg_feature": g}),
                  common.norms({"seg_feature": p2 - p}))
        return {"checked": checked, "window": window}

    @staticmethod
    def gaps(got, ref) -> dict:
        """The compared numbers of the program's readings `got` against the
        reference's."""
        (plosses, pgrad, pchange) = got["checked"]
        (losses, grad, change) = ref["checked"]
        (wl, wg, wc) = got["window"]
        (rl, rg, rc) = ref["window"]
        return {
            "loss_gap": max(common.rel_gap(a, b, b) for a, b in
                            zip(plosses, losses)),
            "grad_gap": common.leaf_gaps(pgrad, grad, grad),
            "change_gap": common.leaf_gaps(pchange, change, grad),
            "window_loss_gap": common.rel_gap(wl, rl, rl),
            "window_grad_gap": common.leaf_gaps(wg, rg, rg),
            "window_change_gap": common.leaf_gaps(wc, rc, rg)}

    def compare(self) -> dict:
        return self.gaps(self.readings(), self.reference())

    def counts(self, window) -> dict:
        """Per step of the window: K1's, K2's and the segment sum's least
        times over the pixels the step draws (the others are latched done
        before the walk), and the step's counted operations, from the
        reference's work maps of each view."""
        scene = make_scene(self.cfg, self.seed, self.dev)
        E, n = self.cfg["seg_feat_dim"], self.cfg["n_gaussians"]
        B, K = self.mix["batch"], self.mix["max_labels"]
        per_view = {}
        steps = [s for s in self.window_steps if len(s) > 2]
        need = sorted({s[0] for s in steps} | {
            s[3][0] + k for s in steps if s[3] is not None
            for k in range(self.mix["n_mv"])})
        for cam in need:
            per_view[cam] = common.view_counts(scene, self.views[cam], E,
                                               self.dev)
        bound = {"K1": 0.0, "K2": 0.0, "segment_sum": 0.0}
        flops = 0.0

        def view_work(cam, pixels):
            c = per_view[cam]
            u = torch.unique(pixels)
            ev = int(c["n_eval"].reshape(-1)[u].sum())
            hits = int(c["n_hit"].reshape(-1)[u].sum())
            k2e = int(c["n_contrib"].reshape(-1)[u].sum())
            k1 = C.k1_work(n, c["pairs"], c["tiles"], E, "extras_only", ev,
                           hits)
            # slots reduced are not counted over a subset of pixels: the
            # additions of the slot sums are left out (an undercount)
            k2 = C.k2_work(n, c["pairs"], c["tiles"], E, "extras_only", k2e,
                           hits, hits)
            ss = C.segment_sum_work(n, c["pairs"], E)
            for key, w in (("K1", k1), ("K2", k2), ("segment_sum", ss)):
                bound[key] += w["s"]
            return (k1["ops"] + k2["ops"] + ss["ops"]
                    + 3 * C.eager_render_ops(n, sh=False))

        for cam, _, sv, mv in steps:
            flops += view_work(cam, sv)
            flops += 2 * 3 * C.ops_protonce(B, K, E)
            flops += C.OPS_ADAM * n * E
            if mv is not None:
                v0, idx = mv
                for k in range(self.mix["n_mv"]):
                    sel = idx[idx // self.hw == k] % self.hw
                    flops += view_work(v0 + k, sel)
                flops += 3 * C.ops_protonce(B, K, E)
        return {"bound_s": bound, "flops": flops}


def setup(cfg, mix, seed, dev, warm=True):
    return SemanticCell(cfg, mix, seed, dev, warm)
