"""The correctness check fails what it must: the control (the reference in
bfloat16 in the program's place) fails one of each cell's numbers, and a
run with the timed path broken underneath reads `correct` false, once for
each fault the cell can have (one chip: no exchange between chips to
leave out), and once more for a training fault that starts only with the
window, which the replayed window step catches."""

import pytest
import torch

from benchmark import run
from benchmark.tests import tiny
from benchmark.tests.test_bench_layout import CELLS


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    torch.set_num_threads(2)
    res = tiny.tiny_res(cell)
    c = run.loop(res["mix"]["loop"]).setup(
        res["config"], res["mix"], tiny.SEED, torch.device("cpu"),
        warm=False)
    c.run_window(1.5, traced=False)
    c.finish()
    got = c.readings()
    c.release()
    ref = c.reference()
    sound = c.gaps(got, ref)
    control = c.gaps(c.reference(torch.bfloat16), ref)
    lim = res["limits"]
    assert all(sound[k] <= lim[k] for k in lim), sound
    assert any(control[k] > lim[k] for k in lim), control


def _unchanged_geometry(monkeypatch):
    from instascene_tpu_torch.pipelines import train
    real = train.train_step

    def step(params, opt, stats, *a, **kw):
        m = real(params, opt, stats, *a, **kw)[3]
        return params, opt, stats, m
    monkeypatch.setattr(train, "train_step", step)


def _half_geometry(monkeypatch):
    from instascene_tpu_torch.pipelines import train

    def photometric_loss(image, gt, lam):
        keep = torch.zeros(image.shape[:2], dtype=torch.bool)
        keep[::2] = True
        ll1 = torch.abs(image - gt)[keep].mean()
        from instascene_tpu_torch.losses import ssim
        return (1.0 - lam) * ll1 + lam * (1.0 - ssim(image, gt)), ll1
    monkeypatch.setattr(train, "photometric_loss", photometric_loss)


def _unchanged_semantic(monkeypatch):
    from instascene_tpu_torch.pipelines import train_semantic as ts
    real = ts.semantic_train_step

    def step(params, opt, *a, **kw):
        return (params, opt) + real(params, opt, *a, **kw)[2:]
    monkeypatch.setattr(ts, "semantic_train_step", step)


def _half_semantic(monkeypatch):
    from instascene_tpu_torch.pipelines import train_semantic as ts
    real = ts.contrastive_loss

    def loss(features, labels, *a, **kw):
        return 2.0 * real(features[::2], labels[::2], *a, **kw)
    monkeypatch.setattr(ts, "contrastive_loss", loss)


def _late(monkeypatch, loop: str, fault):
    """`fault` planted once the window opens: the set-up's checked steps
    and warm-up run sound, the window's steps do not."""
    import importlib
    mod = importlib.import_module(f"benchmark.loops.{loop}")
    cls = mod.GeometryCell if loop == "geometry" else mod.SemanticCell
    real = cls.run_window

    def run_window(self, *a, **kw):
        fault(monkeypatch)
        if loop == "geometry":      # the cell holds the step it imported
            from instascene_tpu_torch.pipelines import train
            self._train_step = train.train_step
        return real(self, *a, **kw)
    monkeypatch.setattr(cls, "run_window", run_window)


def _unchanged_geometry_in_window(monkeypatch):
    _late(monkeypatch, "geometry", _unchanged_geometry)


def _half_geometry_in_window(monkeypatch):
    _late(monkeypatch, "geometry", _half_geometry)


def _unchanged_semantic_in_window(monkeypatch):
    _late(monkeypatch, "semantic", _unchanged_semantic)


def _half_semantic_in_window(monkeypatch):
    _late(monkeypatch, "semantic", _half_semantic)


def _altered_frame(monkeypatch):
    import instascene_tpu_torch.render as rd
    real = rd.render

    def render(*a, **kw):
        pkg = real(*a, **kw)
        rgb = pkg["render"].clone()
        rgb[: rgb.shape[0] // 2] += 0.25
        return dict(pkg, render=rgb)
    monkeypatch.setattr(rd, "render", render)


FAULTS = [("waldo.geometry", _unchanged_geometry),
          ("waldo.geometry", _half_geometry),
          ("waldo.geometry", _unchanged_geometry_in_window),
          ("waldo.geometry", _half_geometry_in_window),
          ("waldo.semantic", _unchanged_semantic),
          ("waldo.semantic", _half_semantic),
          ("waldo.semantic", _unchanged_semantic_in_window),
          ("waldo.semantic", _half_semantic_in_window),
          ("waldo.frame-1080p", _altered_frame)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_fault_reads_incorrect(cell, fault, monkeypatch):
    torch.set_num_threads(2)
    fault(monkeypatch)
    out = tiny.tiny_run(cell, trace=0)
    assert out["correct"] is False, out["compared"]
