"""adam_step's paths: which one a call takes, and the kernel wrapper's
launch arguments (on the CPU, the device check answering "cuda" and the C
entry replaced by a stand-in that runs the eager chain on the memory its
pointers name); then the CUDA kernel (csrc/adam.cu) on the card, every
output bit for bit the eager chain's.

This file imports no JAX, so it also runs on a GPU machine without it:
    python -m pytest --noconftest -m cuda tests/test_torch_adam_kernel.py -q
"""

import contextlib
import ctypes
from collections import Counter

import numpy as np
import pytest
import torch

GEOMETRY_LRS = {"xyz": 1.6e-4, "features_dc": 2.5e-3,
                "features_rest": 1.25e-4, "opacity": 0.05, "scaling": 5e-3,
                "rotation": 1e-3, "seg_feature": 0.0}
SEMANTIC_LRS = {f: 0.0 for f in GEOMETRY_LRS} | {"seg_feature": 1e-3}


def _model(n, dev, seed=0, e=16):
    """n gaussians (SH 3, e feature channels, a tenth dead) with random
    fields, on dev."""
    from instascene_tpu_torch.models.gaussians import GaussianModel
    g = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s: torch.randn(s, generator=g, device=dev)
    return GaussianModel(
        xyz=r(n, 3), features_dc=r(n, 1, 3), features_rest=r(n, 15, 3),
        scaling=r(n, 2) - 4.0, rotation=r(n, 4), opacity=r(n, 1),
        alive=torch.rand(n, generator=g, device=dev) > 0.1,
        seg_feature=r(n, e) if e else None, active_sh_degree=3)


def _grads(p, seed=1, nonfinite=False, missing=()):
    """A gradient for every field but `missing`; with nonfinite, the dead
    rows' gradients are NaN, their first three +Inf and -Inf."""
    from instascene_tpu_torch.models.optimizer import TRAINABLE_FIELDS
    g = torch.Generator(device=p.device).manual_seed(seed)
    out = {}
    for f in TRAINABLE_FIELDS:
        t = getattr(p, f)
        if t is None or f in missing:
            continue
        x = torch.randn(t.shape, generator=g, device=p.device) * 1e-2
        if nonfinite:
            dead = torch.nonzero(~p.alive)[:, 0]
            x[dead] = float("nan")
            x[dead[:3]] = float("inf")
            x[dead[3:6]] = -float("inf")
        out[f] = x
    return out


def _state(p, count, seed=2):
    """Adam state after count - 1 steps: random moments (v > 0)."""
    from instascene_tpu_torch.models.optimizer import init_adam_state
    s = init_adam_state(p)
    g = torch.Generator(device=p.device).manual_seed(seed)
    for d in (s.m, s.v):
        for f, t in d.items():
            d[f] = torch.randn(t.shape, generator=g, device=p.device) * 1e-3
    s.v = {f: t.abs() for f, t in s.v.items()}
    s.count = count - 1
    return s


def _same_bits(a, b):
    """Equal shapes and bits, NaN where NaN (torch.equal fails on NaN)."""
    if a.shape != b.shape:
        return False
    a, b = a.contiguous(), b.contiguous()
    same = a.view(torch.int32) == b.view(torch.int32)
    return bool((same | (torch.isnan(a) & torch.isnan(b))).all())


def _compare(got, want, fields):
    """The fields whose new param, m or v differ between two adam_step
    results."""
    (pg, sg), (pw, sw) = got, want
    assert sg.count == sw.count
    return [f"{f}.{k}" for f in fields
            for k, a, b in (("p", getattr(pg, f), getattr(pw, f)),
                            ("m", sg.m[f], sw.m[f]), ("v", sg.v[f], sw.v[f]))
            if not _same_bits(a, b)]


def _from_address(addr, n, ctype=ctypes.c_float):
    return np.ctypeslib.as_array((ctype * n).from_address(addr))


def _stand_in(calls):
    """A Python stand-in for csrc/adam.cu's adam_launch over host memory:
    decodes its arguments as the C entry does (floats rounded as ctypes
    rounds them), records them in `calls`, and writes each field's eager
    update into the output buffers its pointers name."""
    def launch(k, ptrs, n, width, lr, alive, b1, omb1, b2, omb2, eps, step,
               stream):
        ptrs = list((ctypes.c_void_p * (7 * k)).from_address(ptrs))
        n = _from_address(n, k, ctypes.c_longlong).tolist()
        width = _from_address(width, k, ctypes.c_int).tolist()
        lr = _from_address(lr, k).tolist()
        b1, omb1, b2, omb2, eps = (ctypes.c_float(x).value
                                   for x in (b1, omb1, b2, omb2, eps))
        calls.append(dict(k=k, n=n, width=width, lr=lr, step=step,
                          scalars=(b1, omb1, b2, omb2, eps),
                          null_grads=[ptrs[7 * j + 1] is None
                                      for j in range(k)]))
        rows = max(nj // wj for nj, wj in zip(n, width))
        a_rows = torch.from_numpy(_from_address(alive, rows, ctypes.c_bool))
        c1 = 1.0 - torch.tensor(b1, dtype=torch.float32) ** float(step)
        c2 = 1.0 - torch.tensor(b2, dtype=torch.float32) ** float(step)
        for j in range(k):
            t = [None if q is None else torch.from_numpy(
                _from_address(q, n[j])) for q in ptrs[7 * j:7 * j + 7]]
            p, g, m, v, po, mo, vo = t
            g = torch.zeros_like(p) if g is None else g
            a = a_rows[torch.arange(n[j]) // width[j]]
            mo[:] = b1 * m + omb1 * g
            vo[:] = b2 * v + omb2 * (g * g)
            po[:] = p - torch.where(a, lr[j] * (mo / c1) / (
                torch.sqrt(vo / c2) + eps), 0.0)
        return 0
    return launch


@pytest.fixture
def on_card(monkeypatch):
    """The device check answering "cuda" for CPU tensors, and the C entry
    replaced by _stand_in; yields the list of its calls."""
    from instascene_tpu_torch.models import optimizer as opt
    calls, symbols = [], []

    def lib_fn(source, symbol, argtypes):
        symbols.append((source, symbol))
        return _stand_in(calls)
    monkeypatch.setattr(opt, "_on_card", lambda t: True)
    monkeypatch.setattr(opt, "lib_fn", lib_fn)
    monkeypatch.setattr(opt, "stream", lambda dev: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    yield calls
    assert set(symbols) <= {("adam.cu", "adam_launch")}


def _cpu_case(case):
    """(model, grads, state, lrs, frozen fields) of a CPU case at 301 rows
    (not a multiple of 4)."""
    from instascene_tpu_torch.models.optimizer import GEOMETRY_FIELDS
    p = _model(301, "cpu")
    grads, lrs, frozen = _grads(p), GEOMETRY_LRS, ()
    if case == "semantic":
        grads = {"seg_feature": grads["seg_feature"]}
        lrs, frozen = SEMANTIC_LRS, GEOMETRY_FIELDS
    elif case == "nonfinite":
        grads = _grads(p, nonfinite=True)
    elif case == "missing_grad":
        grads = _grads(p, missing=("features_rest", "opacity"))
    elif case == "unaligned":
        # features_rest a view one float into its buffer
        buf = torch.randn(301 * 45 + 1)
        p = p.replace(features_rest=buf[1:].view(301, 15, 3))
    elif case == "no_features":
        p = p.replace(seg_feature=None)
        grads.pop("seg_feature")
    return p, grads, _state(p, 8), lrs, frozen


CPU_CASES = ["geometry", "semantic", "nonfinite", "missing_grad", "unaligned",
             "no_features"]


@pytest.mark.parametrize("case", CPU_CASES)
def test_launch_arguments(case, on_card):
    """On the card adam_step makes one launch whose arguments describe
    every updated field (its element count, row width, learning rate, a
    null gradient where none was given) and the step's scalars; the
    outputs written through its pointers are the eager chain's, frozen
    fields are passed through untouched, and LAUNCHES["adam"] counts it."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.models import optimizer as opt
    p, grads, state, lrs, frozen = _cpu_case(case)
    fields = [f for f in opt.TRAINABLE_FIELDS
              if getattr(p, f) is not None and f not in frozen]
    before = LAUNCHES.copy()
    got = opt.adam_step(p, grads, state, lrs, frozen_fields=frozen)
    assert LAUNCHES == before + Counter(adam=1)
    (call,) = on_card
    assert call["k"] == len(fields) and call["step"] == 8
    assert call["n"] == [getattr(p, f).numel() for f in fields]
    assert call["width"] == [getattr(p, f).numel() // 301 for f in fields]
    assert call["lr"] == [ctypes.c_float(lrs[f]).value for f in fields]
    assert call["null_grads"] == [f not in grads for f in fields]
    assert call["scalars"] == tuple(ctypes.c_float(x).value for x in (
        0.9, 1 - 0.9, 0.999, 1 - 0.999, 1e-15))
    want = opt.adam_plain([(f, getattr(p, f), grads.get(f)) for f in fields],
                          state, p.alive, lrs, 0.9, 0.999, 1e-15, 8)
    pg, sg = got
    for f in fields:
        for a, b in zip((getattr(pg, f), sg.m[f], sg.v[f]), want[f]):
            assert _same_bits(a, b), f
    for f in frozen:
        assert getattr(pg, f) is getattr(p, f)
        assert sg.m[f] is state.m[f] and sg.v[f] is state.v[f]
    assert sg.count == 8 and state.count == 7


def test_cpu_tensors_take_the_eager_chain(monkeypatch):
    """CPU tensors run adam_plain: no launch is counted and no kernel
    library is built or loaded. The inputs are left as they were and
    every output of an updated field is a new tensor."""
    from instascene_tpu_torch import cuda_build
    from instascene_tpu_torch.models import optimizer as opt

    def refuse(*a, **k):
        raise AssertionError("the CPU path asked for a kernel library")
    monkeypatch.setattr(opt, "lib_fn", refuse)
    monkeypatch.setattr(cuda_build, "load", refuse)
    p, grads, state, lrs, _ = _cpu_case("geometry")
    copies = {f: getattr(p, f).clone() for f in opt.TRAINABLE_FIELDS}
    libs, before = dict(cuda_build._LIBS), cuda_build.LAUNCHES.copy()
    p2, s2 = opt.adam_step(p, grads, state, lrs)
    assert cuda_build.LAUNCHES == before and cuda_build._LIBS == libs
    for f in opt.TRAINABLE_FIELDS:
        assert torch.equal(getattr(p, f), copies[f])
        assert getattr(p2, f) is not getattr(p, f)
        assert s2.m[f] is not state.m[f] and s2.v[f] is not state.v[f]
    assert not torch.equal(p2.xyz, p.xyz)


def test_nothing_to_update_launches_nothing(on_card):
    """No gaussians, or every field frozen: empty outputs (or the inputs
    themselves), the count still advanced, nothing launched or counted."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.models import optimizer as opt
    p = _model(0, "cpu")
    before = LAUNCHES.copy()
    p2, s2 = opt.adam_step(p, {}, _state(p, 1), GEOMETRY_LRS)
    assert p2.features_rest.shape == (0, 15, 3) and s2.count == 1
    q = _model(8, "cpu")
    q2, _ = opt.adam_step(q, {}, _state(q, 1), GEOMETRY_LRS,
                          frozen_fields=opt.TRAINABLE_FIELDS)
    assert q2.xyz is q.xyz
    assert LAUNCHES == before and not on_card


@pytest.mark.parametrize("bad", ["dtype", "shape", "rows", "alive"])
def test_kernel_refuses_what_it_does_not_take(bad, on_card):
    from instascene_tpu_torch.models import optimizer as opt
    p, grads, state, lrs, _ = _cpu_case("geometry")
    match = "xyz"
    if bad == "dtype":
        grads["xyz"] = grads["xyz"].double()
    elif bad == "shape":
        state.m["xyz"] = state.m["xyz"][:, :2]
    elif bad == "rows":
        p = p.replace(xyz=p.xyz[:-1])
    else:
        p, match = p.replace(alive=p.alive.float()), "alive"
    with pytest.raises(ValueError, match=match):
        opt.adam_step(p, grads, state, lrs)
    assert not on_card


@pytest.mark.parametrize("cast", [False, True], ids=["refuse", "cast"])
def test_operand_casts_or_refuses_the_dtype(cast):
    """cuda_build.operand, the kernels' one operand check: Adam's wrapper
    refuses another dtype, preprocess's casts it; both refuse another
    shape and return a contiguous tensor."""
    from instascene_tpu_torch.cuda_build import operand
    cpu = torch.device("cpu")
    t = torch.arange(12, dtype=torch.float64).reshape(4, 3)
    if cast:
        got = operand("x", t.t(), (3, 4), cpu, cast=True)
        assert got.dtype == torch.float32 and got.is_contiguous()
        assert torch.equal(got, t.t().float())
    else:
        with pytest.raises(ValueError, match="x must be torch.float32"):
            operand("x", t, (4, 3), cpu)
        got = operand("x", t.float().t(), (3, 4), cpu)
        assert got.is_contiguous() and torch.equal(got, t.float().t())
    with pytest.raises(ValueError, match=r"x must be .* \(4, 4\)"):
        operand("x", t.float(), (4, 4), cpu, cast=cast)


# ---- the kernel on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _run(p, grads, state, lrs, frozen, kernel, monkeypatch):
    """adam_step on the card through the kernel, or through the eager
    chain (the device check answering "cpu")."""
    from instascene_tpu_torch.models import optimizer as opt
    with monkeypatch.context() as mp:
        if not kernel:
            mp.setattr(opt, "_on_card", lambda t: False)
        out = opt.adam_step(p, grads, state, lrs, frozen_fields=frozen)
    torch.cuda.synchronize()
    return out


CARD_CASES = ["geometry", "semantic", "nonfinite", "missing_grad",
              "odd_capacity", "unaligned"]


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 2, 3, 1000, 30_000])
@pytest.mark.parametrize("case", CARD_CASES)
def test_kernel_matches_eager_bit_for_bit(case, count, cuda, monkeypatch):
    """Every new param and moment of the kernel against the eager chain on
    the same CUDA tensors, bit for bit, at 300,000 gaussians (300,001 for
    odd_capacity): the geometry lrs over all 6 fields plus seg_feature at
    lr 0; the semantic call (geometry frozen: neither read nor written);
    dead rows with NaN and ±Inf gradients; missing gradients; a field
    whose pointer is not 16-byte aligned. One launch a call."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.models.optimizer import (GEOMETRY_FIELDS,
                                                       TRAINABLE_FIELDS)
    n = 300_001 if case == "odd_capacity" else 300_000
    p = _model(n, cuda, seed=count)
    grads, lrs, frozen = _grads(p), GEOMETRY_LRS, ()
    if case == "semantic":
        grads = {"seg_feature": grads["seg_feature"]}
        lrs, frozen = SEMANTIC_LRS, GEOMETRY_FIELDS
    elif case == "nonfinite":
        grads = _grads(p, nonfinite=True)
    elif case == "missing_grad":
        grads = _grads(p, missing=("features_rest", "opacity"))
    elif case == "unaligned":
        buf = torch.randn(n * 45 + 1, device=cuda)
        p = p.replace(features_rest=buf[1:].view(n, 15, 3))
    state = _state(p, count)
    want = _run(p, grads, state, lrs, frozen, False, monkeypatch)
    before = LAUNCHES.copy()
    got = _run(p, grads, state, lrs, frozen, True, monkeypatch)
    assert LAUNCHES == before + Counter(adam=1)
    fields = [f for f in TRAINABLE_FIELDS if f not in frozen]
    bad = _compare(got, want, fields)
    assert not bad, f"differing from the eager chain: {bad}"
    for f in frozen:
        assert getattr(got[0], f) is getattr(p, f)
        assert got[1].m[f] is state.m[f] and got[1].v[f] is state.v[f]
    if case == "nonfinite":
        dead = ~p.alive
        assert torch.equal(got[0].xyz[dead], p.xyz[dead])
        assert not bool(torch.isfinite(got[1].m["xyz"][dead]).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1_660_000, 2_960_000], ids=["barn", "garden"])
def test_kernel_matches_eager_at_scene_size(n, cuda, monkeypatch):
    """The geometry step's six fields (no features) at barn's and garden's
    gaussian counts, bit for bit."""
    from instascene_tpu_torch.models.optimizer import GEOMETRY_FIELDS
    p = _model(n, cuda, seed=n, e=0)
    grads = _grads(p)
    state = _state(p, 500)
    want = _run(p, grads, state, GEOMETRY_LRS, (), False, monkeypatch)
    got = _run(p, grads, state, GEOMETRY_LRS, (), True, monkeypatch)
    assert not _compare(got, want, GEOMETRY_FIELDS)


@pytest.mark.cuda
def test_bias_correction_every_step(cuda, monkeypatch):
    """The kernel's 1 − b^count against the eager chain's at every count
    from 1 to 30,000: one field of 1,024 floats with p = 0 and lr = 1, so
    the new p is −(m'/c1) / (sqrt(v'/c2) + eps) and a c1 or c2 one bit
    off changes it."""
    from instascene_tpu_torch.models import optimizer as opt
    p = _model(256, cuda, seed=5, e=0)
    p = p.replace(rotation=torch.zeros_like(p.rotation),
                  alive=torch.ones_like(p.alive))
    frozen = tuple(f for f in opt.GEOMETRY_FIELDS if f != "rotation")
    lrs = {f: 1.0 for f in opt.GEOMETRY_FIELDS}
    grads = _grads(p)
    state = _state(p, 1)
    bad = []
    for count in range(1, 30_001):
        state.count = count - 1
        with monkeypatch.context() as mp:
            mp.setattr(opt, "_on_card", lambda t: False)
            want = opt.adam_step(p, grads, state, lrs, frozen_fields=frozen)
        got = opt.adam_step(p, grads, state, lrs, frozen_fields=frozen)
        if not torch.equal(got[0].rotation, want[0].rotation):
            bad.append(count)
            if len(bad) == 10:
                break
    assert not bad, f"counts whose update differs: {bad}"
