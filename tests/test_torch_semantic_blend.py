"""K1's extras_only (with and without a sampled-pixel done0 mask) and track
modes and K2's extras_only mode: the port's plain versions against the JAX
TPU kernels (blend_visits_diff, blend_visits_track; Pallas in interpret
mode) on identical packed rows. The CUDA kernels are held against the plain
versions in test_torch_kernel.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_blend import GRID_X, NUM_TILES, TOL
from test_torch_blend_bwd import _inputs, _runs

E = 16
# the slice-1 tolerances: final T 2e-5, features 5e-4 (the JAX suite's
# between its own blends)
T_TOL, F_TOL = 2e-5, 5e-4


def _done0(rng, frac=0.15):
    """[T, 1, 256] int32: 1 (latched) everywhere but ~frac of the pixels."""
    return (rng.random((NUM_TILES, 1, 256)) >= frac).astype(np.int32)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "done0"])
def test_plain_k1_extras_only_matches_tpu_kernel(masked):
    """extras_only: final T and features at the slice-1 tolerances,
    n_contrib exact, every other row (and iout row 1) exact zeros; with
    done0 the sampled pixels equal the unmasked render bit for bit and the
    latched ones are (T = 1, 0, n_contrib 0)."""
    from instascene_tpu.ops.blend_visits import blend_visits_diff
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    flat, bundle, port = _inputs(E)
    d0 = _done0(np.random.default_rng(7)) if masked else None
    jout, jiout = blend_visits_diff(
        flat, bundle, None if d0 is None else jnp.asarray(d0), NUM_TILES,
        16, GRID_X, E, True, True)
    jout, jiout = np.asarray(jout), np.asarray(jiout)
    out, iout = blend_fwd_reference(
        *port, GRID_X, E, extras_only=True,
        done0=None if d0 is None else torch.as_tensor(d0))
    out, iout = out.numpy(), iout.numpy()
    np.testing.assert_array_equal(iout, jiout)
    assert iout[:, 0].max() > 0 and not iout[:, 1].any()
    np.testing.assert_allclose(out[:, 9], jout[:, 9], atol=T_TOL, rtol=0)
    np.testing.assert_allclose(out[:, 10:10 + E], jout[:, 10:10 + E],
                               atol=F_TOL, rtol=0)
    zero = [r for r in range(12 + E) if not 9 <= r < 10 + E]
    assert not out[:, zero].any() and not jout[:, zero].any()
    full, ifull = blend_fwd_reference(*port, GRID_X, E)
    full, ifull = full.numpy(), ifull.numpy()
    if not masked:
        np.testing.assert_array_equal(iout[:, 0], ifull[:, 0])
        np.testing.assert_array_equal(out[:, 9:10 + E], full[:, 9:10 + E])
        return
    s = d0[:, 0] == 0
    np.testing.assert_array_equal(iout[:, 0][s], ifull[:, 0][s])
    for r in range(9, 10 + E):
        np.testing.assert_array_equal(out[:, r][s], full[:, r][s])
    assert (out[:, 9][~s] == 1).all()
    assert not out[:, 10:].transpose(0, 2, 1)[~s].any()
    assert not iout[:, 0][~s].any()


@pytest.mark.parametrize("E_", [0, 16], ids=["E0", "E16"])
def test_plain_k1_track_matches_tpu_kernel(E_):
    """track: contributor ids exactly JAX's, their weights within 1e-6,
    out and iout those of the port's `full` mode (and JAX's at the
    slice-1 tolerances)."""
    from instascene_tpu.ops.blend_visits import blend_visits_track
    from instascene_tpu_torch.ops.blend_visits import blend_fwd_reference
    flat, bundle, port = _inputs(E_)
    jout, jiout, jids, jw = [np.asarray(a) for a in blend_visits_track(
        flat, bundle, NUM_TILES, 16, GRID_X, E_, True)]
    out, iout, ids, w = [a.numpy() for a in blend_fwd_reference(
        *port, GRID_X, E_, track=True)]
    full, ifull = [a.numpy() for a in blend_fwd_reference(*port, GRID_X, E_)]
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_allclose(w, jw, atol=1e-6, rtol=0)
    assert (ids >= 0).sum() > 100 and (ids[:, 1] >= 0).any()
    np.testing.assert_array_equal(out, full)
    np.testing.assert_array_equal(iout, ifull)
    np.testing.assert_array_equal(iout, jiout)
    for name in ("color", "normal", "final_T"):
        rows, tol = TOL[name]
        np.testing.assert_allclose(out[:, rows], jout[:, rows], atol=tol,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "done0"])
def test_plain_k2_extras_only_matches_tpu_kernel(masked):
    """d_flat of a random Σ out·wout through the port's BlendFunction in
    extras_only mode against jax.grad through blend_visits_diff
    (extras_only, interpret mode): zero in the 21 geometry columns, the
    feature columns within relative 3e-3 of their largest |gradient|."""
    from instascene_tpu.ops.blend_visits import blend_visits_diff
    from instascene_tpu_torch.ops.blend_visits import blend
    flat, bundle, port = _inputs(E)
    rng = np.random.default_rng(21)
    wout = rng.normal(size=(NUM_TILES, 12 + E, 256)).astype(np.float32)
    d0 = _done0(rng) if masked else None
    jd0 = None if d0 is None else jnp.asarray(d0)

    def loss(fl):
        out, _ = blend_visits_diff(fl, bundle, jd0, NUM_TILES, 16, GRID_X,
                                   E, True, True)
        return jnp.sum(out * wout)

    jg = np.asarray(jax.grad(loss)(flat))[:-1]
    fl = port[0].clone().requires_grad_(True)
    out, _ = blend(fl, *port[1:], GRID_X, E, _runs(port[1], fl.shape[0]),
                   extras_only=True,
                   done0=None if d0 is None else torch.as_tensor(d0))
    (out * torch.as_tensor(wout)).sum().backward()
    g = fl.grad.numpy()
    assert g.shape == jg.shape and np.isfinite(g).all()
    assert not g[:, :21].any() and not jg[:, :21].any()
    scale = np.abs(jg[:, 21:]).max()
    assert scale > 0
    assert np.abs(g[:, 21:] - jg[:, 21:]).max() <= 3e-3 * scale


def test_extras_only_cpu_wrappers_and_counts():
    """The wrappers take the plain versions for CPU tensors, launch nothing
    and refuse done0 outside extras_only; K2 extras_only gives [pairs, E]
    rows, counts its work from n_contrib, and a pixel done0 latched takes
    no part in them."""
    from instascene_tpu_torch.cuda_build import LAUNCHES
    from instascene_tpu_torch.ops.blend_visits import (
        blend_bwd, blend_bwd_reference, blend_fwd)
    _, _, (flat, gid, start, end) = _inputs(E)
    before = dict(LAUNCHES)
    d0 = torch.as_tensor(_done0(np.random.default_rng(3)))
    out, iout = blend_fwd(flat, gid, start, end, GRID_X, E,
                          extras_only=True, done0=d0)
    with pytest.raises(ValueError, match="extras_only"):
        blend_fwd(flat, gid, start, end, GRID_X, E, done0=d0)
    with pytest.raises(ValueError, match="separate modes"):
        blend_fwd(flat, gid, start, end, GRID_X, E, extras_only=True,
                  track=True)
    saved = torch.stack([out[:, 9], out[:, 26], out[:, 27]], 1)
    gout = torch.as_tensor(np.random.default_rng(4).normal(
        size=out.shape).astype(np.float32))
    d = blend_bwd(flat, gid, start, end, GRID_X, E, gout, saved, iout,
                  extras_only=True)
    ref, (evals, hits, slots) = blend_bwd_reference(
        flat, gid, start, end, GRID_X, E, gout, saved, iout,
        extras_only=True, count_work=True)
    assert LAUNCHES == before
    assert d.shape == (gid.shape[0], E) and torch.equal(d, ref)
    assert 0 < hits <= evals == int(iout[:, 0].sum()) and slots > 0
    # masking the gradient of the latched pixels changes nothing
    g2 = gout.clone()
    g2[d0.expand_as(g2) != 0] = 0.0
    d2 = blend_bwd(flat, gid, start, end, GRID_X, E, g2, saved, iout,
                   extras_only=True)
    torch.testing.assert_close(d2, d, atol=1e-6, rtol=0)
