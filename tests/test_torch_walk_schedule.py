"""The forward walk's schedule (csrc/blend_walk.cuh::blend_fwd_kernel),
modelled on the CPU:

* the order the wrappers hand K1, K3, K6 and K7
  (ops/blend_visits.walk_order over range_lengths, or K7's tile counts):
  a permutation of the rows, longest range first, ties in row order;
* the look-ahead walk: per batch of rows, U consecutive slots (FWD_U, FWD_U0)
  evaluated (the clip_rect gate and the splat, ops/blend_visits._splat),
  then the recurrence applied to them in slot order, a latch dropping the
  rest of its group — in numpy float32, one pixel at a time, bit for bit
  the one-slot loop, and equal to the plain version (blend_fwd_reference)
  in every output it computes with the same arithmetic.

* K5's walk (csrc/blend_sparse.cu::sparse_fwd_kernel), the same schedule
  over a tile's drawn pixels: its tiles in walk_order, empty slots
  latched from the start, the block leaving at a batch boundary once every
  slot has latched, FWD_U slots evaluated ahead of the recurrence — bit for
  bit the one-slot loop and equal to blend_sparse_fwd_reference.

No CUDA and no JAX: the kernel itself is held against the plain version on
the card (tests/test_torch_kernel.py, chip_smoke.py), and the plain
version against the JAX package by tests/test_torch_blend.py."""

import numpy as np
import pytest
import torch

from test_torch_kernel import GRID_X, LATE_HEAVY, _port_binned

F = np.float32
BATCH = 128        # rows per buffer (csrc/blend_walk.cuh FWD_BATCH)
E = 4


def _check_order(lengths, order):
    n = lengths.shape[0]
    L = lengths.numpy().astype(np.int64)
    got = order.numpy()
    assert order.dtype == torch.int64 and order.device == lengths.device
    assert sorted(got.tolist()) == list(range(n))           # a permutation
    assert (np.diff(L[got]) <= 0).all()                     # longest first
    tie = np.diff(L[got]) == 0
    assert (np.diff(got)[tie] > 0).all()                    # ties in order
    assert (got == np.argsort(-L, kind="stable")).all()


@pytest.mark.parametrize("case", ["ranges", "tile_ids", "tiles_per_view",
                                  "padded_count"])
def test_walk_order_is_longest_first_and_stable(case):
    from instascene_tpu_torch.ops import blend_visits as bv
    from instascene_tpu_torch.ops.binning import (merge_binnings,
                                                  padded_layout)
    rng = np.random.default_rng(5)
    if case == "ranges":
        # many ties: 2,000 ranges of 0-5 pairs
        ends = np.cumsum(rng.integers(0, 6, 2000)).astype(np.int32)
        start = torch.as_tensor(np.concatenate([[0], ends[:-1]]).astype(
            np.int32))
        end = torch.as_tensor(ends)
        lengths = bv.range_lengths(start, end)
        tile_ids = None
    else:
        flat, b = _port_binned(E, boost=12.0, shift=LATE_HEAVY)
        start, end = b.tile_start, b.tile_end
        tile_ids = None
        if case == "tile_ids":
            tile_ids = torch.as_tensor(rng.permutation(12)[:7].astype(
                np.int32))
            lengths = bv.range_lengths(start, end, tile_ids)
            assert torch.equal(lengths, (end - start)[tile_ids.long()])
        elif case == "tiles_per_view":
            views = [_port_binned(E, boost=12.0, view=v) for v in (1, 2, 3)]
            _, bm, T = merge_binnings(views)
            start, end = bm.tile_start, bm.tile_end
            lengths = bv.range_lengths(start, end)
            assert lengths.shape[0] == 3 * T
        else:
            lengths = padded_layout(b)[1]
    order = bv.walk_order(lengths)
    _check_order(lengths, order)
    if case != "padded_count":
        # the plain versions step their rows in the kernels' order
        plain = bv._walk_order(start, end, GRID_X, tile_ids)
        assert torch.equal(plain[0], order)


def _evaluations(flat, b, t, clip):
    """Tile t's slots at its 256 pixels by the plain version's _splat:
    alpha, depth along the ray and the mask [n, 256], the clip_rect gate
    [n] and the rows [n, D], as numpy float32."""
    from instascene_tpu_torch.ops import blend_visits as bv
    s, e = int(b.tile_start[t]), int(b.tile_end[t])
    g = flat[b.sorted_gid[s:e].long()][:, :, None]
    pix = torch.arange(256)
    X = ((t % GRID_X) * 16 + pix % 16).float()[None].expand(e - s, 256)
    Y = ((t // GRID_X) * 16 + pix // 16).float()[None].expand(e - s, 256)
    sp = bv._splat(g, X, Y)
    gate = (bv._in_rect(g, torch.full((e - s,), t), 0, GRID_X)[:, 0]
            if clip else torch.ones(e - s, dtype=torch.bool))
    return (sp["alpha"].numpy(), sp["depth_ray"].numpy(), sp["m"].numpy(),
            gate.numpy(), g[:, :, 0].numpy())


def _walk(U, alpha, depth, m, gate, rows, events):
    """One pixel's forward walk in `full` mode, as the kernel schedules it:
    per batch of BATCH rows, groups of U slots evaluated (gate and mask,
    alpha, depth), then the recurrence in slot order; a latch ends the
    walk and drops the rest of its group. Returns the pixel's outputs."""
    o = dict(T=F(1), col=np.zeros(3, F), nrm=np.zeros(3, F), dep=F(0),
             dist=F(0), M1=F(0), M2=F(0), med=F(0), feat=np.zeros(E, F),
             last=0, med_slot=0)
    md_scale, near = F(100.0 / (100.0 - 0.2)), F(0.2)

    def apply(j):
        """The recurrence of slot j; True where the pixel latches done."""
        a, T, g = alpha[j], o["T"], rows[j]
        test_T = T * (F(1) - a)
        if test_T < F(1e-4):
            events["dropped"] += 1
            return True
        w = a * T
        o["col"] = o["col"] + w * g[18:21]
        o["feat"] = o["feat"] + w * g[21:21 + E]
        o["nrm"] = o["nrm"] + w * g[14:17]
        o["dep"] = o["dep"] + w * depth[j]
        md = md_scale * (F(1) - near / depth[j])
        A = F(1) - T
        o["dist"] = o["dist"] + w * (md * md * A + o["M2"]
                                     - F(2) * md * o["M1"])
        o["M1"] = o["M1"] + md * w
        o["M2"] = o["M2"] + md * md * w
        if T > F(0.5):
            o["med"], o["med_slot"] = depth[j], j + 1
        o["last"] = j + 1
        o["T"] = test_T
        return False

    def evaluate(j):
        if not gate[j]:
            events["gated"] += bool(m[j])
            return False
        return bool(m[j])

    n = alpha.shape[0]
    for base in range(0, n, BATCH):
        nb = min(BATCH, n - base)
        j = 0
        while j + U <= nb:
            mk = [evaluate(base + j + u) for u in range(U)]   # ahead
            for u in range(U):
                if mk[u] and apply(base + j + u):
                    events["latch_inside"] += u < U - 1
                    return o
            j += U
        for j in range(j, nb):
            if evaluate(base + j) and apply(base + j):
                return o
    return o


@pytest.mark.parametrize("U,clip", [(2, False), (3, False), (4, False),
                                    (8, False), (4, True)],
                         ids=["U2", "U3", "U4", "U8", "U4-clip_rect"])
def test_lookahead_walk_is_the_one_slot_loop_bit_for_bit(U, clip):
    from instascene_tpu_torch.ops import blend_visits as bv
    flat, b = _port_binned(E, boost=12.0, shift=LATE_HEAVY,
                           dilate=int(clip), clip_rect=clip)
    out, iout = bv.blend_fwd_reference(flat, b.sorted_gid, b.tile_start,
                                       b.tile_end, GRID_X, E,
                                       clip_rect=clip)
    lengths = (b.tile_end - b.tile_start).numpy()
    events = dict(dropped=0, latch_inside=0, gated=0)
    median_early = 0
    for t in np.argsort(-lengths, kind="stable")[:3]:    # the heaviest
        alpha, depth, m, gate, rows = _evaluations(flat, b, int(t), clip)
        for p in range(0, 256, 3):
            ev = (alpha[:, p], depth[:, p], m[:, p], gate, rows)
            got = _walk(U, *ev, events)
            one = _walk(1, *ev, dict(dropped=0, latch_inside=0, gated=0))
            for k, v in got.items():
                assert np.asarray(v).tobytes() == \
                    np.asarray(one[k]).tobytes(), k
            # the plain version, where it rounds as the kernel does (its
            # distortion and m1/m2 take NEAR_N / depth as a reciprocal)
            r = out[t, :, p].numpy()
            assert (got["col"] == r[0:3]).all() and got["T"] == r[9]
            assert (got["nrm"] == r[4:7]).all() and got["dep"] == r[3]
            assert got["med"] == r[7] and (got["feat"] == r[10:10 + E]).all()
            assert (got["last"], got["med_slot"]) == tuple(iout[t, :, p])
            median_early += 0 < got["med_slot"] < got["last"]
    # the cases the schedule must keep: a latch inside a group of U, the
    # dropped contribution of every latch, the median slot before the
    # last contribution, and (clip_rect) slots the gate turns away
    assert events["latch_inside"] > 0 and events["dropped"] > 0
    assert median_early > 0
    assert events["gated"] > 0 if clip else events["gated"] == 0


def _sparse_block(U, alpha, m, rows, live, events):
    """K5's walk of one tile, as the kernel schedules it: one thread per
    slot, its evaluations alpha, m [n, S]; empty slots (live False) start
    latched; per batch of BATCH rows the block leaves once every slot has
    latched, and each slot still walking takes the batch in groups of U
    evaluated slots, then the recurrence in slot order (a latch drops the
    rest of its group). Returns final T [S], features [S, E] and
    n_contrib [S]."""
    n, S = alpha.shape
    T = np.ones(S, F)
    feat = np.zeros((S, E), F)
    last = np.zeros(S, np.int64)
    done = ~live

    def apply(i, j):
        """The recurrence of slot i at pair j; True where it latches."""
        test_T = T[i] * (F(1) - alpha[j, i])
        if test_T < F(1e-4):
            events["dropped"] += 1
            return True
        w = alpha[j, i] * T[i]
        feat[i] = feat[i] + w * rows[j, 21:21 + E]
        last[i] = j + 1
        T[i] = test_T
        return False

    for base in range(0, n, BATCH):
        if done.all():                 # __syncthreads_count(done) == S
            events["left"] += 1
            break
        nb = min(BATCH, n - base)
        for i in np.nonzero(~done)[0]:
            j = 0
            while j + U <= nb and not done[i]:
                mk = [bool(m[base + j + u, i]) for u in range(U)]   # ahead
                for u in range(U):
                    if mk[u] and apply(i, base + j + u):
                        done[i] = True
                        events["latch_inside"] += u < U - 1
                        break
                j += U
            while j < nb and not done[i]:
                if m[base + j, i] and apply(i, base + j):
                    done[i] = True
                j += 1
    return T, feat, last


@pytest.mark.parametrize("U", [1, 2, 4], ids=["U1", "U2", "U4"])
def test_k5_walk_is_the_one_slot_loop_bit_for_bit(U):
    """K5's schedule in numpy float32 on a scene whose heaviest tiles come
    last in raster order, ~300 draws (duplicates, and one tile left
    without a draw): the tiles in walk_order (longest first), every slot's
    features, final T and n_contrib bit for bit the one-slot loop's and the
    plain version's (blend_sparse_fwd_reference); blocks leave before the
    end of their range once all their slots have latched, a block without
    a draw at once, and latches fall inside groups."""
    from instascene_tpu_torch.ops import blend_sparse as bs
    from instascene_tpu_torch.ops import blend_visits as bv
    flat, b = _port_binned(E, boost=12.0, shift=LATE_HEAVY)
    nt = b.tile_start.shape[0]
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 64 * 48, 300)
    idx[5:9] = idx[0]
    tile = (idx // 64 // 16) * GRID_X + (idx % 64) // 16
    idx = idx[tile != 1]                       # tile 1 draws nothing
    S = bs.pick_sparse_s(300, nt)
    spix = bs.spix_from_idx(torch.as_tensor(idx), 64, 48, 16, S)[0]
    feat_r, aux_r = bs.blend_sparse_fwd_reference(
        flat, b.sorted_gid, b.tile_start, b.tile_end, spix, GRID_X, E)
    order = bv.walk_order(bv.range_lengths(b.tile_start, b.tile_end))
    _check_order(b.tile_end - b.tile_start, order)
    events = dict(dropped=0, latch_inside=0, left=0)
    lengths = (b.tile_end - b.tile_start).numpy()
    for t in order.tolist():                   # block b walks order[b]
        s, e = int(b.tile_start[t]), int(b.tile_end[t])
        sp = spix[t].long()
        g = flat[b.sorted_gid[s:e].long()][:, :, None]
        pix = sp.clamp(min=0)
        X = ((t % GRID_X) * 16 + pix % 16).float()[None].expand(e - s, S)
        Y = ((t // GRID_X) * 16 + pix // 16).float()[None].expand(e - s, S)
        ev = bv._splat(g, X, Y)
        args = (ev["alpha"].numpy(), ev["m"].numpy(), g[:, :, 0].numpy(),
                (sp >= 0).numpy())
        left = events["left"]
        got = _sparse_block(U, *args, events)
        one = _sparse_block(1, *args, dict(dropped=0, latch_inside=0,
                                           left=0))
        for a, c in zip(got, one):
            assert a.tobytes() == c.tobytes()
        assert got[0].tobytes() == aux_r[t, :, 0].numpy().tobytes()
        assert got[1].tobytes() == feat_r[t].numpy().tobytes()
        assert (got[2] == aux_r[t, :, 1].numpy()).all()
        if t == 1:                             # no draw: leaves at once
            assert not (sp >= 0).any() and events["left"] == left + 1
            assert (got[0] == 1).all() and not got[1].any()
    assert lengths[1] > 0 and events["dropped"] > 0
    # blocks that leave before their range ends, besides the empty one
    assert events["left"] > 1
    if U > 1:
        assert events["latch_inside"] > 0
