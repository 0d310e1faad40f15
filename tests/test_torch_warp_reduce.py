"""The warp reduction of K2's backward walk (csrc/blend_walk.cuh::
scatter_reduce and scatter_owners), modelled in numpy lane by lane: the
column list each lane keeps per level, the shuffle each pair takes, and
which lane stores column k of the warp's partial row. On seeded float32
lanes, half of them zero, every column must come out bit for bit the
per-column butterfly's sum, on exactly the one lane that stores it.

Runs on the CPU (no CUDA): it checks the schedule, not the kernel; the
kernel's rows are held against their plain version on the card by
tests/test_torch_kernel.py and chip_smoke.py."""

import numpy as np
import pytest

LANES = 32
LEVELS = (16, 8, 4, 2, 1)


def butterfly(v):
    """v [32, NC] float32 → [32, NC]: each column reduced by its own
    butterfly, c[k] += shfl_xor(c[k], off) for off = 16 .. 1."""
    v = v.copy()
    lanes = np.arange(LANES)
    for off in LEVELS:
        v = (v + v[lanes ^ off]).astype(np.float32)
    return v


def scatter(v):
    """The kernel's reduce-scatter on v [32, NC] float32 → (c, col, own,
    shuffles): per lane the values of its final positions, the column each
    position holds, whether the lane stores it, and the shuffles taken.

    Mirrors scatter_reduce / scatter_owners: a level splits a lane's list
    of n positions into H = n // 2 pairs (position i with H + i); the lane
    keeps position i where lane & off is 0 and H + i otherwise, sends the
    other, and adds the partner's value to the one it keeps; an odd last
    position moves to position H on both halves (one shuffle of its own),
    and only the half with the bit clear keeps storing it."""
    nc = v.shape[1]
    c = [list(v[lane]) for lane in range(LANES)]
    col = [list(range(nc)) for _ in range(LANES)]
    own = [[True] * nc for _ in range(LANES)]
    n, shuffles = nc, 0
    for off in LEVELS:
        h, odd = n // 2, n % 2
        shuffles += h + odd
        send = [[(c[L][i] if L & off else c[L][h + i]) for i in range(h)]
                for L in range(LANES)]
        odd_v = [c[L][n - 1] for L in range(LANES)] if odd else None
        nxt_c, nxt_col, nxt_own = [], [], []
        for L in range(LANES):
            up = bool(L & off)
            partner = L ^ off
            kc, kcol, kown = [], [], []
            for i in range(h):
                keep = h + i if up else i
                kc.append(np.float32(c[L][keep] + send[partner][i]))
                kcol.append(col[L][keep])
                kown.append(own[L][keep])
            if odd:
                kc.append(np.float32(c[L][n - 1] + odd_v[partner]))
                kcol.append(col[L][n - 1])
                kown.append(own[L][n - 1] and not up)
            nxt_c.append(kc)
            nxt_col.append(kcol)
            nxt_own.append(kown)
        c, col, own = nxt_c, nxt_col, nxt_own
        n = h + odd
    return c, col, own, shuffles


@pytest.mark.parametrize("nc,seed,shuffles",
                         [(1, 11, 5), (3, 12, 6), (16, 13, 16),
                          (21, 14, 23), (37, 15, 39)],
                         ids=["NC1", "NC3", "NC16", "NC21", "NC37"])
def test_reduce_scatter_is_the_butterfly_bit_for_bit(nc, seed, shuffles):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        v = rng.standard_normal((LANES, nc)).astype(np.float32)
        v *= np.float32(10.0) ** rng.integers(-3, 4, size=(LANES, nc))
        v[rng.random((LANES, nc)) < 0.5] = 0.0
        want = butterfly(v)
        # the butterfly's column sums are the same bits on every lane
        assert (want.view(np.uint32) == want[:1].view(np.uint32)).all()
        c, col, own, n_shfl = scatter(v)
        assert n_shfl == shuffles
        writers = {}
        for lane in range(LANES):
            for i, k in enumerate(col[lane]):
                got = np.float32(c[lane][i])
                # every position a lane holds is the butterfly's bits
                assert got.view(np.uint32) == want[lane, k].view(np.uint32)
                if own[lane][i]:
                    assert k not in writers, (k, writers[k], lane)
                    writers[k] = lane
        assert sorted(writers) == list(range(nc))
