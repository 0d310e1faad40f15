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


def contributions(w, gext):
    """A warp's column terms [32, 16]: w · gext where a lane contributes
    (w > 0), else the kernel's +0."""
    return np.where(w[:, None] > 0, w[:, None] * gext,
                    np.float32(0)).astype(np.float32)


def k6_rows(w, gext, G, nthreads):
    """K6's reduction of a batch (csrc/blend_sparse.cu::sparse_bwd_kernel
    at E = 16), modelled: per pair j (back to front) each warp's lanes hold
    c = w · gext (+0 where a lane does not contribute), the warp reduces
    them by scatter() and each column's owner writes it to the partials
    [2][G][warps][16] of the pair's group (a warp without a contribution
    writes its zeros unreduced); at j % G == 0 every thread sums each
    (pair, column)'s warp partials in warp order and stores the group's
    rows, index k = r · 16 + col for k = thread, thread + nthreads, ...
    Returns (rows [nb, 16], the store indices in issue order, the
    shuffles of one warp's reduction)."""
    nb, nw = w.shape[:2]
    part = np.zeros((2, G, nw, 16), np.float32)
    rows = np.full((nb, 16), np.nan, np.float32)
    stores, pbuf, n_shfl = [], 0, 0
    for j in range(nb - 1, -1, -1):
        jj = j % G
        for wp in range(nw):
            c = contributions(w[j, wp], gext[wp])
            cc, col, own, n_shfl = scatter(c)
            any_ = bool(w[j, wp].any())
            for lane in range(LANES):
                for i, k in enumerate(col[lane]):
                    if own[lane][i]:
                        part[pbuf, jj, wp, k] = cc[lane][i] if any_ else 0.0
        if jj == 0:
            cnt = min(G, nb - j)
            issued = []
            for thread in range(nthreads):
                for k in range(thread, cnt * 16, nthreads):
                    r, col = divmod(k, 16)
                    acc = part[pbuf, r, 0, col]
                    for wp in range(1, nw):
                        acc = np.float32(acc + part[pbuf, r, wp, col])
                    rows[j + r, col] = acc
                    issued.append((k // nthreads, thread, (j + r) * 16 + col))
            # the threads issue in lockstep, k = thread + nthreads · step
            stores += [a for _, _, a in sorted(issued)]
            pbuf ^= 1
    return rows, stores, n_shfl


@pytest.mark.parametrize("S,nb,seed", [(48, 13, 21), (48, 128, 22),
                                       (96, 37, 23), (128, 8, 24)],
                         ids=["S48-nb13", "S48-nb128", "S96-nb37",
                              "S128-nb8"])
def test_k6_grouped_reduce_scatter_is_the_per_column_butterfly(S, nb, seed):
    """K6 at E = 16 (S sampled slots per tile, threads S rounded up to a
    warp, a batch of nb pairs, 8 pairs per barrier): every stored row is
    bit for bit the old per-pair reduction — 16 butterflies per warp,
    lane 0's sums, the warps added in order — each (pair, column) stored
    once, the group's rows in the output's order, 16 shuffles per warp per
    pair instead of 80."""
    rng = np.random.default_rng(seed)
    nthreads = (S + 31) // 32 * 32
    nw = nthreads // 32
    w = rng.random((nb, nw, LANES)).astype(np.float32)
    w[rng.random(w.shape) < 0.6] = 0.0              # lanes not contributing
    w[:, :, :][rng.random((nb, nw)) < 0.2] = 0.0    # warps without any
    w.reshape(nb, -1)[:, S:] = 0.0                  # threads past S: empty
    gext = rng.standard_normal((nw, LANES, 16)).astype(np.float32)
    gext.reshape(-1, 16)[S:] = 0.0
    rows, stores, n_shfl = k6_rows(w, gext, 8, nthreads)
    want = np.zeros((nb, 16), np.float32)
    for j in range(nb):
        acc = None
        for wp in range(nw):
            c = contributions(w[j, wp], gext[wp])
            lane0 = butterfly(c)[0] if w[j, wp].any() else c[0]
            acc = lane0 if acc is None else (acc + lane0).astype(np.float32)
        want[j] = acc
    assert rows.view(np.uint32).tobytes() == want.view(np.uint32).tobytes()
    assert n_shfl == 16
    assert sorted(stores) == list(range(nb * 16))    # each once
    # a group's rows go out as one contiguous, increasing stretch
    G, groups, i = 8, [], 0
    for j in range(nb - 1, -1, -1):
        if j % G == 0:
            cnt = min(G, nb - j)
            groups.append(stores[i:i + cnt * 16])
            assert groups[-1] == list(range(j * 16, (j + cnt) * 16))
            i += cnt * 16
