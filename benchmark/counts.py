"""The yardstick: the chip's peaks, and the operations and bytes that the
blend kernels and the eager work around them need, counted from shapes and
from the work that the inputs set.

The blend's counts are a frozen copy of chip_smoke.py at commit e06f678
(`OPS_EVAL`, `OPS_HIT`, `OPS_HIT_MODE` with its extras_only and track
entries, `OPS_BWD_HIT`, `OPS_BWD_HIT_E`, `OPS_BWD_HIT_FULL`,
`OPS_BWD_EXTRAS_HIT`, `SPLAT_COLS`, `k1_bound`, and the byte and operation
counts of `compare_k2` and of its segment sum), counted there from
csrc/blend_fwd.cu and csrc/blend_bwd.cu: an FMA counts as two operations,
exp, a division, a compare or a min/max as one. The per-pixel and
per-slot work (slots evaluated, contributions, slots reduced) comes from
the reference's blend (benchmark/reference/render.py) on the cell's own
inputs.

Every share is taken against NVIDIA's data-sheet peaks of one H100 SXM:
67 TFLOP/s in FP32 outside the tensor cores (an FMA two operations) and
3.35 TB/s of HBM. chip_smoke.py divided by the FP32 instruction rate
(132 SMs x 128 lanes x 1.98 GHz = 33.45e12/s), which holds only while
nvcc keeps every multiply and add apart (--fmad=false); against the FLOP
peak no instruction selection can read over 100 %.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12
HBM_BPS = 3.35e12

OPS_EVAL = 41
OPS_HIT = 10
OPS_HIT_MODE = {"full": 25, "no_dist": 10, "viewer": 0, "extras_only": -6,
                "track": 26}
OPS_BWD_HIT = 54
OPS_BWD_HIT_E = 3
OPS_BWD_HIT_FULL = 24
OPS_BWD_EXTRAS_HIT = 3
SPLAT_COLS = 15
PACK_COLS = 21

# Eager work around the kernels, per element, counted by hand from the
# program's source at e06f678 (forward; a backward counts twice its
# forward). They count the arithmetic the formulas need, not the
# instructions PyTorch issues.
# ops/preprocess.py:133-260: the quaternion and rotation (42), T's three
# rows (48), the view normal and its sign (24), two conic boxes (94), the
# extents, radius and the opacity-aware rect (92)
OPS_PREPROCESS = 300
# ops/sh.py:41-76, :83-89: the direction (12), the degree-3 basis (40),
# 16 coefficients x 3 channels as FMAs (96), the offset and clamp (6)
OPS_SH3 = 154
# ops/blend_visits.py:83-105: three cross products of fmas (27)
OPS_PACK = 27
# losses.py:38-96 per pixel: L1 on 3 channels (9); SSIM's five statistics
# of 3 channels blurred by two 11-tap passes (15 x 44 = 660) and its map
# (3 x 12); pipelines/train.py:66-90, :121-146 and ops/depth_utils.py:
# 33-48 per pixel: the rendered normal (15), the surface depth and
# normal from central differences (40), the normal term (6)
OPS_GEOMETRY_LOSS_PX = 766
# models/optimizer.py:70-99 per parameter element: both moments (7), the
# bias-corrected update (6)
OPS_ADAM = 13
# semantic/contrastive.py:30-76 per drawn sample and cluster: the logits
# (2·E for the dot product, 1 division), their exp and sum (2), the
# one-hot products for counts, means and temperatures (2 + 2·E + 2)
def ops_protonce(batch: int, clusters: int, E: int) -> int:
    return batch * clusters * (4 * E + 7)


def bound(bytes_: float, ops: float) -> dict:
    """The least time for `bytes_` over HBM and `ops` at the FP32 peak, in
    seconds, and which of them binds."""
    tb, to = bytes_ / HBM_BPS, ops / PEAK_FLOPS
    return {"s": max(tb, to), "by": "bytes" if tb >= to else "operations",
            "bytes": bytes_, "ops": ops}


def k1_work(n: int, pairs: int, tiles: int, E: int, mode: str, evals: int,
            hits: int) -> dict:
    """K1 (chip_smoke.k1_bound): the packed table read once (extras_only:
    only the splat and feature columns), the pair list and tile ranges, the
    outputs written once (extras_only: final T, the E features and
    n_contrib); the splat and mask per evaluated (slot, pixel), the weight
    and channels per contribution."""
    cols, rows, irows = ((SPLAT_COLS + E, 1 + E, 1) if mode == "extras_only"
                         else (PACK_COLS + E, 12 + E, 2))
    bytes_ = (n * cols * 4 + pairs * 4 + 2 * tiles * 4
              + tiles * (rows + irows) * 256 * 4)
    ops = evals * OPS_EVAL + hits * (OPS_HIT + 2 * E + OPS_HIT_MODE[mode])
    return bound(bytes_, ops)


def k2_work(n: int, pairs: int, tiles: int, E: int, mode: str, evals: int,
            hits: int, slots: int) -> dict:
    """K2 (chip_smoke.compare_k2): extras_only reads the splat columns and
    per pixel the E feature cotangents, final T and n_contrib; the other
    modes all of the table, the cotangent, the saved rows and iout; each
    writes one row per slot. Operations: the splat re-evaluated up to each
    pixel's n_contrib, the gradient terms per contribution, and the
    additions that sum a slot's column over its contributing pixels
    (hits − slots per column)."""
    D = E if mode == "extras_only" else PACK_COLS + E
    cols, rows = ((SPLAT_COLS, E + 2) if mode == "extras_only"
                  else (PACK_COLS + E, 12 + E + 3 + 2))
    bytes_ = (n * cols * 4 + pairs * 4 + 2 * tiles * 4
              + tiles * rows * 256 * 4 + pairs * D * 4)
    per_hit = (OPS_BWD_EXTRAS_HIT + E if mode == "extras_only" else
               OPS_BWD_HIT + OPS_BWD_HIT_E * E
               + (OPS_BWD_HIT_FULL if mode == "full" else 0))
    ops = evals * OPS_EVAL + hits * per_hit + max(hits - slots, 0) * D
    return bound(bytes_, ops)


def segment_sum_work(n: int, pairs: int, D: int) -> dict:
    """The per-gaussian segment sum: the slots' rows and their gaussian
    ids read, the per-gaussian rows written; one addition per slot and
    column."""
    return bound(pairs * D * 4 + pairs * 4 + (n + 1) * 4 + n * D * 4,
                 pairs * D)


def eager_render_ops(n: int, sh: bool = True) -> int:
    """Preprocess, SH colour (degree 3) and pack of n gaussians."""
    return n * (OPS_PREPROCESS + (OPS_SH3 if sh else 0) + OPS_PACK)
