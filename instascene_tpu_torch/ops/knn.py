"""Mean squared distance to the 3 nearest neighbours, for initial surfel
scales.

Port of instascene_tpu/ops/knn.py:22-66 (`mean_dist2_knn3`): exact brute
force, |q|² + |p|² − 2 q·p distance blocks with the query's own index
excluded, blocked over queries so that a 300k-point cloud never holds more
than one [block, N] distance block (a dense 300k × 300k matrix would be
360 GB). A plain matrix product and top-k, as the JAX package leaves them
to XLA; the product runs in full float32 (PyTorch's default matmul
precision, no TF32).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_BIG = torch.finfo(torch.float32).max / 4   # an absent neighbour, as in JAX


def mean_dist2_knn3(points: torch.Tensor, block: int = 1024,
                    rows: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """points [N,3] → [N] mean squared distance to the 3 nearest other
    points; with rows = (lo, hi), the [hi - lo] of the queries lo..hi-1
    against all N points (parallel/sharding.py's shard)."""
    pts = points.to(torch.float32)
    n = pts.shape[0]
    lo, hi = rows if rows is not None else (0, n)
    kk = torch.sum(pts * pts, dim=-1)
    out = torch.empty(hi - lo, dtype=torch.float32, device=pts.device)
    k = min(3, n)
    for q0 in range(lo, hi, block):
        q1 = min(q0 + block, hi)
        q = pts[q0:q1]
        d2 = kk[q0:q1, None] + kk[None, :] - 2.0 * (q @ pts.T)
        d2 = torch.clamp(d2, min=0.0)
        r = torch.arange(q.shape[0], device=pts.device)
        d2[r, r + q0] = _BIG
        best = torch.topk(d2, k, dim=1, largest=False).values
        if k < 3:
            best = torch.cat([best, torch.full((q.shape[0], 3 - k), _BIG,
                                               device=pts.device)], 1)
        out[q0 - lo:q1 - lo] = torch.mean(best, dim=1)
    return out
