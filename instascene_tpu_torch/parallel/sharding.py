"""The 3-NN initial-scale distance with its queries split over the ranks.

Port of instascene_tpu/parallel/sharding.py:17-48
(`sharded_mean_dist2_knn3`): the queries are cut into equal shards (the
last padded), every rank holds all the points as keys, excludes each
query's own index, and the shards are gathered back in order. The JAX
package pads with 1e18 rows and masks them as keys; here a rank's last
shard is short and its result padded instead, which leaves the same
neighbours.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.knn import mean_dist2_knn3
from .launch import all_gather_rows


def sharded_mean_dist2_knn3(points: torch.Tensor, group=None,
                            block: int = 1024) -> torch.Tensor:
    """points [N,3] (the same on every rank) → [N] mean squared distance to
    the 3 nearest other points, on every rank; each rank computes
    ceil(N / world) queries."""
    n = points.shape[0]
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    s = -(-n // world)
    lo, hi = min(rank * s, n), min((rank + 1) * s, n)
    local = mean_dist2_knn3(points, block, rows=(lo, hi))
    local = torch.cat([local, local.new_zeros(s - (hi - lo))])
    return all_gather_rows(local, group)[:n]
