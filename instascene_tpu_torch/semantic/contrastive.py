"""ProtoNCE contrastive loss over sampled pixels or points, and the samplers
that draw them.

Port of instascene_tpu/semantic/contrastive.py:30-121 (`contrastive_loss`,
`sample_valid_pixels`, `valid_ids_pack`, `sample_from_ids`,
`sample_from_csum`), reference utils/contrastive_utils.py:18-73. Clusters
live in a fixed [0, max_labels) id space with presence masks, as in the JAX
package; absent clusters leave the softmax denominator. Semantics:
  * features L2-normalised with a detached norm;
  * prototypes u_k = per-cluster mean of the normalised features, or the
    predefined class anchors when given;
  * per-cluster temperature φ_k = clip(10 · mean‖f − u_k‖ / log(n_k + 1000),
    0.5, 1.0), detached;
  * loss = −Σ_i log(exp(f_i·u_{m_i}/φ_{m_i}) / Σ_k exp(f_i·u_k/φ_k));
  * label 0 dropped unless consider_negative (labels then shift by −1, so
    cluster ids stay aligned with predefined anchors).

The samplers draw from a `torch.Generator` (JAX PRNG keys cannot be
reproduced in torch: tests inject JAX's draws instead).
"""

from __future__ import annotations

from typing import Optional

import torch


def contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                     max_labels: int, predef_u: Optional[torch.Tensor] = None,
                     valid: Optional[torch.Tensor] = None,
                     consider_negative: bool = False,
                     temp_lambda: float = 1000.0) -> torch.Tensor:
    """features [B, D], labels [B] raw mask ids, predef_u [K >= max_labels,
    D] optional anchors, valid [B] optional extra mask → scalar loss."""
    labels = labels.to(torch.int64)
    ok = labels >= 0
    if not consider_negative:
        ok = ok & (labels > 0)
        labels = labels - 1
    if valid is not None:
        ok = ok & valid
    labels = torch.clamp(labels, 0, max_labels - 1)
    seg = torch.where(ok, labels, max_labels)   # invalid → an extra bin

    norm = torch.linalg.norm(features, dim=-1, keepdim=True) + 1e-9
    feats = features / norm.detach()
    featm = torch.where(ok[:, None], feats, 0.0)
    onehot = (seg[None, :] == torch.arange(max_labels, device=seg.device
                                           )[:, None]).to(torch.float32)
    okf = ok.to(torch.float32)
    cnt = onehot @ okf                                   # [K]
    present = cnt > 0
    cnt_safe = torch.clamp(cnt, min=1.0)
    if predef_u is not None:
        u = predef_u[:max_labels]
    else:
        u = (onehot @ featm) / cnt_safe[:, None]
    diff_norm = torch.linalg.norm(feats - u[labels], dim=-1)
    phi_sum = onehot @ torch.where(ok, diff_norm, 0.0)
    phi = phi_sum / (cnt_safe * torch.log(cnt_safe + temp_lambda))
    phi = torch.clamp(phi * 10.0, 0.5, 1.0).detach()

    logits = (feats @ u.T) / phi[None, :]
    expd = torch.where(present[None, :], torch.exp(logits), 0.0)
    denom = torch.sum(expd, dim=1)
    own = torch.gather(expd, 1, labels[:, None])[:, 0]
    log_p = torch.log(torch.clamp(own, min=1e-30) / (denom + 1e-9))
    return -torch.sum(torch.where(ok, log_p, 0.0))


def valid_ids_pack(valid_flat: torch.Tensor) -> torch.Tensor:
    """[M] bool → [M+1] int32 sampler pack: the valid indices compacted to
    the front in ascending order, last element the number of valid ones."""
    order = torch.argsort((~valid_flat).to(torch.int8), stable=True)
    nv = valid_flat.sum().reshape(1)
    return torch.cat([order, nv]).to(torch.int32)


def sample_from_ids(generator: torch.Generator, pack: torch.Tensor,
                    batch: int, n_valid: int):
    """`batch` valid indices drawn uniformly, with replacement, from a
    valid_ids_pack whose valid count n_valid the caller holds on the host
    (the JAX version reads it from the pack on the device). Returns
    (idx [batch] int64, any_valid)."""
    r = torch.randint(0, max(n_valid, 1), (batch,), generator=generator,
                      device=pack.device)
    return pack[r].to(torch.int64), n_valid > 0


def sample_from_csum(generator: torch.Generator, csum: torch.Tensor,
                     batch: int):
    """sample_valid_pixels given the validity prefix sum: the r-th valid
    element by binary search. Returns (idx [batch] int64, any_valid)."""
    n_valid = int(csum[-1])
    r = torch.randint(0, max(n_valid, 1), (batch,), generator=generator,
                      device=csum.device)
    idx = torch.searchsorted(csum, r, right=True)
    return torch.clamp(idx, max=csum.shape[0] - 1), n_valid > 0


def sample_valid_pixels(generator: torch.Generator, valid_flat: torch.Tensor,
                        batch: int):
    """Uniform sample (with replacement) of `batch` indices among the True
    entries of valid_flat. Returns (idx [batch] int64, any_valid)."""
    return sample_from_csum(generator,
                            torch.cumsum(valid_flat.to(torch.int64), 0), batch)
