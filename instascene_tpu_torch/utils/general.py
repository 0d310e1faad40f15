"""General helpers: the logit, the exponential learning-rate schedule,
quaternion rotations.

Port of instascene_tpu/utils/general.py:16-77 (`inverse_sigmoid`,
`get_expon_lr_func`, `build_rotation`).
"""

from __future__ import annotations

import numpy as np
import torch


def inverse_sigmoid(x):
    """logit(x) for a numpy array or a scalar."""
    return np.log(np.asarray(x) / (1 - np.asarray(x)))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
                      max_steps=1000000):
    """Log-linear interpolated LR with an optional delayed cosine warm-up:
    0 when step < 0 or both rates are 0; progress clamped to [0, 1]."""

    def helper(step):
        if step < 0 or (lr_init == 0.0 and lr_final == 0.0):
            return 0.0
        if lr_delay_steps > 0:
            delay_rate = lr_delay_mult + (1 - lr_delay_mult) * np.sin(
                0.5 * np.pi * np.clip(step / lr_delay_steps, 0, 1))
        else:
            delay_rate = 1.0
        t = np.clip(step / max_steps, 0, 1)
        log_lerp = np.exp(np.log(lr_init) * (1 - t) + np.log(lr_final) * t)
        return delay_rate * log_lerp

    return helper


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] quaternion (w, x, y, z), normalized first → [..., 3, 3]."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-12)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y),
        2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x),
        2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return R.reshape(q.shape[:-1] + (3, 3))
