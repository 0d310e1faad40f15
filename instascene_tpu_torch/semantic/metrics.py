"""Instance segmentation quality: mean IoU of predicted instances against
ground truth under an optimal one-to-one matching.

Port of instascene_tpu/semantic/metrics.py (`instance_miou`), host numpy
with scipy's linear_sum_assignment.
"""

from __future__ import annotations

import numpy as np


def instance_miou(pred_labels: np.ndarray, true_labels: np.ndarray,
                  ignore_label: int = 0) -> float:
    """Mean IoU over ground-truth instances, each matched to at most one
    predicted instance by the Hungarian method.

    pred_labels/true_labels: an integer label per element (gaussian or
    pixel); `ignore_label` takes part on neither side. An unmatched
    ground-truth instance counts IoU 0, so both under- and
    over-segmentation lower the score.
    """
    pred = np.asarray(pred_labels).reshape(-1)
    true = np.asarray(true_labels).reshape(-1)
    if pred.shape != true.shape:
        raise ValueError(f"shape mismatch {pred.shape} vs {true.shape}")
    t_ids = np.unique(true[true != ignore_label])
    p_ids = np.unique(pred[pred != ignore_label])
    if len(t_ids) == 0:
        return 1.0 if len(p_ids) == 0 else 0.0
    if len(p_ids) == 0:
        return 0.0
    iou = np.zeros((len(t_ids), len(p_ids)), np.float64)
    for i, t in enumerate(t_ids):
        tm = true == t
        ts = tm.sum()
        for j, q in enumerate(p_ids):
            pm = pred == q
            inter = np.count_nonzero(tm & pm)
            if inter:
                iou[i, j] = inter / (ts + pm.sum() - inter)
    from scipy.optimize import linear_sum_assignment
    ri, ci = linear_sum_assignment(-iou)
    return float(iou[ri, ci].sum() / len(t_ids))
