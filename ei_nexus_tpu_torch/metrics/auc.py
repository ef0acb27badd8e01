"""Error-recall AUC: the trapezoid integral of the recall curve up to each
threshold, normalised by the threshold. A copy of
`ei_nexus_tpu/metrics/auc.py` (numpy on the host)."""

from __future__ import annotations

from typing import Dict, Iterable, Sequence

import numpy as np


def compute_auc(errors: Iterable[float],
                thresholds: Sequence[float]) -> Dict[str, float]:
    errors = np.asarray(list(errors), dtype=np.float64)
    errors = errors[np.isfinite(errors)].astype(np.float32)
    if errors.size == 0:
        return {f"{t}": 0.0 for t in thresholds}

    sort_idx = np.argsort(errors)
    errors = errors[sort_idx]
    recall = (np.arange(len(errors)) + 1) / len(errors)
    errors = np.r_[0.0, errors]
    recall = np.r_[0.0, recall]

    aucs = {}
    for thres in thresholds:
        last_index = np.searchsorted(errors, thres)
        rec = np.r_[recall[:last_index], recall[last_index - 1]]
        err = np.r_[errors[:last_index], thres]
        aucs[f"{thres}"] = float(np.trapezoid(rec, x=err) / thres)
    return aucs
