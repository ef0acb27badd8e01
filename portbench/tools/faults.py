"""Faults planted under a run's timed path, for the checks that must catch
them (`tests/test_portbench_faults.py` on the CPU, `tools/readings.py
--fault` on the chip). Each patches the program for the duration of a
`with plant(name):` block:

  unchanged_state   the stage-2 step returns its state unchanged (AdamW's
                    update is skipped);
  half_batch        the stage-2 loss leaves out half of the batch, the
                    mean taken over the rest;
  altered_gt        the stage-2 ground truth of each pair's first
                    keypoint altered where it is produced;
  altered_match     each served pair's first match altered where
                    LightGlue produces it;
  altered_keypoint  each served pair's strongest keypoint's descriptor
                    altered where the extractor produces it.
"""

from __future__ import annotations

import contextlib
from unittest import mock

ROLES = {"unchanged_state": "train", "half_batch": "train",
         "altered_gt": "train", "altered_match": "serve",
         "altered_keypoint": "serve"}


@contextlib.contextmanager
def plant(name: str):
    import torch
    from ei_nexus_tpu_torch.models import lightglue as lg_mod
    from ei_nexus_tpu_torch.models import extractor as ex_mod
    from ei_nexus_tpu_torch.train import steps as steps_mod

    if name == "unchanged_state":
        patch = mock.patch.object(torch.optim.AdamW, "step",
                                  lambda self, closure=None: None)
    elif name == "half_batch":
        orig = steps_mod.lightglue_loss

        def half(pred, gt, **kw):
            h = max(pred["all_log_assignments"].shape[0] // 2, 1)
            p = {k: pred[k][:h] for k in ("all_log_assignments",
                                          "confidence_logits0",
                                          "confidence_logits1")}
            g = {k: gt[k][:h] for k in ("matches0", "matches1",
                                        "assignment")}
            return orig(p, g, **kw)
        patch = mock.patch.object(steps_mod, "lightglue_loss", half)
    elif name == "altered_gt":
        orig = steps_mod.gt_matches_from_pose_depth

        def altered(*a, **kw):
            gt = dict(orig(*a, **kw))
            gt["assignment"] = gt["assignment"].clone()
            gt["assignment"][:, 0] = ~gt["assignment"][:, 0]
            return gt
        patch = mock.patch.object(steps_mod, "gt_matches_from_pose_depth",
                                  altered)
    elif name == "altered_match":
        orig = lg_mod.LightGlue._matches

        def altered(self, scores, mask0, mask1):
            out = orig(self, scores, mask0, mask1)
            m0 = out["matches0"].clone()
            M = scores.shape[2] - 1
            m0[:, 0] = (m0[:, 0].clamp(min=0) + 1) % M
            out["matches0"] = m0
            return out
        patch = mock.patch.object(lg_mod.LightGlue, "_matches", altered)
    elif name == "altered_keypoint":
        orig = ex_mod.extract_keypoints

        def altered(*a, **kw):
            out = orig(*a, **kw)
            d = out["sparse_descriptors"].clone()
            d[:, 0] = -d[:, 0]
            out["sparse_descriptors"] = d
            return out
        patch = mock.patch.object(ex_mod, "extract_keypoints", altered)
    else:
        raise ValueError(f"unknown fault {name!r}")
    with patch:
        yield
