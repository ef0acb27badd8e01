"""The verdict is the conjunction of the printed checks, each value <= its
limit, on PR 21's recorded last line and at limits of 0."""

import json
import math

import pytest

from portbench.harness.verdict import make_checks, passes, verdict

# the last line of the refused run of the benchmark's first attempt
# (silk_lg.serve_b8, parent side, pair 3, seed 423205033), as the ledger
# keeps it under last_line_numbers
PR21 = json.loads("""{"desc_gap.event": {"value": 1.2293457984924316e-06,
  "limit": 0.0001}, "desc_gap.image": {"value": 8.940696716308594e-08,
  "limit": 5e-05}, "kp_lost.event": {"value": 0.0, "limit": 0.001},
  "kp_lost.image": {"value": 0.0, "limit": 0.001},
  "kp_lost_ranked.event": {"value": 0.0, "limit": 0.0},
  "kp_lost_ranked.image": {"value": 0.0, "limit": 0.0},
  "la_gap": {"value": 0.000644683837890625, "limit": 0.03},
  "la_gap.own": {"value": 0.00061798095703125}}""")


def test_pr21_line_without_its_unjudged_reading_is_correct():
    judged = {k: v for k, v in PR21.items() if "limit" in v}
    assert verdict(judged) is True


def test_pr21_line_with_a_reading_lacking_a_limit_is_malformed():
    with pytest.raises(ValueError):
        verdict(PR21)


@pytest.mark.parametrize("value,limit,ok", [
    (0.0, 0.0, True), (0, 0, True), (-0.0, 0.0, True),
    (1e-30, 0.0, False), (0.001, 0.001, True), (0.0010001, 0.001, False),
    (float("nan"), 0.0, False), (float("inf"), 1e9, False),
    (None, 1.0, False), (True, 1.0, False),
])
def test_one_comparison_le(value, limit, ok):
    assert passes(value, limit) is ok
    assert verdict({"x": {"value": value, "limit": limit}}) is ok


def test_one_failing_check_fails_the_run():
    checks = {"a": {"value": 0.0, "limit": 0.0},
              "b": {"value": 2.0, "limit": 1.0}}
    assert verdict(checks) is False
    assert verdict({}) is False


def test_make_checks_requires_every_limit():
    assert make_checks({"a": 1}, {"a": 2, "b": 3}) == {
        "a": {"value": 1.0, "limit": 2.0}}
    with pytest.raises(KeyError):
        make_checks({"a": 1, "c": 0}, {"a": 2})
    assert math.isnan(make_checks({"a": float("nan")},
                                  {"a": 1})["a"]["value"])


def test_a_nan_reading_is_kept_and_fails():
    import torch

    from portbench.harness import compare
    nan = float("nan")
    assert math.isnan(compare.worst([1.0, nan, 2.0]))
    assert math.isnan(compare.worst([nan, 1.0]))
    assert compare.worst([1.0, 3.0]) == 3.0
    # NaN descriptors at a valid keypoint reach desc_gap
    pos = torch.tensor([[[1.5, 1.5, 0.5]]])
    prog = {"sparse_positions": pos, "sparse_valid": torch.tensor([[True]]),
            "sparse_descriptors": torch.full((1, 1, 2), nan)}
    ref = {"positions": pos, "valid": torch.tensor([[True]]),
           "cut": torch.zeros(1, 1), "score": torch.full((1, 3, 3), 0.5),
           "describe": lambda p: torch.ones(1, 1, 2)}
    gaps = compare.extractor_gaps(prog, ref)
    assert math.isnan(gaps["desc_gap"]) and gaps["score_gap_median"] == [0.0]
    found = {k: compare.median(v) if isinstance(v, list) else v
             for k, v in gaps.items()}
    assert verdict(make_checks(found, {k: 1.0 for k in found})) is False


def test_score_gap_is_read_a_pair_at_a_time_and_the_median_kept():
    """One pair whose ranks shift reads its score step; the median of a
    run's pairs leaves it out, a shift in most pairs does not; a NaN
    reading stays NaN."""
    import torch

    from portbench.harness import compare
    scores = torch.tensor([[0.9, 0.5, 0.4, 0.1]]).repeat(3, 1)
    ref = {"positions": torch.stack([torch.full((3, 4), 0.5),
                                     torch.arange(4.0).repeat(3, 1) + 0.5,
                                     scores], -1),
           "valid": torch.ones(3, 4, dtype=torch.bool),
           "cut": torch.zeros(3, 1), "score": torch.zeros(3, 1, 4),
           "describe": lambda p: torch.zeros(3, 4, 2)}
    shifted = ref["positions"].clone()
    shifted[0, 1:, 2] = torch.tensor([0.4, 0.1, 0.05])
    prog = {"sparse_positions": shifted, "sparse_valid": ref["valid"],
            "sparse_descriptors": torch.zeros(3, 4, 2)}
    gaps = compare.extractor_gaps(prog, ref)["score_gap_median"]
    assert gaps[0] == pytest.approx(0.3) and gaps[1:] == [0.0, 0.0]
    assert compare.median(gaps) == 0.0
    assert compare.median(gaps + [0.3, 0.3]) == pytest.approx(0.3)
    assert math.isnan(compare.median(gaps + [float("nan")]))
