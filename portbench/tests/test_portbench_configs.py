"""Each configuration file holds a copy of what the repo's YAML gives,
read through the port's config reader: the served and stage-2 model
dicts whole, and the numbers of the stage-2 recipe and of MVSEC's frames
that the harness reads. The copies stay in the benchmark, which a later
change to the YAML may not move; this test shows when the two part."""

import json
from pathlib import Path

import pytest

from portbench.harness import common

CONFIGS = sorted(p.stem for p in (common.BENCH / "configs").glob("*.json"))
EXPERIMENT = "configs/train_EIM_stage2.yaml"


def load(path, overrides=()):
    from ei_nexus_tpu_torch.utils.config import load_config
    return load_config(str(common.ROOT / path), list(overrides)).to_dict()


@pytest.fixture(params=CONFIGS)
def config(request):
    return common.load_json(common.BENCH / "configs"
                            / f"{request.param}.json")


def test_model_dicts_equal_the_yaml(config):
    served, stage2 = config["mirrors"][:2]
    assert config["model"] == load(served)
    assert config["stage2_model"] == load(stage2)
    # the stage-2 experiment composes the same model dict
    exp = load(EXPERIMENT, [f"model={Path(stage2).stem}"])
    assert config["stage2_model"] == exp["model"]


def test_recipe_and_frames_equal_the_yaml(config):
    assert EXPERIMENT in config["mirrors"]
    exp = load(EXPERIMENT)
    tr, mine = exp["train"], config["train"]
    assert mine["lr"] == tr["optimizer"]["lr"]
    adamw = tr["optimizer"]["AdamW"]
    assert mine["optimizer"]["type"] == tr["optimizer"]["type"] == "AdamW"
    for k in ("weight_decay", "betas"):
        assert mine["optimizer"][k] == adamw[k]
    assert mine["optimizer"]["eps"] == float(adamw["eps"])
    sched = tr["scheduler"]
    assert mine["scheduler"]["type"] == sched["type"]
    for k, v in sched[sched["type"]].items():
        assert mine["scheduler"][k] == v
    assert mine["gt"] == tr["gt_matches"]
    shape = config["shape"]
    for path in [p for p in config["mirrors"] if "/dataset/" in p]:
        ds = load(path)
        assert [shape["height"], shape["width"]] == ds["resolution"]
        assert shape["bins"] == ds["channel"]
        assert shape["kind"] == ds["representation_type"]
    batch = exp["dataset"]["train"]["batch_size"]
    assert common.load_json(common.BENCH / "traffic"
                            / "train_s2_b8.json")["batch"] == batch
