"""The port's training entries data-parallel on the CPU: `python -m
torch.distributed.run --standalone --nproc_per_node 2 -m
ei_nexus_tpu_torch.<entry> --device cpu --max-steps 2` (gloo, global batch
2, one sample a rank) over a rendered mini-EC, with the reduced overrides
of tests/test_torch_entry.py (stage 1) and
tests/test_torch_matcher_entry.py (stage 2, `TINY`), against the same
entry in one process on the same seed.

Checks: exit 0; each rank prints its place and backend; rank 0 alone
writes the run directory (its log, metrics and checkpoints), the `final`
checkpoint at step 2; the logged losses, both steps' gradients and the
final parameters and statistics equal the one-process run's. Bounds: the
logged loss 1e-5 relative (float32 reductions over two ranks' halves);
grad_norm 1e-5 at step 1 and 1e-3 at step 2 (after one Adam step, which
moves a parameter by about lr whatever its gradient, the few whose
gradient is at reduction noise stand 2 lr apart, as
tests/test_torch_stage1.py's second step explains). The gradients are
read through Adam's first moment in the final checkpoint (0.09 g1 + 0.1
g2), each leaf within a bound of its largest value (a hundredth of the
largest leaf's at least; `test_torch_ddp.close_grads`): stage 2 1e-4
(2.7e-6 seen); stage 1 0.25, as the full-width extractor's float32
gradient is ill-conditioned (BatchNorm's backward subtracts means over
51,200 pixels a channel: reversing the batch's two rows in one process
moves a leaf's gradient by 7e-3 of its largest, and step 1's parameters
at noise then move step 2's: 0.126 seen), while a gradient swapped
between leaves, a mis-split all-reduce or a sum left unaveraged moves it
by its own size. Parameters: every element within 4.5 lr (two Adam steps
move one by at most about lr each, weight decay aside), and in stage 2
each whose moment stands above 1e-3 of its leaf's largest and above 1e-6
within 1e-2 lr; frozen tensors bit-equal; running statistics 1e-4
absolute (step 2's batch statistics read the activations of those
parameters: 5.6e-5 seen on a running variance of 0.85).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_torch_ddp import close_grads
from tests.test_torch_matcher_entry import TINY
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
# entry: (config, overrides, lr, bound on Adam's first moment)
CONFIGS = {"train_extractor": ("train_EIM_stage1_EC_SP_MNN.yaml", [], 1e-3,
                               0.25),
           "train_matcher": ("train_EIM_stage2.yaml",
                             ["dataset=ec"] + TINY, 1e-4, 1e-4)}


@pytest.fixture(scope="module")
def mini_ec(tmp_path_factory):
    """The six EC training sequences, copies of one rendered at 203 frames
    (one sample a sequence: three global batches of 2)."""
    import shutil
    from ei_nexus_tpu_torch.data.ec import TRAIN_SEQUENCES
    from ei_nexus_tpu_torch.data.mini_ec import make_mini_ec
    root = tmp_path_factory.mktemp("mini_ec")
    first, *rest = TRAIN_SEQUENCES
    make_mini_ec(str(root), frames=203, sequences=[first])
    for seq in rest:
        shutil.copytree(root / first, root / seq)
    return root


def _args(entry, root, out):
    config, extra = CONFIGS[entry][:2]
    return (["--config", str(ROOT / "configs" / config), "--device", "cpu",
             "--max-steps", "2"] + extra
            + [f"dataset.data_path={root}", "dataset.train.batch_size=2",
               "dataset.train.num_workers=2", "logger.status_freq=1",
               f"logger.output_dir={out}"])


def _run_dir(out):
    run, = [p for p in Path(out).iterdir() if p.is_dir()]
    rows = [json.loads(x) for x in
            (run / "metrics.jsonl").read_text().splitlines()]
    return run, rows


@pytest.mark.parametrize("entry", sorted(CONFIGS))
def test_entry_at_world_2_matches_one_process(entry, mini_ec, tmp_path):
    import importlib
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", f"ei_nexus_tpu_torch.{entry}"]
        + _args(entry, mini_ec, tmp_path / "two"),
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    for r in range(2):
        assert f"rank {r} of 2: backend gloo, device cpu" in proc.stdout
    # rank 0 alone wrote the run: one directory, its log and checkpoint
    run2, rows2 = _run_dir(tmp_path / "two")
    assert [r["step"] for r in rows2] == [1, 2]
    assert "rank 0 of 2: backend gloo" in (run2 / "log.txt").read_text()
    final = torch.load(run2 / "checkpoints" / "final" / "state.pt",
                       map_location="cpu", weights_only=True)
    assert final["step"] == 2

    module = importlib.import_module(f"ei_nexus_tpu_torch.{entry}")
    state = module.main(_args(entry, mini_ec, tmp_path / "one"))
    _, rows1 = _run_dir(tmp_path / "one")
    for a, b in zip(rows2, rows1):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=1e-5 if a["step"] == 1 else 1e-3)
    # each step's global gradient, through Adam's first moment after two
    # steps (0.09 g1 + 0.1 g2), by the trainable parameters' names
    _, _, lr, moment_rtol = CONFIGS[entry]
    names = {id(p): n for n, p in state.model.named_parameters()}
    order = [names[id(p)] for p in state.trainable]
    moments = [{order[i]: v["exp_avg"] for i, v in opt["state"].items()}
               for opt in (final["optimizer"],
                           state.optimizer.state_dict())]
    assert len(moments[1]) == len(order)
    close_grads(*moments, moment_rtol)
    want = state.model.state_dict()
    assert set(final["model"]) == set(want)
    for k, v in want.items():
        got = final["model"][k]
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got.numpy(), v.numpy(), atol=1e-4,
                                       rtol=0, err_msg=k)
        elif k not in moments[1]:
            assert torch.equal(got, v), k
        else:
            d = (got - v).abs().numpy()
            np.testing.assert_array_less(d, 4.5 * lr, err_msg=k)
            if moment_rtol <= 1e-4:
                m = moments[1][k].abs().numpy()
                sure = (m > 1e-3 * m.max()) & (m > 1e-6)
                assert d[sure].max(initial=0) <= 1e-2 * lr, k
