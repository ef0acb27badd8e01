"""The multi-process slice over NCCL across the cards of one host, a rank
a card (run it with 4 cards): the kernels built, then the dry run
(`parallel/dryrun.py`) at (data 2, model 2) against one process,
`chip_smoke.py` phase 14a (`train_matcher` under torchrun) at world size =
the card count over a rendered mini-EC, and phase 14b's cases at that
world size (the stage-2 and stage-1 steps data-parallel, `shard_heads`,
BA) against one process. Prints what those phases print.

    python tools/chip_nccl4.py
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    count = torch.cuda.device_count()
    if count < 2:
        print(f"{count} card(s): NCCL across cards needs at least 2",
              file=sys.stderr)
        return 2
    from ei_nexus_tpu_torch.ops import cuda_build
    from ei_nexus_tpu_torch.parallel import dryrun
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.perf_counter()
    cuda_build.build()
    print(f"[setup] kernels built in {time.perf_counter() - t:.1f} s; "
          f"{count} cards")
    smi = chip_smoke.nvidia_smi_line()
    t = time.perf_counter()
    dry = dryrun.dryrun(4, 2, "cuda") if count >= 4 else None
    print(f"[dryrun] {dry} in {time.perf_counter() - t:.1f} s")
    with tempfile.TemporaryDirectory(prefix="chip_nccl4_") as tmp:
        data = os.path.join(tmp, "mini_ec")
        chip_smoke.render_mini_ec(data)
        chip_smoke.render_mini_ec_val(data)
        entry = chip_smoke.phase_dp_entry(data, tmp, os.path.join(
            tmp, "no_stage1_checkpoint"))
    world = 4 if count >= 4 else 2
    t = time.perf_counter()
    dp = chip_smoke.phase_dp(world, "nccl")
    print(f"[wall] phase 14b over {world} NCCL ranks: "
          f"{time.perf_counter() - t:.1f} s")
    print(f"data-parallel stage-2 step (flagship, global batch 8): "
          f"{1e3 / dp['ms_1']:.3f} steps/s in one process "
          f"({dp['ms_1']:.3f} ms), {1e3 / dp['ms_2']:.3f} steps/s over "
          f"{world} NCCL ranks, a card each ({dp['ms_2']:.3f} ms); "
          f"collectives {dp['collective_ms']:.3f} ms of a "
          f"{dp['ms_synced']:.3f} ms step with the cards synchronised "
          f"around them; on {smi}")
    print(entry, dp, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
