"""The multi-process dry run: the stage-2 training step over a (data,
model) mesh of processes against the same step on one process.

Counterpart of `__graft_entry__.dryrun_multichip`: the tiny stage-2
flagship (LightGlue's heads split over the model group when it has more
than one rank) takes one step over the mesh from the same state, the same
global batch (one sample a data rank) and the same random fill as one
process takes it alone; the loss must agree to 1e-4 relative, the global
gradient norm to 1e-3 (a missing or doubled reduction moves it by
sqrt(data) or more) and every parameter to 3 lr absolute (Adam's first
step moves a parameter by about lr whatever its gradient, so one whose
gradient is at reduction noise may step the other way).

    python -m ei_nexus_tpu_torch.parallel.dryrun --world 4 --model 2 \\
        --device cpu

`launch` runs a function in a group of spawned processes, one rank each,
rendezvousing through a file in a temporary directory; `stage2_setup`
and `stage1_setup` build one rank's training step over a mesh, and
`first_step` takes it once and returns what the checks compare (info,
launches, each leaf's reduced gradient, the state). The dry run, the
tests and `chip_smoke.py` drive their multi-rank checks through these.
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import multiprocessing.connection
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import distributed_init, make_mesh, replicate, shard_batch

LOSS_REL, GRAD_NORM_REL, PARAM_LRS = 1e-4, 1e-3, 3.0


def _rank_main(rank: int, world: int, rendezvous: str, device: str,
               backend: Optional[str], timeout_s: float, fn: Callable,
               args: Sequence[Any]) -> None:
    torch.set_num_threads(1)
    distributed_init(device, backend=backend, rank=rank, world_size=world,
                     local_rank=rank, init_method=f"file://{rendezvous}",
                     timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        torch.save(out, f"{rendezvous}.result{rank}")
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world: int, args: Sequence[Any] = (),
           device: str = "cuda", backend: Optional[str] = None,
           timeout_s: float = 300.0) -> List[Any]:
    """fn(*args) in `world` spawned processes, each a rank of one process
    group (`distributed_init` on `device`, `backend` defaulting as there,
    the rendezvous a file in a temporary directory, so no port is taken);
    returns each rank's result (torch.save-able) in rank order. `fn` must
    be importable by its module's name. Raises when a rank exits with an
    error or the group outlives `timeout_s`; every rank still running is
    then terminated."""
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ei_nexus_ranks_") as tmp:
        rendezvous = os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, args=(
            r, world, rendezvous, device, backend, timeout_s, fn, args))
            for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.exitcode is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.exitcode]
                if failed:
                    raise RuntimeError(f"rank(s) {failed} of {world} failed")
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks outlived "
                                       f"{timeout_s} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None],
                    timeout=min(left, 1.0))
            failed = [r for r, p in enumerate(procs) if p.exitcode]
            if failed:
                raise RuntimeError(f"rank(s) {failed} of {world} failed")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                p.join()
        # written by the ranks just above
        return [torch.load(f"{rendezvous}.result{r}", weights_only=False)
                for r in range(world)]


def kernel_counters() -> Dict[str, Callable]:
    """Every kernel wrapper of the port, by name: each adds one to its
    `launches` where it launches its kernel."""
    from ..ops import attention_kernels as ak
    from ..ops import flash_kernel as fk
    from ..ops import nms_kernel as nk
    return {"self_attention_rot": ak.self_attention,
            "cross_attention_bidir": ak.cross_attention_bidir,
            "nms_rounds": nk.nms_rounds,
            "attention_fwd": ak.attention_fwd,
            "attention_bwd": ak.attention_bwd,
            "qblock_attention": ak.qblock_attention,
            "flash_attention": fk.flash_attention}


def _replicated(net, make_state, data: int, model: int, device: str,
                state_dict):
    mesh = make_mesh(data, model, device)
    net.load_state_dict(state_dict, strict=True)
    return replicate(make_state(net.to(mesh.device)), mesh)


def stage2_setup(data: int, model: int, device: str, config, state_dict,
                 batch) -> Tuple[Any, Callable[..., Dict[str, Any]]]:
    """One rank of the stage-2 step over a (data, model) mesh (one process
    alone at (1, 1)): the stage-2 model of `config` (an EIMConfig, with
    LightGlue's training heads) loaded from `state_dict` and replicated.
    Returns (state, run): run(fill=None, seed=0) takes one step of
    `make_stage2_train_step` on this rank's rows of the global `batch`
    (numpy, (data0, data1, T01, T10)), the fill handed in (`fill`, the
    global batch's) or drawn from a generator seeded `seed`, and returns
    its info."""
    from ..flagship import stage2_train_state
    from ..models.eim import EIM
    from ..train.steps import make_stage2_train_step

    state = _replicated(EIM(config, training_heads=True), stage2_train_state,
                        data, model, device, state_dict)
    H, W = batch[0]["depth"].shape[1:3]
    step = make_stage2_train_step("VoxelGrid",
                                  config.event_extractor.in_channels, H, W)
    local = shard_batch(batch, state.mesh)
    gen = torch.Generator(device=state.mesh.device)

    def run(fill=None, seed: int = 0) -> Dict[str, Any]:
        gen.manual_seed(seed)
        return step(state, local, gen, fill)
    return state, run


def stage1_setup(data: int, device: str, config, state_dict, batch,
                 losses) -> Tuple[Any, Callable[[], Dict[str, Any]]]:
    """One rank of the stage-1 step over a (data, 1) mesh, as
    `stage2_setup`: run() takes one step of `make_stage1_train_step` with
    the losses of the config `losses` on this rank's rows of the global
    `batch` ((data0,))."""
    from ..flagship import stage1_train_state
    from ..losses import build_losses
    from ..models.eim import EIM
    from ..train.steps import make_stage1_train_step

    state = _replicated(EIM(config), stage1_train_state, data, 1, device,
                        state_dict)
    H, W = batch[0]["image"].shape[1:3]
    step = make_stage1_train_step(build_losses(losses), "VoxelGrid",
                                  config.event_extractor.in_channels, H, W)
    local = shard_batch(batch, state.mesh)
    return state, lambda: step(state, local)


def first_step(state, run: Callable[[], Dict[str, Any]]) -> Dict[str, Any]:
    """Every kernel's count set to 0, then run(): its info (floats), each
    kernel's launches in it, each trainable parameter's gradient as the
    update read it (global over the mesh; float32 on the CPU, by name) and,
    on rank 0, the state dict after the step on the CPU."""
    counters = kernel_counters()
    for c in counters.values():
        c.launches = 0
    info = run()
    out = {"info": {k: float(v) for k, v in info.items()},
           "launches": {n: c.launches for n, c in counters.items()}}
    names = {id(p): n for n, p in state.model.named_parameters()}
    out["grads"] = {names[id(p)]: p.grad.detach().float().cpu()
                    for p in state.trainable if p.grad is not None}
    if state.mesh.rank == 0:
        out["state_dict"] = {k: v.detach().cpu() for k, v in
                             state.model.state_dict().items()}
    return out


def stage2_rank(data: int, model: int, device: str, config, state_dict,
                batch, fill=None, seed: int = 0) -> Dict[str, Any]:
    """`first_step` of `stage2_setup`'s step with `fill` and `seed`."""
    state, run = stage2_setup(data, model, device, config, state_dict, batch)
    return first_step(state, lambda: run(fill, seed))


def stage1_rank(data: int, device: str, config, state_dict, batch,
                losses) -> Dict[str, Any]:
    """`first_step` of `stage1_setup`'s step."""
    return first_step(*stage1_setup(data, device, config, state_dict, batch,
                                    losses))


def check_against_one(sharded: Dict[str, Any], one: Dict[str, Any],
                      lr: float) -> Dict[str, float]:
    """The dry run's bounds (the module's docstring), `sharded` (rank 0's
    `stage2_rank` over the mesh) against `one` (one process): raises
    when one is broken; returns the loss, both grad norms and the largest
    parameter difference."""
    a, b = sharded["info"], one["info"]
    if not abs(a["loss"] - b["loss"]) <= LOSS_REL * max(1.0, abs(b["loss"])):
        raise RuntimeError(f"loss {a['loss']} != {b['loss']}")
    if not abs(a["grad_norm"] - b["grad_norm"]) <= GRAD_NORM_REL * max(
            1.0, abs(b["grad_norm"])):
        raise RuntimeError(f"grad_norm {a['grad_norm']} != {b['grad_norm']}")
    worst = 0.0
    for k, v in one["state_dict"].items():
        d = float((sharded["state_dict"][k].float() - v.float()).abs().max())
        if not d <= PARAM_LRS * lr:
            raise RuntimeError(f"{k} differs by {d} > {PARAM_LRS} lr")
        worst = max(worst, d)
    return {"loss": a["loss"], "grad_norm": a["grad_norm"],
            "grad_norm_one": b["grad_norm"], "max_param_diff": worst}


def dryrun(world: int, model: int, device: str = "cuda",
           backend: Optional[str] = None) -> Dict[str, float]:
    """The tiny stage-2 flagship's step over (world // model, model)
    ranks against one process, from the same state, batch and fill;
    raises on a bound broken."""
    from ..data.synth import stage2_batch
    from ..flagship import STAGE2_LR, stage2_config
    from ..models.eim import EIM
    from ..models.layers import init_parameters

    device = str(resolve_device(device))
    data = world // model
    config, (H, W, _) = stage2_config(tiny=True, dtype="float32",
                                      shard_heads=model > 1)
    net = EIM(config, training_heads=True)
    init_parameters(net, torch.Generator().manual_seed(0))
    state_dict = net.state_dict()
    batch = stage2_batch(np.random.default_rng(0), data, 2000, 4096, H, W)
    args = (config, state_dict, batch)
    sharded = launch(stage2_rank, world, (data, model, device) + args,
                     device=device, backend=backend)[0]
    one = stage2_rank(1, 1, device, *args)
    out = check_against_one(sharded, one, STAGE2_LR)
    out.update(data=data, model=model)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--model", type=int, default=2)
    p.add_argument("--device", default="cuda",
                   help="the card (default) or the CPU")
    p.add_argument("--backend", default=None,
                   help="nccl (the card's default: a card a rank) or gloo")
    a = p.parse_args(argv)
    r = dryrun(a.world, a.model, a.device, a.backend)
    print(f"dryrun: stage-2 step OK over (data={r['data']}, "
          f"model={r['model']}) ranks, loss={r['loss']:.4f}; one-process "
          f"equality: grad_norm {r['grad_norm']:.5f} vs "
          f"{r['grad_norm_one']:.5f}, max abs param diff "
          f"{r['max_param_diff']:.2e}")


if __name__ == "__main__":
    main()
