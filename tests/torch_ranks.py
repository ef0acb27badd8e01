"""The ranks' side of the port's multi-process tests
(`tests/test_torch_mesh.py`, `test_torch_ddp.py`,
`test_torch_shard_heads.py`, `test_torch_ba_sharded.py`).

Each function runs in every rank of a process group that
`ei_nexus_tpu_torch.parallel.dryrun.launch` spawns (gloo on the CPU, one
intra-op thread a rank), and returns plain tensors and numbers that the
test, in the parent process, holds against the JAX package and against
one process. This module imports torch and the port only, so that the
spawned ranks load neither JAX nor pytest.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ei_nexus_tpu_torch.parallel import collectives as col
from ei_nexus_tpu_torch.parallel.mesh import (agree, local_rows, make_mesh,
                                              replicate, shard_batch,
                                              use_mesh)


class IndexDataset:
    """tests/test_multiprocess.py's data set: sample i is a seeded normal
    16-vector and its index."""

    def __init__(self, n: int = 32):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng(100 + i)
        return {"x": rng.normal(size=(16,)).astype(np.float32),
                "i": np.int32(i)}


def _rank_tensor(rank: int, shape, scale: float = 1.0) -> torch.Tensor:
    g = torch.Generator().manual_seed(1000 + rank)
    return torch.randn(*shape, generator=g) * scale


def mesh_checks():
    """make_mesh at (4, 1) and (2, 2), replicate, the loader's rows, the
    collectives' forward and backward, and agree, on one of 4 ranks."""
    from ei_nexus_tpu_torch.data import DataLoader
    from ei_nexus_tpu_torch.train.state import create_train_state

    rank = dist.get_rank()
    out = {}
    meshes = {shape: make_mesh(*shape, device="cpu")
              for shape in ((4, 1), (2, 2))}
    for shape, m in meshes.items():
        # the members of each group: the sum of their ranks
        sums = []
        for g in (m.data_group, m.model_group):
            t = torch.tensor([float(rank)])
            if g is not None:
                dist.all_reduce(t, group=g)
            sums.append(float(t))
        out[shape] = dict(coords=(m.data, m.model, m.data_index,
                                  m.model_index, m.rank), sums=sums,
                          world=m.world, device=str(m.device),
                          groups=(m.data_group is not None,
                                  m.model_group is not None,
                                  m.host_group is not None))
    m41, m22 = meshes[(4, 1)], meshes[(2, 2)]

    # replicate: a module and a training state with its Adam moments
    net = torch.nn.Linear(3, 2)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(_rank_tensor(rank, p.shape))
    net.register_buffer("stat", _rank_tensor(rank, (2,)))
    replicate(net, m41)
    out["module"] = {k: v.clone() for k, v in net.state_dict().items()}
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    state = create_train_state(model, (), {"type": "AdamW"},
                               {"type": "CosineAnnealingLR"}, 1e-3)
    model[0].weight.grad = _rank_tensor(rank, (2, 3))
    model[0].bias.grad = _rank_tensor(rank + 7, (2,))
    state.optimizer.step()
    replicate(state, m22)
    out["state_mesh"] = state.mesh is m22
    out["moments"] = {k: v.clone() for k, v in
                      state.optimizer.state[model[0].weight].items()
                      if isinstance(v, torch.Tensor)}
    out["state_params"] = [p.detach().clone() for p in model.parameters()]

    # the loader's process shard, and local_rows of the global batch
    rows = {}
    for m in (m41, m22):
        loader = DataLoader(IndexDataset(), batch_size=8, shuffle=True,
                            seed=5, process_index=m.data_index,
                            process_count=m.data, num_workers=0)
        loader.set_epoch(0)
        batch = next(iter(loader))
        whole = {"i": np.arange(8) * 10, "x": np.zeros((8, 2))}
        moved = shard_batch(whole, m)
        rows[(m.data, m.model)] = (batch["i"].tolist(), local_rows(8, m),
                                   moved["i"].tolist(),
                                   str(moved["x"].device))
    out["rows"] = rows

    # all_reduce_sum over the world (data group of (4, 1)): forward, and
    # backward with a rank's own weight on the sum
    x = _rank_tensor(rank, (5,)).requires_grad_(True)
    w = _rank_tensor(rank + 50, (5,))
    y = col.all_reduce_sum(x, m41.data_group)
    (w * y).sum().backward()
    out["all_reduce_sum"] = (y.detach(), x.grad.clone())
    # copy_to_group over the model group of (2, 2): the input replicated
    # in the group (by data index), each rank's own weight downstream
    xc = _rank_tensor(100 + m22.data_index, (5,)).requires_grad_(True)
    yc = col.copy_to_group(xc, m22.model_group)
    (w * yc).sum().backward()
    out["copy_to_group"] = (yc.detach(), xc.grad.clone())
    # reduce_from_group: partial inputs, the downstream weight replicated
    # in the group
    xr = _rank_tensor(rank, (5,)).requires_grad_(True)
    wr = _rank_tensor(200 + m22.data_index, (5,))
    yr = col.reduce_from_group(xr, m22.model_group)
    (wr * yr).sum().backward()
    out["reduce_from_group"] = (yr.detach(), xr.grad.clone())
    xs = _rank_tensor(rank, (3,)).requires_grad_(True)
    gs = col.global_sum(xs, m41.data_group)
    out["global_sum"] = (gs, gs.requires_grad)
    out["agree"] = (agree(rank == 2, m41), agree(False, m41))
    return out


def stage1_terms(data, config, state_dict, batch, losses_cfg):
    """Each masked stage-1 loss term on this rank's rows of the global
    `batch`, its features from the model of `state_dict` with global
    BatchNorm statistics, with the global normalisers (under the mesh) and
    with local ones (no mesh); and this rank's event-mask count."""
    from ei_nexus_tpu_torch.losses import build_losses
    from ei_nexus_tpu_torch.models.eim import EIM
    from ei_nexus_tpu_torch.train.steps import batch_representation

    mesh = make_mesh(data, 1, device="cpu")
    net = EIM(config)
    net.load_state_dict(state_dict, strict=True)
    H, W = batch[0]["image"].shape[1:3]
    losses = build_losses(losses_cfg)
    local = shard_batch(batch, mesh)
    rep, mask = batch_representation(local[0], "VoxelGrid",
                                     config.event_extractor.in_channels, H, W,
                                     device="cpu")
    terms = {"mask_count": float(mask.sum())}
    with torch.no_grad(), use_mesh(mesh):
        ev, im, _ = net(rep, local[0]["image"], mask, None, training=True)
        for name in ("keypoints_loss", "descriptors_loss"):
            terms[f"{name}_global"] = float(losses[name](ev, im, mask)[0])
    with torch.no_grad():
        for name in ("keypoints_loss", "descriptors_loss"):
            terms[f"{name}_local"] = float(losses[name](ev, im, mask)[0])
    return terms


def lightglue_rank(data, model, config, state_dict, feats0, feats1):
    """LightGlue's inference forward on one rank of a (data, model) mesh:
    its rows of the global features, its heads of every attention
    block; returns its rows' scores and matches."""
    from ei_nexus_tpu_torch.models.lightglue import LightGlue

    mesh = make_mesh(data, model, device="cpu")
    with use_mesh(mesh):
        lg = LightGlue(config)
        lg.load_state_dict(state_dict, strict=True)
        lg.eval()
        with torch.no_grad():
            out = lg(shard_batch(feats0, mesh), shard_batch(feats1, mesh))
    return {k: out[k] for k in ("log_assignment", "matches0", "matches1",
                                "matching_scores0")}


def ba_rank(problem_arrays, iters, kwargs):
    """The sharded BA solve on one rank: its contiguous chunk of the
    (padded) observations, the rest replicated; returns the cost
    trajectory, poses and points."""
    from ei_nexus_tpu_torch.parallel.ba import BAProblem, ba_solve

    rank, world = dist.get_rank(), dist.get_world_size()
    prob = BAProblem(*(torch.as_tensor(a) for a in problem_arrays))
    O = prob.obs_pose.shape[0]
    chunk = slice(rank * O // world, (rank + 1) * O // world)
    prob = prob._replace(**{f: getattr(prob, f)[chunk] for f in (
        "obs_pose", "obs_point", "obs_uv", "obs_valid")})
    out, errs = ba_solve(prob, iters=iters, group=dist.group.WORLD, **kwargs)
    return {"errs": errs, "poses": out.poses, "points": out.points}


def ddp_cases(data, s2_config, s2_state, s2_batch, s2_fill, s1_config,
              s1_state, s1_batch, s1_losses):
    """One rank of every data-parallel case of tests/test_torch_ddp.py in
    one process group: the stage-2 step with the fill handed in and with
    it drawn from a seeded generator, the stage-1 step, and the stage-1
    terms before it."""
    from ei_nexus_tpu_torch.parallel import dryrun

    return {"stage2_fill": dryrun.stage2_rank(data, 1, "cpu", s2_config,
                                              s2_state, s2_batch, s2_fill),
            "stage2_drawn": dryrun.stage2_rank(data, 1, "cpu", s2_config,
                                               s2_state, s2_batch, None,
                                               seed=3),
            "stage1": dryrun.stage1_rank(data, "cpu", s1_config, s1_state,
                                         s1_batch, s1_losses),
            "terms": stage1_terms(data, s1_config, s1_state, s1_batch,
                                  s1_losses)}
