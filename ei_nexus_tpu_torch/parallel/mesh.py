"""Process groups over a (data, model) grid of ranks, and the placement of
state and batches on them.

Counterpart of `ei_nexus_tpu/parallel/mesh.py`. There, `make_mesh` lays
the devices out as a `jax.sharding.Mesh` and XLA inserts every collective
of a jitted step. Here each rank is one process (`torch.distributed`), and
the port's code calls the collectives itself:

 - `distributed_init` joins the process group torchrun (or the caller)
   describes: NCCL on the card, gloo on the CPU, unless named;
 - `make_mesh` cuts the world into a data group and a model group per rank
   (rank r sits at (r // model, r % model), the JAX mesh's row-major
   layout), plus a gloo group over every rank for the host's own agreement
   (`agree`, `barrier`);
 - `replicate` broadcasts a model's or a training state's tensors from
   rank 0 and, for a training state, records the mesh its step runs over;
 - `local_rows` names this rank's rows of a global batch (strided, as
   `data.DataLoader(process_index, process_count)` shards the sample
   stream) and `shard_batch` puts them on its device: they stand where
   `data_sharding` and `jax.make_array_from_process_local_data` stand;
 - `use_mesh` makes a mesh the active one for a block, as `jax.set_mesh`
   does: BatchNorm, the stage-1 losses, the matcher's random fill and
   LightGlue's sharded heads read it (`active_mesh`) to compute over the
   global batch.

Only `all_reduce` and `broadcast` are used, so that gloo with CUDA tensors
serves where NCCL cannot (two ranks on one card).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
from typing import Any, Iterator, Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def distributed_init(device: Union[str, torch.device] = "cuda",
                     backend: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     init_method: Optional[str] = None,
                     timeout: Optional[datetime.timedelta] = None
                     ) -> torch.device:
    """Join the process group, and return this rank's device.

    `rank`, `world_size` and `local_rank` default to torchrun's RANK,
    WORLD_SIZE and LOCAL_RANK; `init_method` to "env://" (MASTER_ADDR and
    MASTER_PORT). Without a rank and a world size (no torchrun variables,
    none passed) nothing is initialised and `device` is returned resolved;
    with them the group is initialised, world size 1 included. `backend`
    defaults to NCCL for a CUDA `device` and gloo for the CPU. On the card
    a rank takes cuda:<local rank>; NCCL needs a card a rank and raises
    when two ranks of this host would share one, gloo (CUDA tensors
    staged through the host) takes local rank modulo the card count."""
    env = os.environ
    if rank is None and "RANK" in env and "MASTER_ADDR" in env:
        rank = int(env["RANK"])
    if world_size is None and "WORLD_SIZE" in env and "MASTER_ADDR" in env:
        world_size = int(env["WORLD_SIZE"])
    dev = resolve_device(device)
    if rank is None or world_size is None:
        return dev
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
        if backend == "nccl" and (local_rank >= count or local_world > count):
            raise RuntimeError(
                f"NCCL needs one card a rank: local rank {local_rank} of "
                f"{local_world} on a host with {count} card(s); run gloo "
                f"(backend='gloo') to put several ranks on one card")
        dev = torch.device("cuda", local_rank % count)
        torch.cuda.set_device(dev)
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world_size, **kw)
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a (data, model) grid of `data * model` ranks:
    its coordinates, its device, the group of the ranks that share its
    model index (the data group: they split the batch) and of those that
    share its data index (the model group: they split LightGlue's heads),
    each None where it would hold this rank alone, and `host_group`, gloo
    over every rank (None at world size 1)."""

    data: int
    model: int
    data_index: int
    model_index: int
    device: torch.device
    data_group: Any = None
    model_group: Any = None
    host_group: Any = None

    @property
    def world(self) -> int:
        return self.data * self.model

    @property
    def rank(self) -> int:
        return self.data_index * self.model + self.model_index


def make_mesh(data: Optional[int] = None, model: int = 1,
              device: Union[str, torch.device, None] = "cuda") -> Mesh:
    """The mesh over every rank of the process group (one rank when none
    is initialised): `data` defaults to world // model, and data * model
    must be the world size. Every rank must call it, with the same sizes:
    each group is created on every rank. `device` is this rank's (a CUDA
    device without an index is the current one, which `distributed_init`
    set)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        if world % model:
            raise ValueError(f"model {model} does not divide world {world}")
        data = world // model
    if data * model != world:
        raise ValueError(f"{data}x{model} != {world} ranks")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    data_index, model_index = divmod(rank, model)
    data_group = model_group = host_group = None
    if world > 1:
        for m in range(model):
            if data > 1:
                g = dist.new_group([d * model + m for d in range(data)])
                if m == model_index:
                    data_group = g
        for d in range(data):
            if model > 1:
                g = dist.new_group([d * model + m for m in range(model)])
                if d == data_index:
                    model_group = g
        host_group = (dist.group.WORLD if dist.get_backend() == "gloo"
                      else dist.new_group(backend="gloo"))
    return Mesh(data, model, data_index, model_index, dev, data_group,
                model_group, host_group)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "ei_nexus_tpu_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make `mesh` the active mesh inside the block (None: no mesh)."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def active_mesh() -> Optional[Mesh]:
    """The mesh of the innermost `use_mesh` block, or None."""
    return _ACTIVE.get()


def data_group() -> Any:
    """The active mesh's data group, or None (no mesh, or data size 1)."""
    mesh = active_mesh()
    return None if mesh is None else mesh.data_group


def _broadcast_(t: torch.Tensor, mesh: Mesh) -> None:
    """Overwrite `t` with rank 0's, staged through the mesh's device when
    it lies elsewhere (NCCL takes CUDA tensors only)."""
    buf = t.detach()
    if buf.device != mesh.device or not buf.is_contiguous():
        buf = buf.to(mesh.device).contiguous()
    dist.broadcast(buf, src=0)
    if buf.data_ptr() != t.data_ptr():
        with torch.no_grad():
            t.copy_(buf)


def replicate(obj, mesh: Mesh):
    """Broadcast from rank 0, in place, the parameters and buffers of a
    module, or of a training state's model together with its optimizer's
    state (each parameter's moments, in the order of the trainable
    parameters), or a sequence of tensors; returns `obj`. A training state
    also records `mesh`, the mesh its steps run over. Every rank must hold
    tensors of the same shapes in the same order."""
    if hasattr(obj, "optimizer"):
        obj.mesh = mesh
        model = obj.model
        tensors = list(model.parameters()) + list(model.buffers())
        for p in obj.trainable:
            st = obj.optimizer.state.get(p, {})
            tensors += [st[k] for k in sorted(st)
                        if isinstance(st[k], torch.Tensor)]
    elif isinstance(obj, torch.nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = list(obj)
    if mesh.world > 1:
        for t in tensors:
            _broadcast_(t, mesh)
    return obj


def local_rows(batch_size: int, mesh: Mesh) -> slice:
    """This rank's rows of a global batch of `batch_size`: every data-th
    row from its data index, as the DataLoader's process shard takes them
    (the ranks of one model group take the same rows)."""
    if batch_size % mesh.data:
        raise ValueError(f"global batch {batch_size} does not divide over "
                         f"{mesh.data} data ranks")
    return slice(mesh.data_index, batch_size, mesh.data)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows (`local_rows`) of a global batch (numpy arrays or
    tensors in dicts, tuples and lists, each with the batch as its leading
    axis) on its device: what a `DataLoader(process_index=data_index,
    process_count=data)` yields this rank, placed."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    if not isinstance(batch, torch.Tensor):
        batch = torch.as_tensor(np.asarray(batch))
    return batch[local_rows(batch.shape[0], mesh)].to(mesh.device,
                                                      non_blocking=True)


def agree(flag: bool, mesh: Optional[Mesh]) -> bool:
    """True on every rank when it is True on any (one all-reduce on the
    host group: no device synchronisation)."""
    if mesh is None or mesh.host_group is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.host_group)
    return bool(t.item())


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait until every rank reaches this call (on the host group)."""
    agree(False, mesh)
