"""Parallelism: process groups over a (data, model) grid of ranks and
the placement of state and batches on them (`mesh.py`), the
differentiable collectives the sharded steps call (`collectives.py`), the
SLAM back end, Schur-complement bundle adjustment (on one device, or with
the observations sharded over a process group) and pose-graph relaxation
(`ba.py`), and its assembly from the front end's matches (`slam.py`).
Counterpart of `ei_nexus_tpu/parallel/`; `python -m
ei_nexus_tpu_torch.parallel.dryrun` is the multi-process dry run."""

from .collectives import (all_reduce_sum, copy_to_group, global_sum,
                          reduce_from_group)
from .mesh import (Mesh, active_mesh, agree, barrier, distributed_init,
                   local_rows, make_mesh, replicate, shard_batch, use_mesh)

__all__ = ["Mesh", "distributed_init", "make_mesh", "replicate",
           "shard_batch", "local_rows", "use_mesh", "active_mesh", "agree",
           "barrier", "all_reduce_sum", "copy_to_group", "reduce_from_group",
           "global_sum"]
