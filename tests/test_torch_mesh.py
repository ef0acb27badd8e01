"""The port's process groups (`ei_nexus_tpu_torch/parallel/mesh.py`) and
differentiable collectives (`collectives.py`) on the CPU: one group of 4
gloo ranks (`dryrun.launch`, a file rendezvous in a temporary directory)
runs `tests/torch_ranks.py:mesh_checks`, and the parent holds what each
rank saw against the layout of the JAX package's `make_mesh`, the JAX
`DataLoader`'s process shards (tests/test_multiprocess.py's data set) and
one-process autograd of the same sums, exactly (sums of 4 float32 values
in one order on either side) or to 1e-6 where the order differs."""

import numpy as np
import pytest
import torch

from ei_nexus_tpu.data import DataLoader as JaxLoader
from ei_nexus_tpu.parallel import make_mesh as jax_make_mesh
from ei_nexus_tpu_torch.parallel.dryrun import launch
from ei_nexus_tpu_torch.parallel.mesh import (Mesh, active_mesh,
                                              distributed_init, local_rows,
                                              make_mesh, use_mesh)
from tests import torch_ranks
from tests.test_torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def ranks():
    return launch(torch_ranks.mesh_checks, WORLD, device="cpu",
                  timeout_s=240)


def _rank_tensor(rank, shape):
    return torch_ranks._rank_tensor(rank, shape)


@pytest.mark.parametrize("shape", [(4, 1), (2, 2)])
def test_make_mesh_lays_ranks_out_as_jax(ranks, shape):
    import jax
    jmesh = jax_make_mesh(data=shape[0], model=shape[1],
                          devices=jax.devices()[:WORLD])
    ids = np.vectorize(lambda d: d.id)(jmesh.devices)
    for r, out in enumerate(ranks):
        data, model, di, mi, rank = out[shape]["coords"]
        assert (data, model, rank) == (*shape, r)
        # the JAX mesh's device at (di, mi) is the r-th: row-major
        assert ids[di, mi] == jax.devices()[r].id
        assert out[shape]["world"] == WORLD
        assert out[shape]["device"] == "cpu"
        # data group: the ranks sharing mi; model group: those sharing di
        want_data = sum(d * shape[1] + mi for d in range(shape[0]))
        want_model = sum(di * shape[1] + m for m in range(shape[1]))
        assert out[shape]["sums"] == [want_data if shape[0] > 1 else r,
                                      want_model if shape[1] > 1 else r]
        assert out[shape]["groups"] == (shape[0] > 1, shape[1] > 1, True)


def test_make_mesh_refuses_a_wrong_size():
    with pytest.raises(ValueError, match="!= 1 ranks"):
        make_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(None, 2, device="cpu")
    one = make_mesh(device="cpu")
    assert (one.data, one.model, one.world, one.rank) == (1, 1, 1, 0)
    assert one.data_group is one.model_group is one.host_group is None


def test_replicate_takes_rank_zeros_tensors(ranks):
    first = ranks[0]
    for r, out in enumerate(ranks):
        for k, v in out["module"].items():
            assert torch.equal(v, first["module"][k]), (r, k)
        assert out["state_mesh"]
        for k, v in out["moments"].items():
            assert torch.equal(v, first["moments"][k]), (r, k)
        # each rank stepped from its own gradients: the parameters too are
        # rank 0's now
        for a, b in zip(out["state_params"], first["state_params"]):
            assert torch.equal(a, b), r
    # rank 0's values, not another's: its seeded weight and buffer
    assert torch.equal(first["module"]["weight"], _rank_tensor(0, (2, 3)))
    assert torch.equal(first["module"]["stat"], _rank_tensor(0, (2,)))
    assert not torch.equal(first["moments"]["exp_avg"],
                           torch.zeros_like(first["moments"]["exp_avg"]))


def test_local_rows_are_the_jax_loaders_process_shards(ranks):
    for shape in ((4, 1), (2, 2)):
        data = shape[0]
        whole = JaxLoader(torch_ranks.IndexDataset(), batch_size=8,
                          shuffle=True, seed=5, num_workers=0)
        whole.set_epoch(0)
        glob = next(iter(whole))["i"]
        for r, out in enumerate(ranks):
            got, rows, placed, device = out["rows"][shape]
            di = r // shape[1]
            jl = JaxLoader(torch_ranks.IndexDataset(), batch_size=8,
                           shuffle=True, seed=5, process_index=di,
                           process_count=data, num_workers=0)
            jl.set_epoch(0)
            want = next(iter(jl))["i"].tolist()
            assert got == want, (shape, r)
            assert got == glob[rows].tolist(), (shape, r)
            # shard_batch: the same rows of a global batch, placed
            assert placed == (np.arange(8) * 10)[rows].tolist()
            assert device == "cpu"


def test_local_rows_refuses_an_uneven_batch():
    mesh = Mesh(data=4, model=1, data_index=1, model_index=0,
                device=torch.device("cpu"))
    assert local_rows(8, mesh) == slice(1, 8, 4)
    with pytest.raises(ValueError, match="does not divide"):
        local_rows(6, mesh)


def test_all_reduce_sum_matches_one_process_autograd(ranks):
    X = torch.stack([_rank_tensor(r, (5,)) for r in range(WORLD)])
    Wt = torch.stack([_rank_tensor(r + 50, (5,)) for r in range(WORLD)])
    X.requires_grad_(True)
    Y = X.sum(0)
    (Wt * Y).sum().backward()        # every rank's loss reads the sum
    for r, out in enumerate(ranks):
        y, g = out["all_reduce_sum"]
        np.testing.assert_allclose(y.numpy(), Y.detach().numpy(),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(g.numpy(), X.grad[r].numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_conjugate_pair_matches_one_process_autograd(ranks):
    """copy_to_group: one input shared by a model group, each rank's loss
    on it: the input's gradient is the sum of the group's. reduce_from_
    group: the group's partial inputs summed, one loss on the sum: each
    partial's gradient is the loss's."""
    for di in range(2):
        group = [2 * di, 2 * di + 1]
        x = _rank_tensor(100 + di, (5,)).requires_grad_(True)
        sum((_rank_tensor(r + 50, (5,)) * x).sum()
            for r in group).backward()
        xr = torch.stack([_rank_tensor(r, (5,)) for r in group])
        xr.requires_grad_(True)
        w = _rank_tensor(200 + di, (5,))
        (w * xr.sum(0)).sum().backward()
        for i, r in enumerate(group):
            y, g = ranks[r]["copy_to_group"]
            assert torch.equal(y, x.detach())
            np.testing.assert_allclose(g.numpy(), x.grad.numpy(),
                                       rtol=1e-6, atol=1e-6)
            y, g = ranks[r]["reduce_from_group"]
            np.testing.assert_allclose(y.numpy(), xr.sum(0).detach().numpy(),
                                       rtol=1e-6, atol=1e-6)
            assert torch.equal(g, xr.grad[i])


def test_global_sum_and_agree(ranks):
    total = sum(_rank_tensor(r, (3,)) for r in range(WORLD))
    for out in ranks:
        gs, needs_grad = out["global_sum"]
        np.testing.assert_allclose(gs.numpy(), total.numpy(), rtol=1e-6,
                                   atol=1e-6)
        assert not needs_grad
        assert out["agree"] == (True, False)


def test_use_mesh_nests_and_restores():
    a = Mesh(1, 1, 0, 0, torch.device("cpu"))
    b = Mesh(1, 1, 0, 0, torch.device("cpu"))
    assert active_mesh() is None
    with use_mesh(a):
        assert active_mesh() is a
        with use_mesh(b):
            assert active_mesh() is b
        with use_mesh(None):
            assert active_mesh() is None
        assert active_mesh() is a
    assert active_mesh() is None


def test_distributed_init_without_ranks_is_a_no_op(monkeypatch):
    import torch.distributed as dist
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(k, raising=False)
    assert distributed_init("cpu") == torch.device("cpu")
    assert not dist.is_initialized()


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """Two local ranks on a host with one card: NCCL raises before any
    group is made (gloo would take both)."""
    import torch.distributed as dist
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    for local in (0, 1):
        with pytest.raises(RuntimeError, match="one card a rank"):
            distributed_init("cuda", rank=local, world_size=2,
                             local_rank=local)
    assert not dist.is_initialized()
