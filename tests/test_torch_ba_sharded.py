"""Bundle adjustment with its observations sharded over 4 gloo ranks
(`ba_solve(..., group=)`; `tests/torch_ranks.py:ba_rank`), the
counterpart of tests/test_ba.py::TestBA::test_sharded_matches_single_device:
the same problem (`synth_ba_problem(rng, M=4, L=64)`, observations
padded with invalid rows to a multiple of 8) solved by the port on one
process and sharded, and by the JAX package on one device and over its
8-device mesh, plain and robust (Huber 4 px with the cheirality gate,
the cost's robust branch). That test's bounds: the cost trajectory's first two
entries within 5% (summation order differs across shards, and the
trajectory is compared above the convergence floor), and every solve
below 1e-6 after 4 iterations; and the replicated fields bit-equal on
every rank. Poses and points are not compared across solves: with one
pose fixed the scale stays free, and the summation order alone moves the
converged solutions along it (~2e-4 relative).

Also `chip_smoke.py`'s phase 14b check of BA over 2 ranks against one
process (`ba_dp_check`) on its own problem (`ba_problem`) cut to 32
keyframes, 1024 landmarks and 6 observations each, on the CPU: it
passes the correct sharded solve and fails each planted fault (the last
rank's observations dropped, Hpp and Hll left un-reduced). At this size
the float32 solve is chaotic from its first step (one process with its
observations merely permuted takes another first step, where float64
takes the same in either order), so the check, which compares final
costs, runs 20 LM iterations, by which both solves have nearly
converged."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ei_nexus_tpu.parallel import make_mesh as jax_make_mesh
from ei_nexus_tpu.parallel import replicate as jax_replicate
from ei_nexus_tpu.parallel.ba import ba_solve as jax_ba_solve
from ei_nexus_tpu_torch.parallel.ba import BAProblem, ba_solve
from ei_nexus_tpu_torch.parallel.dryrun import launch
from tests import torch_ranks
from tests.test_ba import synth_ba_problem
from tests.test_torch_threads import one_torch_thread  # noqa: F401

ITERS = 4


@pytest.fixture(scope="module", params=[{}, {"huber_delta": 4.0,
                                             "z_min": 0.01}],
                ids=["plain", "robust"])
def solves(request):
    kw = request.param
    prob, *_ = synth_ba_problem(np.random.default_rng(0), M=4, L=64)
    pad = (-len(np.asarray(prob.obs_pose))) % 8

    def padded(a, fill=0):
        return jnp.concatenate(
            [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)])
    prob = prob._replace(
        obs_pose=padded(prob.obs_pose), obs_point=padded(prob.obs_point),
        obs_uv=padded(prob.obs_uv), obs_valid=padded(prob.obs_valid, False))
    out = {"jax_one": np.asarray(jax_ba_solve(prob, iters=ITERS, **kw)[1])}
    mesh = jax_make_mesh(data=8)
    with jax.set_mesh(mesh):
        obs = NamedSharding(mesh, P("data"))
        sharded = prob._replace(
            **{f: jax.device_put(getattr(prob, f), obs) for f in (
                "obs_pose", "obs_point", "obs_uv", "obs_valid")},
            **{f: jax_replicate(getattr(prob, f), mesh) for f in (
                "poses", "points", "intrinsics", "fixed_poses")})
        out["jax_sharded"] = np.asarray(jax_ba_solve(sharded, iters=ITERS,
                                                     **kw)[1])
    arrays = [np.array(a) for a in prob]
    _, errs = ba_solve(BAProblem(*(torch.as_tensor(a) for a in arrays)),
                       iters=ITERS, **kw)
    out["one"] = {"errs": errs}
    out["ranks"] = launch(torch_ranks.ba_rank, 4, (arrays, ITERS, kw),
                          device="cpu", timeout_s=240)
    return out


def test_sharded_matches_single_device(solves):
    one = solves["one"]
    for r in solves["ranks"]:
        errs = r["errs"].numpy()
        for want in (one["errs"].numpy(), solves["jax_sharded"],
                     solves["jax_one"]):
            np.testing.assert_allclose(errs[:2], want[:2], rtol=0.05)
        assert errs[-1] < 1e-6
        # the replicated fields stay equal on every rank
        assert torch.equal(r["poses"], solves["ranks"][0]["poses"])
        assert torch.equal(r["points"], solves["ranks"][0]["points"])
    assert float(one["errs"][-1]) < 1e-6
    assert solves["jax_sharded"][-1] < 1e-6


# phase 14b's BA case of chip_smoke.py, cut in size (see the docstring)
DP_SIZE, DP_ITERS, DP_FAULTS = (32, 1024, 6), 20, ("dropped", "unreduced")


@pytest.fixture(scope="module")
def dp_solves():
    import chip_smoke as cs
    one = cs.ba_dp_cases(None, 0, 1, device="cpu", size=DP_SIZE,
                         iters=DP_ITERS)["solves"][0]
    ranks = launch(cs.ba_dp_rank, 2, (1, DP_FAULTS, "cpu", DP_SIZE,
                                      DP_ITERS), device="cpu",
                   timeout_s=240)
    return cs, one, ranks


def test_ba_dp_check_passes_a_sharded_solve(dp_solves):
    cs, one, ranks = dp_solves
    assert cs.BA_DP_FAULTS == DP_FAULTS
    verdict = cs.ba_dp_check(one, [r["solves"][0] for r in ranks])
    assert verdict["ok"], verdict["why"]
    assert verdict["final_gap"] <= verdict["bound"]
    assert one["errs"][-1] < 1e-2 * one["errs"][0]  # the solve converges


@pytest.mark.parametrize("fault,why", [
    ("dropped", ("initial costs",)),
    ("unreduced", ("final costs", "differ from rank 0"))])
def test_ba_dp_check_catches_planted_faults(dp_solves, fault, why):
    """A rank's observations dropped change the initial cost; Hpp and
    Hll left un-reduced give each rank its own steps, which either part
    the ranks or, all refused, leave the cost where it began."""
    cs, one, ranks = dp_solves
    verdict = cs.ba_dp_check(one, [r["faults"][fault] for r in ranks])
    assert not verdict["ok"]
    assert any(r in w for w in verdict["why"] for r in why), verdict["why"]
