"""Tensor-parallel LightGlue heads (`shard_heads`) on the CPU: 4 gloo
ranks over a (data 2, model 2) mesh (`dryrun.launch`;
`tests/torch_ranks.py:lightglue_rank`) run LightGlue's inference forward
(float32, 4 heads: 2 a rank) on their rows of one global batch of 4,
against the JAX package's `shard_heads` LightGlue over its (2, 2) mesh on
the 8-device CPU platform, and against the port in one process computing
every head; tests/test_torch_shard_heads_step.py holds the stage-2 step
so.

Bounds: the log-assignment 1e-4 absolute and relative against JAX
(tests/test_torch_train.py's LightGlue parity: float32 sums through two
layers and the assignment head's log-softmaxes) and 1e-5 against one
process (the same products, the out-projection summed in two halves),
matches equal.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ei_nexus_tpu.models.lightglue import LightGlue as JaxLightGlue
from ei_nexus_tpu.models.lightglue import LightGlueConfig as JaxConfig
from ei_nexus_tpu.parallel import make_mesh as jax_make_mesh
from ei_nexus_tpu.parallel import replicate as jax_replicate
from ei_nexus_tpu_torch.models.lightglue import LightGlue, LightGlueConfig
from ei_nexus_tpu_torch.models.lightglue import head_sliced_parameters
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from ei_nexus_tpu_torch.parallel import dryrun
from ei_nexus_tpu_torch.parallel.mesh import Mesh, use_mesh
from tests import torch_ranks
from tests.test_torch_ddp import _perturb
from tests.test_torch_threads import one_torch_thread  # noqa: F401

DATA, MODEL = 2, 2
LG = dict(input_dim=32, descriptor_dim=64, n_layers=2, num_heads=4,
          shard_heads=True)


def _feats(rng, B, N, D, H=32, W=48):
    pos = np.concatenate([rng.uniform(0, H, (B, N, 1)),
                          rng.uniform(0, W, (B, N, 1)),
                          rng.uniform(0, 1, (B, N, 1))], -1)
    desc = rng.normal(size=(B, N, D))
    desc /= np.linalg.norm(desc, axis=-1, keepdims=True)
    return {"sparse_positions": pos.astype(np.float32),
            "sparse_descriptors": desc.astype(np.float32),
            "sparse_valid": rng.uniform(size=(B, N)) > 0.3,
            "image_size": np.tile(np.float32([H, W]), (B, 1))}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def cases():
    mesh = jax_make_mesh(data=DATA, model=MODEL,
                         devices=jax.devices()[:DATA * MODEL])
    rows = NamedSharding(mesh, P("data"))
    out = {}
    rng = np.random.default_rng(0)
    f0, f1 = _feats(rng, 4, 24, 32), _feats(rng, 4, 20, 32)
    jlg = JaxLightGlue(JaxConfig(**LG))
    lg_vars = _perturb(jlg.init(jax.random.PRNGKey(0), f0, f1))
    with jax.set_mesh(mesh):
        jout = jax.jit(jlg.apply)(
            jax_replicate(lg_vars, mesh),
            *(jax.tree_util.tree_map(lambda a: jax.device_put(a, rows), f)
              for f in (f0, f1)))
        out["jax_forward"] = {k: np.asarray(jout[k]) for k in (
            "log_assignment", "matches0", "matches1", "matching_scores0")}
    lg_cfg = LightGlueConfig(**LG)
    lg_state = load_jax_variables(lg_vars)
    one = LightGlue(lg_cfg)
    one.load_state_dict(lg_state, strict=True)
    with torch.no_grad():
        o = one.eval()(_torch(f0), _torch(f1))
    out["one_forward"] = {k: o[k] for k in out["jax_forward"]}
    out["ranks"] = dryrun.launch(
        torch_ranks.lightglue_rank, DATA * MODEL,
        (DATA, MODEL, lg_cfg, lg_state, _torch(f0), _torch(f1)),
        device="cpu", timeout_s=240)
    return out


def test_forward_over_data_2_model_2(cases):
    """Every rank's rows against the JAX (2, 2) mesh's and one process's;
    the two ranks of a model group give the same rows."""
    for r, got in enumerate(cases["ranks"]):
        rows = slice(r // MODEL, None, DATA)
        fwd = got
        for k, want in cases["jax_forward"].items():
            one = cases["one_forward"][k][rows]
            if k.startswith("matches"):
                np.testing.assert_array_equal(fwd[k].numpy(), want[rows])
                assert torch.equal(fwd[k], one), k
            else:
                np.testing.assert_allclose(fwd[k].numpy(), want[rows],
                                           atol=1e-4, rtol=1e-4, err_msg=k)
                np.testing.assert_allclose(fwd[k].numpy(), one.numpy(),
                                           atol=1e-5, rtol=1e-5, err_msg=k)
        partner = cases["ranks"][r ^ 1]
        for k in fwd:
            assert torch.equal(fwd[k], partner[k]), (r, k)


def test_head_sliced_parameters_are_the_attention_projections():
    """The parameters the step sums over the model group: Wqkv's weight
    and bias and out_proj's weight of each self-attention block, to_qk's
    and to_v's weight and bias and to_out's weight of each cross-attention
    block; the biases added after the reduction and everything else are
    whole on every rank."""
    lg = LightGlue(LightGlueConfig(**LG))
    names = {id(p): n for n, p in lg.named_parameters()}
    got = sorted(names[id(p)] for p in head_sliced_parameters(lg))
    want = sorted(
        f"transformers.{i}.{n}" for i in range(LG["n_layers"]) for n in (
            "self_attn.Wqkv.weight", "self_attn.Wqkv.bias",
            "self_attn.out_proj.weight", "cross_attn.to_qk.weight",
            "cross_attn.to_qk.bias", "cross_attn.to_v.weight",
            "cross_attn.to_v.bias", "cross_attn.to_out.weight"))
    assert got == want
    assert head_sliced_parameters(LightGlue(LightGlueConfig())) == []


def test_heads_must_divide_over_the_model_group():
    lg = LightGlue(LightGlueConfig(**LG))
    rng = np.random.default_rng(1)
    f0, f1 = _torch(_feats(rng, 1, 8, 32)), _torch(_feats(rng, 1, 8, 32))
    with use_mesh(Mesh(data=1, model=3, data_index=0, model_index=0,
                       device=torch.device("cpu"))):
        with pytest.raises(ValueError, match="do not divide"):
            lg(f0, f1)
