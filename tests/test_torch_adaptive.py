"""Adaptive LightGlue (early exit and point pruning) and the scanned
layers' parameters: the port against the JAX package on the same steered
weights and inputs, on the CPU.

The six cases of tests/test_lightglue_adaptive.py run on both sides with
the einsum attention ("xla"), whose cross-attention masks queries and keys
jointly on both sides (the "auto"/"pallas" kernels mask keys only, so
their outputs at invalid query rows, which the assignment head's
column softmax reads, differ from the einsum path's wherever slots are
padded). The decision heads' biases are steered into each regime as that
file does. "pallas" runs on the port's plain kernel versions at 128-token
multiples with heads of 64: adaptive with nothing pruned and no exit
equals the plain forward bit for bit, and with one batch row pruned
whole (its keys all masked in the next layer's kernels) it agrees with
the JAX package's einsum path, which on slots that are all valid masks
alike.

Tolerances: exit layers, surviving masks and matches exact; scores and
log-assignments atol 1e-4 with rtol 1e-4 (float32 matmuls summed in
another order through the layers; observed ~1e-5).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ei_nexus_tpu.models import lightglue as jlg
from ei_nexus_tpu_torch.models import lightglue as tlg
from ei_nexus_tpu_torch.models.port_jax import load_jax_variables
from tests.test_torch_threads import one_torch_thread  # noqa: F401

K, D = 32, 64
BASE = dict(input_dim=D, descriptor_dim=D, n_layers=3, num_heads=4,
            attention_impl="xla")
TOL = dict(atol=1e-4, rtol=1e-4)


def _feats(rng, B=2, K=K, D=D, pad=4):
    d = rng.normal(size=(B, K, D)).astype(np.float32)
    pos = np.concatenate([rng.uniform(0, 60, (B, K, 2)),
                          rng.uniform(0, 1, (B, K, 1))], -1).astype(np.float32)
    valid = np.ones((B, K), bool)
    if pad:
        valid[:, -pad:] = False
    return {"sparse_descriptors": d, "sparse_positions": pos,
            "sparse_valid": valid,
            "image_size": np.full((B, 2), 64.0, np.float32)}


def _jax(f):
    return {k: jnp.asarray(v) for k, v in f.items()}


def _torch(f):
    return {k: torch.from_numpy(np.array(v)) for k, v in f.items()}


def _set_bias(variables, name_fmt, n, value):
    params = jax.tree_util.tree_map(lambda x: x, variables["params"])
    for i in range(n):
        node = params
        for part in name_fmt.format(i).split("/"):
            node = node[part]
        node["bias"] = jnp.full_like(node["bias"], value)
    return {**variables, "params": params}


def _init(cfg, f0, f1, training=False):
    model = jlg.LightGlue(config=jlg.LightGlueConfig(**cfg))
    return model, model.init(jax.random.PRNGKey(0), _jax(f0), _jax(f1),
                             training=training)


def _port(cfg, variables, training_heads=False):
    m = tlg.LightGlue(tlg.LightGlueConfig(**cfg), training_heads)
    m.load_state_dict(load_jax_variables(variables), strict=True)
    return m.eval()


def _run(model, f0, f1, **kw):
    with torch.no_grad():
        return model(_torch(f0), _torch(f1), **kw)


def _compare(got, want, keys=("matches0", "matches1", "exit_layer",
                              "surviving0", "surviving1")):
    for k in keys:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("matching_scores0", "matching_scores1", "log_assignment",
              "similarity"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def _steered(rng, extra, name_fmt, n, value):
    """Inputs, the JAX adaptive model's output and the port's on the same
    steered weights."""
    f0, f1 = _feats(rng), _feats(rng)
    cfg = {**BASE, **extra}
    jm, v = _init(cfg, f0, f1)
    if name_fmt:
        v = _set_bias(v, name_fmt, n, value)
    want = jax.jit(lambda v: jm.apply(v, _jax(f0), _jax(f1)))(v)
    return f0, f1, v, want, _run(_port(cfg, v), f0, f1)


def test_never_exit_equals_plain_forward(rng):
    f0, f1, v, want, got = _steered(rng, dict(depth_confidence=0.95),
                                    "token_confidence_{}", 2, -10.0)
    assert int(got["exit_layer"]) == 2
    _compare(got, want)
    plain = _run(_port(BASE, v, training_heads=True), f0, f1)
    for k in ("log_assignment", "matches0", "matching_scores0"):
        assert torch.equal(got[k], plain[k]), k


def test_exit_at_first_layer_equals_one_layer_model(rng):
    f0, f1, v, want, got = _steered(rng, dict(depth_confidence=0.5),
                                    "token_confidence_{}", 2, 10.0)
    assert int(got["exit_layer"]) == 0
    _compare(got, want)
    one = {**BASE, "n_layers": 1}
    ref = _run(_port(one, {"params": {k: v["params"][k] for k in
                                      ("posenc", "transformers_0",
                                       "log_assignment_0")}}), f0, f1)
    np.testing.assert_allclose(got["log_assignment"].numpy(),
                               ref["log_assignment"].numpy(), **TOL)
    assert torch.equal(got["matches0"], ref["matches0"])


def test_prune_everything_unmatches_all(rng):
    _, _, _, want, got = _steered(rng, dict(width_confidence=0.99),
                                  "log_assignment_{}/matchability", 3,
                                  -10.0)
    assert (got["matches0"] == -1).all() and (got["matches1"] == -1).all()
    assert not got["surviving0"].any()
    _compare(got, want)


def test_prune_keep_all_equals_plain(rng):
    f0, f1, v, want, got = _steered(rng, dict(width_confidence=0.99),
                                    "log_assignment_{}/matchability", 3,
                                    10.0)
    _compare(got, want)
    plain = _run(_port(BASE, v, training_heads=True), f0, f1)
    for k in ("log_assignment", "matches0", "matching_scores1"):
        assert torch.equal(got[k], plain[k]), k
    np.testing.assert_array_equal(got["surviving0"].numpy(),
                                  f0["sparse_valid"])


def test_depth_and_width_combined_runs(rng):
    f0, _, _, want, got = _steered(
        rng, dict(depth_confidence=0.95, width_confidence=0.99), None, 0, 0)
    assert 0 <= int(got["exit_layer"]) <= 2
    assert (got["surviving0"].numpy() <= f0["sparse_valid"]).all()
    assert ((got["matches0"] == -1) | got["surviving0"]).all()
    _compare(got, want)


def test_training_ignores_adaptive_flags(rng):
    f0, f1 = _feats(rng), _feats(rng)
    cfg = {**BASE, "depth_confidence": 0.95, "width_confidence": 0.99}
    jm, v = _init(cfg, f0, f1, training=True)
    want = jm.apply(v, _jax(f0), _jax(f1), training=True)
    got = _run(_port(cfg, v, training_heads=True), f0, f1, training=True)
    assert got["all_log_assignments"].shape[1] == 3
    assert "exit_layer" not in got and "exit_layer" not in want
    for k in ("all_log_assignments", "confidence_logits0",
              "confidence_logits1", "log_assignment"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


# ---------------------------------------------------------------------------
# "pallas": the kernels' plain versions at 128 tokens, heads of 64
# ---------------------------------------------------------------------------

KP, DP = 128, 128
PALLAS = dict(input_dim=DP, descriptor_dim=DP, n_layers=3, num_heads=2)


def test_pallas_never_exit_equals_plain_forward(rng):
    """Kernels A and B (their plain versions here): adaptive with no exit
    and nothing pruned is the plain "pallas" forward, bit for bit."""
    f0, f1 = _feats(rng, K=KP, D=DP, pad=8), _feats(rng, K=KP, D=DP, pad=8)
    cfg = {**PALLAS, "attention_impl": "xla",
           "depth_confidence": 0.95, "width_confidence": 0.99}
    _, v = _init(cfg, f0, f1)
    v = _set_bias(v, "token_confidence_{}", 2, -10.0)
    v = _set_bias(v, "log_assignment_{}/matchability", 3, 10.0)
    pallas = {**cfg, "attention_impl": "pallas"}
    assert tlg._pallas_supported(KP, DP // 2, KP)
    got = _run(_port(pallas, v), f0, f1)
    plain = _run(_port({**PALLAS, "attention_impl": "pallas"}, v,
                       training_heads=True), f0, f1)
    assert int(got["exit_layer"]) == 2
    for k in ("log_assignment", "similarity", "matches0", "matches1",
              "matching_scores0"):
        assert torch.equal(got[k], plain[k]), k


def test_pallas_fully_pruned_row_matches_jax(rng):
    """Row 1's tokens are all pruned after layer 0 (the matchability head
    reads descriptor channel 0, which its inputs hold at -100 and row 0's
    at +100): the next layers' kernels see that row's keys all masked.
    Every slot is valid, so the einsum path's joint mask and the kernels'
    key mask agree, and the port under "pallas" equals JAX's einsum path:
    matches, surviving masks and exit exactly, row 0's assignment within
    TOL."""
    f0, f1 = (_feats(rng, K=KP, D=DP, pad=0) for _ in range(2))
    for f in (f0, f1):
        f["sparse_descriptors"][0, :, 0] = 100.0
        f["sparse_descriptors"][1, :, 0] = -100.0
    cfg = {**PALLAS, "attention_impl": "xla", "width_confidence": 0.99}
    jm, v = _init(cfg, f0, f1)
    params = jax.tree_util.tree_map(lambda x: x, v["params"])
    for i in range(3):
        head = params[f"log_assignment_{i}"]["matchability"]
        head["kernel"] = jnp.zeros_like(head["kernel"]).at[0, 0].set(1.0)
        head["bias"] = jnp.zeros_like(head["bias"])
    v = {"params": params}
    want = jax.jit(lambda v: jm.apply(v, _jax(f0), _jax(f1)))(v)
    got = _run(_port({**cfg, "attention_impl": "pallas"}, v), f0, f1)
    assert got["surviving0"][0].all() and not got["surviving0"][1].any()
    assert (got["matches0"][1] == -1).all()
    assert all(torch.isfinite(got[k]).all() for k in
               ("log_assignment", "similarity", "matching_scores0"))
    for k in ("matches0", "matches1", "exit_layer", "surviving0",
              "surviving1"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["log_assignment"][0].numpy(),
                               np.asarray(want["log_assignment"])[0], **TOL)


# ---------------------------------------------------------------------------
# scan_layers: the JAX package's scanned parameter tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("training", [False, True])
def test_scanned_tree_loads_and_matches(rng, training):
    """A scan_layers=True init (layers/layer, log_assignment and, in
    training, token_confidence with a leading (L,) axis) is unstacked by
    `load_jax_variables`; the port's scan_layers model runs it as the
    unrolled loop and equals the JAX scanned forward."""
    f0, f1 = _feats(rng), _feats(rng)
    cfg = {**BASE, "scan_layers": True}
    jm, v = _init(cfg, f0, f1, training=training)
    assert "layers" in v["params"] and ("token_confidence" in v["params"]
                                        ) == training
    sd = load_jax_variables(v)
    assert "transformers.2.self_attn.Wqkv.weight" in sd
    assert ("token_confidence.1.weight" in sd) == training
    want = jm.apply(v, _jax(f0), _jax(f1), training=training)
    got = _run(_port(cfg, v, training_heads=training), f0, f1,
               training=training)
    keys = ("log_assignment", "matching_scores0") + (
        ("all_log_assignments", "confidence_logits0") if training else ())
    np.testing.assert_array_equal(got["matches0"].numpy(),
                                  np.asarray(want["matches0"]))
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    # the same weights unrolled (without training heads the plain model
    # takes the last layer's assignment head alone)
    plain = tlg.LightGlue(tlg.LightGlueConfig(**BASE), training)
    plain.load_state_dict({k: sd[k] for k in plain.state_dict()},
                          strict=True)
    unrolled = _run(plain.eval(), f0, f1, training=training)
    assert torch.equal(unrolled["log_assignment"], got["log_assignment"])


def test_host_syncs_count_the_stop_checks(rng):
    """One host read of the stop decision a layer until the batch stops,
    none with pruning alone."""
    f0, f1 = _feats(rng), _feats(rng)
    for extra, bias, syncs in ((dict(depth_confidence=0.95), -10.0, 2),
                               (dict(depth_confidence=0.5), 10.0, 1),
                               (dict(width_confidence=0.99), None, 0)):
        cfg = {**BASE, **extra}
        _, v = _init(cfg, f0, f1)
        if bias is not None:
            v = _set_bias(v, "token_confidence_{}", 2, bias)
        model = _port(cfg, v)
        tlg.LightGlue.host_syncs = 0
        _run(model, f0, f1)
        assert tlg.LightGlue.host_syncs == syncs, extra
    model = _port(dataclasses.asdict(tlg.LightGlueConfig(**BASE)), v,
                  training_heads=True)
    tlg.LightGlue.host_syncs = 0
    _run(model, f0, f1)
    assert tlg.LightGlue.host_syncs == 0
