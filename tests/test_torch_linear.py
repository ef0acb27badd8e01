"""Kernel L's arithmetic and route on the CPU (`ops/linear_kernel.py`,
`models/layers.py:Linear`): the plain version against a float64 product
at LightGlue's flagship shapes, W's planes in the order the kernel's
register fragments read x, the rule that picks which calls take the
kernel, and the FFN's fused form. The kernel itself runs only on the card
(`tests/test_torch_cuda.py`, `-k linear`).

Tolerance: 1e-4 x max(1, max|ref|), the 3xTF32 tolerance of
`csrc/flash_tf32.cuh`; a single TF32 product misses it at these shapes,
and the 3xTF32 product also stays within float32's own relative error
(~3e-7 over the whole output)."""

import torch
import torch.nn.functional as F

import pytest

from ei_nexus_tpu_torch.models.layers import Linear, init_parameters
from ei_nexus_tpu_torch.models.lightglue import (LightGlue, LightGlueConfig,
                                                 _ffn, _ffn_residual)
from ei_nexus_tpu_torch.ops import linear_kernel as lk
from ei_nexus_tpu_torch.ops.attention_kernels import tf32_split_plain
from test_torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4

# (M tokens, K, N): a 16-pair batch of 1024 slots a side through Wqkv,
# the square projections, the FFN's two products, and a ragged M
SHAPES = [(16384, 256, 768), (16384, 256, 256), (16384, 512, 512),
          (16384, 512, 256), (3001, 256, 256)]


def _problem(M, K, N, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g) * K ** -0.5
    b = torch.randn(N, generator=g) * 0.1
    return x, w, b


@pytest.mark.parametrize("M,K,N", SHAPES)
def test_plain_matches_a_float64_product(M, K, N):
    x, w, b = _problem(M, K, N)
    ref = F.linear(x.double(), w.double(), b.double())
    err = (lk.linear_tf32_plain(x, w, b).double() - ref)
    bound = TOL * max(1.0, float(ref.abs().max()))
    assert float(err.abs().max()) <= bound
    assert float(err.norm() / ref.norm()) <= 1e-6
    # the tolerance tells 3xTF32 from one TF32 product
    xh, _ = tf32_split_plain(x)
    wh, _ = tf32_split_plain(w)
    one = (F.linear(xh, wh, b).double() - ref).abs().max()
    assert float(one) > bound


def test_planes_split_the_weight_in_fragment_order():
    """Each plane position holds the column `linear_k_order` names, split
    as the pack pass splits (hi + lo = W to 2^-22), zeros past K; the order
    is the one the kernel's lanes build their A fragments in: lane t loads
    columns 4t..4t+3 of a 16-column group, slice q of the group takes
    columns 4t + 2q and 4t + 2q + 1 as A columns t and t + 4."""
    N, K = 24, 52
    w = torch.randn(N, K, generator=torch.Generator().manual_seed(1))
    planes = lk.weight_planes(w)
    assert planes.shape == (2, N, 64) and planes.is_contiguous()
    order = lk.linear_k_order(64)
    lanes = torch.empty(64, dtype=torch.long)
    for p in range(4):              # 16-column groups
        for q in range(2):          # the group's k8 slices
            for t in range(4):      # lanes of a quad
                for h in range(2):  # A column t (h = 0) or t + 4
                    lanes[16 * p + 8 * q + 4 * h + t] = 16 * p + 4 * t \
                        + 2 * q + h
    assert torch.equal(order, lanes)
    assert torch.equal(torch.sort(order).values, torch.arange(64))
    padded = torch.zeros(N, 64)
    padded[:, :K] = w
    hi, lo = tf32_split_plain(padded[:, order])
    assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
    assert (planes[:, :, order >= K] == 0).all()
    assert float(((hi + lo) - padded[:, order]).abs().max()) \
        <= 2 ** -22 * float(w.abs().max())


def test_fragment_order_product_matches_the_plain_version():
    """The kernel's sum: x's columns as its lanes load them against W's
    planes, slice by slice, the small products first; equal to the plain
    version to float32 rounding."""
    M, K, N = 96, 100, 40
    x, w, b = _problem(M, K, N, seed=2)
    planes = lk.weight_planes(w)
    kp = planes.shape[-1]
    xp = torch.zeros(M, kp)
    xp[:, :K] = x
    xh, xl = tf32_split_plain(xp[:, lk.linear_k_order(kp)])
    acc = torch.zeros(M, N, dtype=torch.float64)
    for c in range(kp // 32):
        s = slice(32 * c, 32 * c + 32)
        for a, p in ((xl, planes[0]), (xh, planes[1]), (xh, planes[0])):
            acc += a[:, s].double() @ p[:, s].double().T
    got = (acc.float() + b).double()
    want = lk.linear_tf32_plain(x, w, b).double()
    assert float((got - want).abs().max()) <= 1e-5


def test_parts_and_residual():
    """Two parts of K read as their concatenation; the residual added last,
    in the plain version and through `Linear.forward` on the CPU, which
    keeps F.linear bit for bit."""
    x, w, b = _problem(64, 64, 32, seed=3)
    m = torch.randn(64, 32, generator=torch.Generator().manual_seed(4))
    r = torch.randn(64, 32, generator=torch.Generator().manual_seed(5))
    w2 = torch.randn(32, 96, generator=torch.Generator().manual_seed(6))
    got = lk.linear_tf32((x, m), w2, b, r)
    want = r + lk.linear_tf32_plain(torch.cat([x, m], -1), w2, b)
    assert torch.equal(got, want)
    layer = Linear(96, 32)
    with torch.no_grad():
        layer.weight.copy_(w2)
        layer.bias.copy_(b)
        assert torch.equal(layer((x, m), residual=r),
                           r + F.linear(torch.cat([x, m], -1), w2, b))


def test_ffn_residual_is_the_block_ffn():
    ffn = _ffn(16, torch.float32)
    init_parameters(ffn, torch.Generator().manual_seed(7))
    g = torch.Generator().manual_seed(8)
    x, m = torch.randn(2, 5, 16, generator=g), torch.randn(2, 5, 16,
                                                           generator=g)
    with torch.no_grad():
        want = x + ffn(torch.cat([x, m], -1))
        assert torch.equal(_ffn_residual(ffn, x, m), want)


def _lightglue(dtype="float32"):
    model = LightGlue(LightGlueConfig(input_dim=32, descriptor_dim=32,
                                      n_layers=2, num_heads=2, dtype=dtype))
    init_parameters(model, torch.Generator().manual_seed(9))
    return model


def test_route_rule_over_a_float32_lightglue():
    """Every float32 linear of LightGlue takes the kernel on the card but
    the positional encoder's Wr (K = 2) and the matchability head (N = 1);
    none in bf16, under an autograd graph or on the CPU."""
    model = _lightglue()
    linears = {n: m for n, m in model.named_modules()
               if isinstance(m, Linear)}

    def routed(dtype=torch.float32, device="cuda", graph=False):
        return {n for n, m in linears.items() if lk.linear_route(
            m.in_features, m.out_features, dtype, device, graph)}

    per_layer = {"self_attn.Wqkv", "self_attn.out_proj", "self_attn.ffn.0",
                 "self_attn.ffn.3", "cross_attn.to_qk", "cross_attn.to_v",
                 "cross_attn.to_out", "cross_attn.ffn.0", "cross_attn.ffn.3"}
    assert routed() == {f"transformers.{i}.{n}" for i in range(2)
                        for n in per_layer} | {"log_assignment.1.final_proj"}
    assert set(linears) - routed() == {"posenc.Wr",
                                       "log_assignment.1.matchability"}
    assert routed(dtype=torch.bfloat16) == set()
    assert routed(graph=True) == set()
    assert routed(device="cpu") == set()


def test_graph_is_wanted_under_grad_only():
    layer = Linear(8, 8)
    x = torch.randn(3, 8)
    assert layer.wants_graph(x)
    with torch.no_grad():
        assert not layer.wants_graph(x)
    layer.requires_grad_(False)
    assert not layer.wants_graph(x)
    assert layer.wants_graph(x.requires_grad_())
    assert layer.wants_graph(None, torch.ones(1, requires_grad=True))


def test_weight_planes_are_kept_until_the_weight_changes():
    layer = Linear(8, 12)
    planes = layer.weight_planes()
    assert layer.weight_planes() is planes
    with torch.no_grad():
        layer.weight.mul_(2.0)
    again = layer.weight_planes()
    assert again is not planes
    assert torch.equal(again, lk.weight_planes(layer.weight))
    layer.weight = torch.nn.Parameter(torch.ones(12, 8))
    assert torch.equal(layer.weight_planes(), lk.weight_planes(
        torch.ones(12, 8)))


def test_cpu_forward_launches_nothing():
    model = _lightglue().eval()
    g = torch.Generator().manual_seed(10)

    def feats():
        return {"sparse_descriptors": torch.randn(2, 16, 32, generator=g),
                "sparse_positions": torch.rand(2, 16, 3, generator=g) * 60,
                "sparse_valid": torch.rand(2, 16, generator=g) > 0.1,
                "image_size": torch.full((2, 2), 64.0)}

    before = (lk.linear_tf32.launches, lk.linear_tf32.plane_builds)
    with torch.no_grad():
        out = model(feats(), feats())
    assert torch.isfinite(out["log_assignment"]).all()
    assert (lk.linear_tf32.launches, lk.linear_tf32.plane_builds) == before


def test_the_card_wrapper_refuses_what_the_kernel_does_not_take():
    """Checks that run before any launch (a meta tensor stands in for the
    card's: the wrapper reads only shapes, types and the device type)."""
    w = torch.empty(8, 6, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.linear_tf32(torch.empty(4, 6, device="meta"), w)
