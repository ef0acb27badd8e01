"""Operation counts against hand counts at a tiny shape: the FLOP counter's
convolutions and linears, the attention formulas, and the roofline share
over a made-up trace."""

import pytest
import torch
import torch.nn as nn

from portbench.harness import flops


def test_conv_and_linear_flops_by_hand():
    model = nn.Sequential(nn.Conv2d(3, 5, 3, padding=1), nn.ReLU(),
                          nn.Flatten(), nn.Linear(5 * 4 * 6, 7))
    counter = flops.FlopCounter(model, lambda n: n == "3")
    model(torch.zeros(2, 3, 4, 6))
    counter.remove()
    # conv: 2 * (2*5*4*6 outputs) * (3*3*3 taps); linear: 2 * 2*7 * 120
    assert counter.frozen == 2 * (2 * 5 * 4 * 6) * 27
    assert counter.trained == 2 * (2 * 7) * 120
    model(torch.zeros(1, 3, 4, 6))
    assert counter.trained == 2 * (2 * 7) * 120      # hooks removed


def test_attention_formulas():
    assert flops.attention_ops("self", 2, 4, 8, 16, 64) == 4 * 2 * 4 * 8 \
        * 16 * 64
    assert flops.attention_ops("cross", 1, 1, 2, 3, 4) == 6 * 24
    assert flops.attention_ops("bwd", 1, 1, 2, 3, 4) == 10 * 24
    # one layer, N=M=2, D=8 over 2 heads (d=4), one assignment head
    per_layer = 2 * (4 * 1 * 2 * 2 * 2 * 4) + 6 * 1 * 2 * 2 * 2 * 4
    assert flops.lightglue_attention_flops(1, 2, 2, 8, 2, 1, 1) == \
        per_layer + 2 * 1 * 2 * 2 * 8


class FakeTrace:
    def __init__(self, ops):
        self.ops = ops

    op_seconds = __import__("portbench.harness.trace", fromlist=["Trace"]
                            ).Trace.op_seconds


def test_roofline_share_by_hand():
    shape = {"B": 16, "h": 4, "N": 1024, "M": 1024, "d": 64}
    a = 4 * 16 * 4 * 1024 * 1024 * 64
    b = 6 * 16 * 4 * 1024 * 1024 * 64
    # 2 A loops of 0.3 ms, 1 B loop of 0.5 ms, 3 pack passes of 0.1 ms
    ops = [("void self_attention_tf32_kernel<4>", 0, 300),
           ("void self_attention_tf32_kernel<4>", 400, 700),
           ("cross_attention_tf32_kernel", 800, 1300),
           ("attention_pack_tf32_kernel", 1300, 1400),
           ("attention_pack_tf32_kernel", 1400, 1500),
           ("attention_pack_tf32_kernel", 1500, 1600),
           ("ampere_sgemm", 1600, 9000)]
    share = flops.attn_roofline(FakeTrace(ops), "serve", shape)
    want = 100 * ((2 * a + b) / 495e12) / 1.4e-3
    assert share == pytest.approx(want, rel=1e-12)
    assert flops.attn_roofline(FakeTrace(ops[-1:]), "serve", shape) is None


def test_trace_union_and_idle():
    from portbench.harness.trace import Trace
    t = Trace.__new__(Trace)
    t.ops = [("a", 0, 10), ("b", 5, 12), ("c", 20, 30), ("d", 22, 25)]
    busy, idle = Trace._union(t)
    assert busy == 22 and idle == [(12, 20)]
