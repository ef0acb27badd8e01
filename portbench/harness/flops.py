"""Operations counted from shapes, and the chip's peaks.

The peak is one NVIDIA H100 SXM's TF32 rate (NVIDIA's data sheet,
dense): 495 TFLOP/s. A float32 input reaches the tensor cores only as
TF32 (or split into TF32 parts), so no float32 kernel can run faster: it
is the float32 ceiling of every share here, whatever implements the
kernel.

Attention operations are counted once from shapes, as the kernel table
of PERF.md does: a call of self- or one-way attention (kernels A, D)
4 B h N M d; the bidirectional cross-attention (B) 6 B h N M d (one score
matrix, two products with V); the backward (F) 10 B h N M d. Model FLOPs
(for `mfu.*`) count every convolution and linear layer from the shapes
the model's modules see in one forward (captured by hooks at set-up),
attention by the same formulas, the assignment heads' similarity
2 B N M D each, and a backward as twice its forward for what trains.
"""

from __future__ import annotations

from typing import Dict

PEAK = 495e12

# the float32 kernels each role runs: kernel-name fragment -> operations
# formula; the pack passes and F's c pass are part of their kernels' time
# but add no operation
ATTN_KERNELS = {
    "serve": {"self_attention_tf32_kernel": "self",
              "cross_attention_tf32_kernel": "cross"},
    "train": {"attention_fwd_tf32_kernel": "self",
              "attention_bwd_tf32_kernel": "bwd"},
}
ATTN_SUPPORT = ("attention_pack_tf32_kernel",
                "attention_bwd_rowsum_tf32_kernel")
FACTOR = {"self": 4, "cross": 6, "bwd": 10}


def attention_ops(kind: str, B: int, h: int, N: int, M: int, d: int
                  ) -> float:
    return float(FACTOR[kind] * B * h * N * M * d)


def attn_roofline(trace, role: str, shape: Dict[str, int]):
    """Share (%) of the attention kernels' bound: their operations over
    the peak, divided by their device time (loops, pack passes and c
    passes). None where no such kernel ran."""
    table = ATTN_KERNELS[role]
    secs, calls = trace.op_seconds(list(table))
    if not calls:
        return None
    support, _ = trace.op_seconds(ATTN_SUPPORT)
    bound = sum(n * attention_ops(table[f], shape["B"], shape["h"],
                                  shape["N"], shape["M"], shape["d"])
                for f, n in calls.items()) / PEAK
    return 100.0 * bound / (secs + support)


class FlopCounter:
    """Forward hooks on every Conv2d and Linear of a model that add up
    their FLOPs, split into what trains and what does not."""

    def __init__(self, model, trains=lambda name: False):
        import torch.nn as nn
        self.frozen = 0.0
        self.trained = 0.0
        self.handles = []
        for name, m in model.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                self.handles.append(m.register_forward_hook(
                    self._hook(trains(name))))

    def _hook(self, trained: bool):
        import torch.nn as nn

        def hook(m, inputs, out):
            if isinstance(m, nn.Conv2d):
                k = m.in_channels // m.groups * m.kernel_size[0] \
                    * m.kernel_size[1]
            else:
                k = m.in_features
            f = 2.0 * out.numel() * k
            if trained:
                self.trained += f
            else:
                self.frozen += f
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()


def lightglue_attention_flops(B: int, N: int, M: int, D: int, heads: int,
                              layers: int, assignment_heads: int) -> float:
    """Attention and assignment-similarity FLOPs of one LightGlue forward:
    per layer the self-attention of both sides and the bidirectional
    cross-attention; 2 B N M D per assignment head."""
    d = D // heads
    per_layer = (attention_ops("self", B, heads, N, N, d)
                 + attention_ops("self", B, heads, M, M, d)
                 + attention_ops("cross", B, heads, N, M, d))
    return layers * per_layer + assignment_heads * 2.0 * B * N * M * D
