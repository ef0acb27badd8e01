"""Run setup: seeds and determinism switches.

Counterpart of `ei_nexus_tpu/utils/setup.py` (the reference's
`utils/common.py:22`): Python's, numpy's and torch's generators seeded,
cuDNN deterministic with its autotuner off, TF32 off for matmuls and
convolutions. Returns a seeded `torch.Generator` where the JAX package
returns its root PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def setup(seed: int = 3407, deterministic: bool = False
          ) -> torch.Generator:
    """Seed every host generator and torch's (all devices); cuDNN
    deterministic, no autotuning, no TF32. `deterministic` also asks
    torch for deterministic algorithms everywhere (an operator without
    one raises), the counterpart of the JAX package's deterministic XLA
    reductions. Returns a CPU `torch.Generator` seeded with `seed`."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if deterministic:
        torch.use_deterministic_algorithms(True)
    return torch.Generator().manual_seed(seed)
