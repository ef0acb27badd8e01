"""Inputs on which kernel F's c = rowsum(dP o P) decides the gradients
(`tests/test_torch_bwd_cancel.py` on the CPU against the JAX package,
`tests/test_torch_cuda.py` on the card against the plain version).

dS = P o (dP - c) cancels where dP_j - c is small beside dP_j, and then
any error in c, such as taking it as rowsum(dO o O) from an output
rounded to bfloat16 (~2^-9 |dO| |O|), rules dQ and dK:
 - "collapsed": every value row a shared mean (norm ~24) plus noise of
   spread 0.01, as with random or collapsed weights: O is the mean, and
   dP_j - c = dO . (v_j - O) is a hundredth of dP_j;
 - "one-hot": q and k scaled by 8, so that each row's softmax is one-hot
   and P_j (dP_j - c) vanishes but for rounding.
This module imports numpy only (no torch, no JAX), so the card's tests
load it without JAX.
"""

from __future__ import annotations

import numpy as np

CASES = ("collapsed", "one-hot")


def bwd_case(case: str, B: int, h: int, N: int, M: int, d: int,
             seed: int = 0):
    """(q (B, h, N, d), k, v (B, h, M, d), do (B, h, N, d), mask (B, M))
    float32 arrays (the mask bool, ~80% of the keys live) of `case`, made
    from `seed`."""
    if case not in CASES:
        raise ValueError(f"unknown case {case!r}; one of {CASES}")
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, h, N, d))
    k = rng.normal(size=(B, h, M, d))
    do = rng.normal(size=(B, h, N, d))
    mask = rng.uniform(size=(B, M)) > 0.2
    if case == "collapsed":
        v = (rng.normal(0.0, 3.0, size=(B, h, 1, d))
             + 0.01 * rng.normal(size=(B, h, M, d)))
    else:
        q, k = 8.0 * q, 8.0 * k
        v = rng.normal(size=(B, h, M, d))
    f32 = np.float32
    return q.astype(f32), k.astype(f32), v.astype(f32), do.astype(f32), mask
