"""Warmup: prime the scoring path before the timed loop.

Counterpart of ``symbolicregression_jl_tpu/models/warmup.py`` (the reference
precompiles its workload, SymbolicRegression.jl/src/precompile.jl:36-93).
The JAX package compiles one program per (node bucket, batch bucket) and so
warms every bucket. PyTorch runs eagerly and the fused loss kernel takes any
batch and row count, so one scoring call primes everything: the kernel's
build and load (at first use) and the CUDA context. Warmup draws no random
numbers, so search trajectories are identical with ``jit_warmup`` on or off.
"""

from __future__ import annotations

from ..tree import constant

__all__ = ["warmup_host_programs"]


def warmup_host_programs(scorer, options) -> None:
    saved_evals = scorer.num_evals
    scorer.loss_many([constant(1.0)])
    # warmup evals are not search work: keep the throughput metric honest
    scorer.num_evals = saved_evals
