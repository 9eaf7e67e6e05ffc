#!/usr/bin/env python3
"""The port's step counts against XLA's ``cost_analysis`` on the CPU.

    JAX_PLATFORMS=cpu PYTHONPATH=src python3 tools/capture_vs_cost_analysis.py

For the reduced configs of a few archs, one train step (batch 2 × 16,
SGD + momentum, no microbatches) is counted twice: by the port's
``launch.hlo_analysis.StepCounter`` on fake tensors, and by the JAX
package's compiled step (``jax.jit(make_train_step(...)).lower(...)
.compile().cost_analysis()``, the layer scan unrolled so that XLA counts
every layer, as the JAX dry run's correction does).  Prints one JSON
line per arch: FLOPs and bytes on each side and their ratios.  A record,
not a check: XLA counts elementwise FLOPs (the port's counter counts
only the matmul class) and bytes per fusion after its optimisations.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("tinyllama-1.1b", "qwen1.5-0.5b", "deepseek-v2-lite-16b",
         "mamba2-1.3b")
B, S = 2, 16


def port_counts(arch: str):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_reduced, params_specs
    from repro_torch.launch.hlo_analysis import StepCounter
    from repro_torch.launch.steps import (TrainSpec, init_momentum,
                                          make_train_step)
    from repro_torch.utils import tree_math as tm
    cfg = get_reduced(arch)
    step = make_train_step(cfg, TrainSpec())
    with FakeTensorMode():
        params = tm.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype),
                             params_specs(cfg))
        mom = init_momentum(params)
        batch = {k: torch.empty((B, S), dtype=torch.int32)
                 for k in ("tokens", "labels")}
        with StepCounter() as c:
            step(params, mom, batch)
    return c.flops, c.bytes


def jax_counts(arch: str):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.launch.steps import TrainSpec, make_train_step
    from repro.models.transformer import init_lm
    cfg = dataclasses.replace(get_reduced(arch), scan_unroll=True)
    params = jax.eval_shape(lambda k: init_lm(k, cfg), jax.random.PRNGKey(0))
    mom = jax.tree_util.tree_map(
        lambda p: jax.ShapeDtypeStruct(p.shape, jnp.float32), params)
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    step = jax.jit(make_train_step(cfg, TrainSpec()))
    cost = step.lower(params, mom, batch).compile().cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    return float(cost["flops"]), float(cost["bytes accessed"])


def main() -> int:
    for arch in ARCHS:
        pf, pb = port_counts(arch)
        jf, jb = jax_counts(arch)
        print(json.dumps(dict(arch=arch, batch=B, seq=S, port_flops=pf,
                              port_bytes=pb, xla_flops=jf, xla_bytes=jb,
                              flops_ratio=pf / jf, bytes_ratio=pb / jb)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
