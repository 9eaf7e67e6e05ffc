#!/usr/bin/env python3
"""XLA's per-device dot FLOPs of the JAX dry run's train step, dot by dot.

    JAX_PLATFORMS=cpu PYTHONPATH=src \\
        XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python3 tools/xla_dot_flops.py mamba2-1.3b [TOP]

For the reduced config of the arch, the JAX package's
``launch.dryrun.build_lowered`` step (batch 8 × 16, the layer scan
unrolled, as ``tests/test_torch_dryrun.py`` compiles it) is compiled on
the (1, 1), (2, 2) and (1, 4) meshes of ``repro.launch.mesh._make_mesh``,
and the compiled HLO's ``dot`` instructions are read: 2 × the output's
elements × the contracted size each.  Prints one JSON line per mesh:
``cost_analysis``'s FLOPs, the dots' sum, and the TOP largest dots
(FLOPs, lhs, rhs and output shapes, the source op's name).  It shows
where XLA's partitioner computes more than its share: a dot whose output
is not split over ``model`` on a mesh that has one.
"""
from __future__ import annotations

import dataclasses
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

MESHES = ((1, 1), (2, 2), (1, 4))
B, S = 8, 16
_INSTR = re.compile(r"\s*(?:ROOT )?(%[\w.\-]+) = \w+\[([\d,]*)\]\S* ([\w\-]+)\((.*)")


def dots(hlo: str):
    """``(flops, lhs, rhs, out, op_name)`` of every dot of ``hlo``."""
    shapes, out = {}, []
    for line in hlo.splitlines():
        m = _INSTR.match(line)
        if not m:
            continue
        name, dims, op, rest = m.groups()
        shapes[name] = [int(d) for d in dims.split(",") if d]
        if op != "dot":
            continue
        lhs = shapes[re.findall(r"%[\w.\-]+", rest)[0]]
        rhs = shapes[re.findall(r"%[\w.\-]+", rest)[1]]
        contract = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", rest)
        k = 1
        for d in contract.group(1).split(","):
            if d:
                k *= lhs[int(d)]
        n = 1
        for d in shapes[name]:
            n *= d
        meta = re.search(r'op_name="([^"]*)"', line)
        out.append((2 * n * k, lhs, rhs, shapes[name],
                    meta.group(1) if meta else ""))
    return out


def main(arch: str, top: int = 8) -> None:
    import jax
    jax.devices()       # the backend before repro.launch.dryrun sets 512
    import numpy as np
    from repro.configs import get_reduced
    from repro.configs.common import ShapeSpec
    from repro.launch.dryrun import build_lowered
    from repro.launch.mesh import _make_mesh
    cfg = dataclasses.replace(get_reduced(arch), scan_unroll=True)
    for shape in MESHES:
        mesh = (jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                                  ("data", "model")) if shape == (1, 1)
                else _make_mesh(shape, ("data", "model")))
        comp = build_lowered(cfg, ShapeSpec("t", "train", S, B),
                             mesh).compile()
        cost = comp.cost_analysis()
        cost = cost[0] if isinstance(cost, (list, tuple)) else cost
        found = sorted(dots(comp.as_text()), key=lambda d: -d[0])
        print(json.dumps(dict(
            arch=arch, mesh=list(shape), flops=float(cost["flops"]),
            dot_flops=sum(d[0] for d in found),
            top=[dict(flops=f, lhs=l, rhs=r, out=o, op=n[-80:])
                 for f, l, r, o, n in found[:top]])), flush=True)


if __name__ == "__main__":
    main(sys.argv[1], *(int(a) for a in sys.argv[2:3]))
