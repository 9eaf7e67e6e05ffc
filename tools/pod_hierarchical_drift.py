#!/usr/bin/env python3
"""How far hierarchical and sequential pod aggregation drift apart.

    PYTHONPATH=src python3 tools/pod_hierarchical_drift.py ROUNDS [--device cpu]

Runs ``chip_smoke.pod_hierarchical``'s comparison (LeNet-5 on
cifar10-like, the pod P2 of ``chip_smoke.pod_configs`` on a one-rank
mesh, ``aggregation="hierarchical", n_pods=2`` against sequential) for
ROUNDS rounds from four starts: the seed's init and three copies of it
with every weight moved by one unit in the last place (random sign).
The two aggregations differ only in the order of addition, so after
one round they agree to an ulp; every later round's SGD steps amplify
that difference by a factor that depends on the start.  Prints, per
start, the largest |hierarchical − sequential| and whether
``chip_smoke``'s gate (rtol 1e-5, atol 1e-7) holds.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rounds", type=int)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    import chip_smoke as cs
    from repro_torch.fl.pod import run_pod_rounds
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.utils import tree_math as tm

    task, data = cs.lenet_setup()
    mesh = make_host_mesh(args.device)
    base = task.init(torch.Generator().manual_seed(cs.SEED))

    def start(k):
        if k == 0:
            return base
        gen = torch.Generator().manual_seed(k)
        return tm.tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.sign(
            torch.randn(t.shape, generator=gen))), base)

    for k in range(4):
        finals = {}
        for agg, kw in (("sequential", {}),
                        ("hierarchical", {"aggregation": "hierarchical",
                                          "n_pods": 2})):
            _, fed = cs.pod_configs(mesh, rounds=args.rounds, cfg_kw=kw)
            res = run_pod_rounds(task, data, fed, init_params=start(k),
                                 device=args.device)
            finals[agg] = tm.tree_leaves(res.params)
        pairs = list(zip(finals["hierarchical"], finals["sequential"]))
        print(dict(rounds=args.rounds, start="seed" if k == 0 else
                   f"seed + 1 ulp ({k})",
                   max_abs_diff=max(float((a - b).abs().max())
                                    for a, b in pairs),
                   gate=all(torch.allclose(a, b, rtol=1e-5, atol=1e-7)
                            for a, b in pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
