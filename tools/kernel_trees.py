#!/usr/bin/env python3
"""Time one port kernel of two source trees, in turns, on one CUDA card.

    python3 tools/kernel_trees.py KERNEL OLD_TREE NEW_TREE [--dtypes D,..]

KERNEL names a ``chip_smoke.KernelBench`` method with cases in
``chip_smoke.KERNEL_CASES`` (``flash_attention``, ``ssd_scan``).  The cases
are NEW_TREE's.  The turns run OLD, NEW, NEW, OLD: each is a subprocess
that imports that tree's ``chip_smoke.KernelBench`` (so each tree builds
and times its own kernel, under its own ``build/``) and calls the method
at every case in each dtype of ``--dtypes`` (default bfloat16, the serve
path's): the kernel's ms, the library call's, the bound and the error
against the plain version.  Prints one JSON line per (turn, case, dtype),
then one line with each tree's median kernel ms per case and dtype;
exits 1 if any case leaves its tolerance.  To compare a
commit with its parent, unpack the parent into a directory that
``.gitignore`` lists:

    mkdir -p build/parent && git archive HEAD~1 | tar -x -C build/parent
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

TURN = r"""
import json, sys
tree, kernel, cases, dtypes = sys.argv[1:5]
sys.path[:0] = [tree, tree + "/src"]
import torch
import chip_smoke as cs
from repro_torch.kernels import fused_update as fu
bench = cs.KernelBench(torch, fu, cs.card_peaks(torch.cuda.get_device_name(0)))
for dtype in dtypes.split(","):
    for label, kw in json.loads(cases).items():
        r = getattr(bench, kernel)(dtype=getattr(torch, dtype), label=label,
                                   **kw)
        print(json.dumps(dict(tree=tree, case=label, dtype=dtype, ms=r["ms"],
                              library_ms=r["library_ms"],
                              bound_ms=r["bound_ms"],
                              max_abs_err=r["max_abs_err"],
                              within_tol=r["within_tol"])), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel")
    ap.add_argument("old")
    ap.add_argument("new")
    ap.add_argument("--dtypes", default="bfloat16",
                    help="comma-separated torch dtype names")
    args = ap.parse_args(argv)
    old, new = (str(Path(a).resolve()) for a in (args.old, args.new))
    sys.path.insert(0, new)
    from chip_smoke import KERNEL_CASES
    if args.kernel not in KERNEL_CASES:
        ap.error(f"no cases for {args.kernel!r}: one of {list(KERNEL_CASES)}")
    cases = KERNEL_CASES[args.kernel]
    rows = []
    for tree in (old, new, new, old):
        out = subprocess.run([sys.executable, "-c", TURN, tree, args.kernel,
                              json.dumps(cases), args.dtypes], cwd=tree,
                             check=True, capture_output=True, text=True,
                             timeout=900)
        for line in out.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    summary = {tree: {f"{lbl}_{dt}": statistics.median(
        r["ms"] for r in rows
        if r["tree"] == tree and r["case"] == lbl and r["dtype"] == dt)
        for dt in args.dtypes.split(",") for lbl in cases}
        for tree in (old, new)}
    ok = all(r["within_tol"] for r in rows)
    print(json.dumps(dict(kernel=args.kernel, median_ms=summary,
                          all_within_tol=ok)))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
