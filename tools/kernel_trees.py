#!/usr/bin/env python3
"""Time one port kernel of two source trees, in turns, on one CUDA card.

    python3 tools/kernel_trees.py KERNEL OLD_TREE NEW_TREE [--dtypes D,..]

KERNEL names a ``chip_smoke.KernelBench`` method with cases in
``chip_smoke.KERNEL_CASES`` (``flash_attention``, ``ssd_scan``,
``local_step``, ``topk_threshold``, ``compress_delta``,
``topk_compress``, ``delta_accum``, ``server_update``,
``dp_clip_noise``, and the profiled ``sgd_step``, ``p2_round``,
``pod_round`` and ``dp_upload``).  The cases and the measuring code are NEW_TREE's
``chip_smoke``; the kernels are each tree's.  The turns run OLD, NEW,
NEW, OLD: each is a subprocess that imports NEW_TREE's
``chip_smoke.KernelBench`` with that tree's ``repro_torch`` package
first on the path (so each tree builds and times its own kernels, under
its own ``build/``) and calls the method at every case in each dtype of
``--dtypes`` (default bfloat16, the serve path's; pass float32 for the
others, which ignore it where they have one type): the kernel's
ms, the library call's, the bound, the error against the plain version
and whatever else the method reports.  Prints one JSON line per (turn,
case, dtype), then one line with each tree's median ms per case and
dtype; exits 1 if any case leaves its tolerance.  To compare a
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
harness, tree, kernel, cases, dtypes = sys.argv[1:6]
sys.path.insert(0, harness)
import chip_smoke as cs          # puts the harness's src first: undo that
sys.path.insert(0, tree + "/src")
import torch
from repro_torch.kernels import fused_update as fu
assert fu.__file__.startswith(tree), fu.__file__
bench = cs.KernelBench(torch, fu, cs.card_peaks(torch.cuda.get_device_name(0)))
for dtype in dtypes.split(","):
    for label, kw in json.loads(cases).items():
        r = getattr(bench, kernel)(dtype=getattr(torch, dtype), label=label,
                                   **kw)
        keep = {k: v for k, v in r.items()
                if isinstance(v, (bool, int, float, str, list, type(None)))
                and k not in ("tree", "case", "dtype")}
        print(json.dumps(dict(tree=tree, case=label, dtype=dtype, **keep)),
              flush=True)
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
        out = subprocess.run([sys.executable, "-c", TURN, new, tree,
                              args.kernel, json.dumps(cases), args.dtypes],
                             cwd=tree, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            print(out.stdout + out.stderr, file=sys.stderr, flush=True)
            return out.returncode
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
