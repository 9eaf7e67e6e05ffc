"""Compare the kernel rows of two or more ``chip_smoke.py`` logs.

Reads the ``{"kernels": [...]}`` line each log holds and prints, for
every row (a kernel's main row and each of its forms that carries an
``ms``: ``charlm``, ``c_form``, the ``shapes`` of K7, ...), the ``ms``
of each log and the ratio of each to the first:

    python3 tools/compare_kernel_rows.py BEFORE.log AFTER.log [MORE.log]

The last line is a JSON summary: per log, the median and the range of
the ratios to the first log.
"""
from __future__ import annotations

import json
import statistics
import sys
from typing import Dict


def kernel_rows(path: str) -> Dict[str, float]:
    """``{row label: ms}`` from the log's kernels line."""
    line = next(ln for ln in open(path, errors="replace")
                if ln.startswith('{"kernels":'))
    rows: Dict[str, float] = {}

    def walk(label: str, obj) -> None:
        if isinstance(obj, dict):
            if isinstance(obj.get("ms"), (int, float)):
                rows[label] = float(obj["ms"])
            for k, v in obj.items():
                if isinstance(v, dict):
                    walk(f"{label}.{k}", v)
    for k in json.loads(line)["kernels"]:
        walk(k["name"], k)
    return rows


def main(paths) -> int:
    logs = [kernel_rows(p) for p in paths]
    common = [k for k in logs[0] if all(k in log for log in logs[1:])]
    ratios = [[] for _ in logs[1:]]
    width = max(len(k) for k in common)
    for k in common:
        ms = [log[k] for log in logs]
        cells = [f"{ms[0]:.6g}"]
        for i, m in enumerate(ms[1:]):
            r = m / ms[0] if ms[0] else float("nan")
            ratios[i].append(r)
            cells.append(f"{m:.6g} ({r:.3f})")
        print(f"{k:<{width}}  " + "  ".join(cells))
    print(json.dumps({"rows": len(common), "logs": list(paths), "ratio_to_first": [
        dict(median=statistics.median(r), min=min(r), max=max(r))
        for r in ratios]}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    sys.exit(main(sys.argv[1:]))
