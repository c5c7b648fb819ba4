"""Parent/change timing on one CUDA card: each tree's own chip_smoke.py, in turns.

    python3 chip_ab.py [--logs DIR] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.``).  For each, in the order given (parent,
change, change, parent compares two trees on one card), this runs that
tree's ``chip_smoke.py`` from its root, so each tree builds its own kernels
and times them with its own code, and reads the times it prints: ms per
forward (phase 6) and ms per train step (phase 8).  Then a table of the runs
side by side, with the card's ``name, power.limit``.  ``--logs DIR`` keeps
each run's whole output.  Exits with the first failing run's code.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

TIMES = (re.compile(r"^Tramba-V-TSOD 384px (\w+ B\d+): ([\d.]+) ms/forward"),
         re.compile(r"^Tramba-V-TSOD 384px (\w+ train) step (B\d+): ([\d.]+) ms/step"))


def times(stdout: str) -> dict:
    """{"fp32 B1": ms, ..., "bf16 train B4": ms} from a chip_smoke.py output."""
    out = {}
    for line in stdout.splitlines():
        if m := TIMES[0].match(line):
            out[m[1]] = float(m[2])
        elif m := TIMES[1].match(line):
            out[f"{m[1]} {m[2]}"] = float(m[3])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", default="", help="directory for each run's whole output")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        res = subprocess.run([sys.executable, os.path.join(root, "chip_smoke.py")], cwd=root,
                             capture_output=True, text=True, timeout=1500)
        if args.logs:
            with open(os.path.join(args.logs, f"{i}_{os.path.basename(root)}.log"), "w") as f:
                f.write(res.stdout + "\n--- stderr\n" + res.stderr)
        if res.returncode != 0:
            print(f"{tree}: chip_smoke.py exited {res.returncode}\n{res.stdout[-2000:]}\n"
                  f"{res.stderr[-4000:]}", file=sys.stderr)
            return res.returncode
        runs.append((tree, times(res.stdout)))
        print(f"run {i} {tree}: {runs[-1][1]}", flush=True)
    print(f"ms per forward or step, runs in order [{card}]")
    for key in runs[0][1]:
        print(f"{key:14s} " + "  ".join(f"{tree}: {t.get(key, float('nan')):.2f}"
                                        for tree, t in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
