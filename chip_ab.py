"""Parent/change timing on one CUDA card: each tree's own chip_smoke.py, in turns.

    python3 chip_ab.py [--logs DIR] TREE [TREE ...]

Each TREE is the root of a checkout of the repository (for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.``).  For each, in the order given (parent,
change, change, parent compares two trees on one card), this runs that
tree's ``chip_smoke.py`` from its root, so each tree builds its own kernels
and times them with its own code, and reads the times it prints: ms per
forward (phase 6) and per train step (phase 8) of every model, and the ms of K1
``ss2d_scan``, K8 ``ss2d_scan_bwd``, K2 ``ss2d_merge``, K5 ``prologue``, K6
``ln_mlp``, K7 ``ln_dwms_mlp``, K9 ``ln_mlp_bwd`` and K10 ``ln_dwms_mlp_bwd`` at
each shape phase 3 checks them, beside the bound the run computed and,
where the tree prints it, the time of the kernel's matrix products alone as
torch.matmul (``gemm``).  Then tables of the runs side by side, with the
card's ``name, power.limit``.  ``--logs DIR`` keeps each run's whole output.
``--ffn-bwd`` runs, instead of the whole ``chip_smoke.py``, only its phase 3
checks of K9 and K10 (``check_mlp_bwd`` at every shape of the train steps),
and ``--k5-k10`` only its checks of K5 (every shape of Tramba-V's, -P's and
-R's forwards, through ``check_bf16_only`` with no K6 / K7 shapes) and of
K10 (the DWMS shapes of ``check_mlp_bwd``), so that a tree can be listed
several times in one short call.  Exits with the first failing run's code.
"""

from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys

TIMES = (re.compile(r"^Tramba-(\w)-TSOD 384px (\w+ B\d+): ([\d.]+) ms/forward"),
         re.compile(r"^Tramba-(\w)-TSOD 384px (\w+ train) step (B\d+): ([\d.]+) ms/step"))
# phase 3's line of a tabulated kernel: name, tag, shape, ..., kernel ms, plain
# ms, bound ms (bound by), and gemm ms where printed
KERNELS = re.compile(r"^(ss2d_scan(?:_bwd)?|ss2d_merge|prologue|ln_mlp|ln_dwms_mlp|ln_mlp_bwd|"
                     r"ln_dwms_mlp_bwd)"
                     r"\s+((?:fp32|bf16)(?: train)?)\s+"
                     r"(\S.*?)\s+max_abs_err .* kernel ([\d.]+) ms plain [\d.]+ ms "
                     r"bound ([\d.]+) ms \(\w+\)(?: gemm ([\d.]+) ms)?")


def times(stdout: str) -> dict:
    """{"V fp32 B1": ms, ..., "R bf16 train B4": ms} from a chip_smoke.py
    output (V, S, P, R: the model)."""
    out = {}
    for line in stdout.splitlines():
        if m := TIMES[0].match(line):
            out[f"{m[1]} {m[2]}"] = float(m[3])
        elif m := TIMES[1].match(line):
            out[f"{m[1]} {m[2]} {m[3]}"] = float(m[4])
    return out


def kernel_times(stdout: str) -> dict:
    """{(kernel, tag, shape): (ms, bound_ms, gemm_ms or nan)} of phase 3's
    K1, K8, K2, K5, K6, K7, K9 and K10 lines."""
    out = {}
    for line in stdout.splitlines():
        if m := KERNELS.match(line):
            out[m[1], m[2], m[3]] = (float(m[4]), float(m[5]),
                                     float(m[6]) if m[6] else float("nan"))
    return out


# the phase 3 checks of K9 and K10 alone, run in a tree's root (--ffn-bwd)
FFN_BWD = ("import torch, chip_smoke as cs\n"
           "torch.backends.cuda.matmul.allow_tf32 = False\n"
           "checks, gen = cs.Checks(), torch.Generator().manual_seed(0)\n"
           "for shapes in (cs.MLP_BWD_SHAPES, cs.MLP_BWD_SHAPES_P, cs.MLP_BWD_SHAPES_R):\n"
           "    cs.check_mlp_bwd(checks, torch.device('cuda'), gen, shapes)\n")
# the phase 3 checks of K5 and K10 alone (--k5-k10): the same calls in the
# parent's chip_smoke.py and in this one
K5_K10 = ("import torch, chip_smoke as cs\n"
          "torch.backends.cuda.matmul.allow_tf32 = False\n"
          "checks, gen, dev = cs.Checks(), torch.Generator().manual_seed(0), torch.device('cuda')\n"
          "for k5, bwd in ((cs.BF16_SHAPES, cs.MLP_BWD_SHAPES), (cs.BF16_SHAPES_P, "
          "cs.MLP_BWD_SHAPES_P), (cs.BF16_SHAPES_R, cs.MLP_BWD_SHAPES_R)):\n"
          "    cs.check_bf16_only(checks, dev, gen, dict(k5, ln_mlp=(), ln_dwms_mlp=()))\n"
          "    cs.check_mlp_bwd(checks, dev, gen, tuple(s for s in bwd if s[2]))\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", default="", help="directory for each run's whole output")
    short = ap.add_mutually_exclusive_group()
    short.add_argument("--ffn-bwd", action="store_true",
                       help="run only phase 3's K9 / K10 checks of each tree")
    short.add_argument("--k5-k10", action="store_true",
                       help="run only phase 3's K5 / K10 checks of each tree")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.logs:
        os.makedirs(args.logs, exist_ok=True)
    runs = []
    for i, tree in enumerate(args.trees):
        root = os.path.abspath(tree)
        cmd = (["-c", FFN_BWD] if args.ffn_bwd else ["-c", K5_K10] if args.k5_k10
               else [os.path.join(root, "chip_smoke.py")])
        res = subprocess.run([sys.executable, *cmd], cwd=root, capture_output=True, text=True,
                             timeout=1500)
        if args.logs:
            with open(os.path.join(args.logs, f"{i}_{os.path.basename(root)}.log"), "w") as f:
                f.write(res.stdout + "\n--- stderr\n" + res.stderr)
        if res.returncode != 0:
            print(f"{tree}: chip_smoke.py exited {res.returncode}\n{res.stdout[-2000:]}\n"
                  f"{res.stderr[-4000:]}", file=sys.stderr)
            return res.returncode
        runs.append((tree, times(res.stdout), kernel_times(res.stdout)))
        print(f"run {i} {tree}: {runs[-1][1]}, {len(runs[-1][2])} kernel lines", flush=True)
    print(f"ms per forward or step, runs in order [{card}]")
    for key in runs[0][1]:
        print(f"{key:14s} " + "  ".join(f"{tree}: {t.get(key, float('nan')):.2f}"
                                        for tree, t, _ in runs))
    print(f"kernels: ms per call (bound ms; gemm ms), runs in order [{card}]")
    keys = list(dict.fromkeys(k for _, _, sc in runs for k in sc))
    for key in keys:
        cells = []
        for tree, _, sc in runs:
            ms, bound, gemm = sc.get(key, (float("nan"),) * 3)
            cells.append(f"{tree}: {ms:.4f} ({bound:.4f}; {gemm:.4f})")
        print(f"{' '.join(key):48s} " + "  ".join(cells))
    return 0


if __name__ == "__main__":
    sys.exit(main())
