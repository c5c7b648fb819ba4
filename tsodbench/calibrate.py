"""Readings that the limits of a cell's output check are set from, in one
process: for each seed a whole run of the cell (set-up, a short window, the
check) gives the program's numbers; on the first seeds the driver's
``controls`` give, on the same weights and inputs, the control's (the
reference with every product operand rounded to fp8 in the program's
place) and those of the faults it plants in the reference.

    python3 tsodbench/calibrate.py --workload <name> --seeds 11,12,13 --seconds 3

Prints one JSON line per seed and reading; needs the card.
"""

import argparse
import json
import os
import sys
import time


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control-seeds", type=int, default=3,
                   help="read the control and the faults on the first this many seeds")
    args = p.parse_args(argv)
    import torch

    from tsodbench import harness, runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    harness.steady_host_allocator()
    harness.use_checkout_caches()
    cell = harness.resolve(args.workload)
    drive = harness.driver(cell.traffic["driver"])
    dev = torch.device("cuda", 0)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = drive.run(cell, seed, args.seconds, False, dev, t0)
        print(json.dumps({"seed": seed, "who": "program", **run.readings, "e2e": run.e2e,
                          "check_s": run.check_s}), flush=True)
        if i < args.control_seeds:
            t = time.perf_counter()
            for who, readings in drive.controls(cell, run, seed, dev):
                print(json.dumps({"seed": seed, "who": who, **readings,
                                  "s": time.perf_counter() - t}), flush=True)
                t = time.perf_counter()
        del run
        runner.free(dev)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
