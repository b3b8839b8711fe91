"""Readings that set a cell's limits, many seeds in one process.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 [--program] [--control]
        [--faults etas_rolled,etas_doubled]

For each seed: the plain reference in float64 on the seed's inputs, and
with ``--program`` one unit of the program's timed path (the cell's
driver, as the window runs it) compared with it: the lower readings; with
``--control`` the reference computed in float32 put in the program's place
and compared with it: the upper readings; with ``--faults`` one unit of
the program built on the seed's η put wrong (:data:`ETA_FAULTS`) compared
with it.  The benchmark's own runs do not run this.  One JSON line a seed
on standard output.
"""

import os
import sys

if __name__ == "__main__":
    # the checkout's root in place of this script's directory on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

#: the members' η put wrong: the program built on these, the reference on
#: the seed's own
ETA_FAULTS = {
    "etas_rolled": lambda etas: etas[1:] + etas[:1],  # each member on the next one's η
    "etas_doubled": lambda etas: [2.0 * e for e in etas],
}


def readings(workload, seeds, program: bool, control: bool, device="cuda", overrides=None,
             faults=()):
    import torch

    from portbench.compare import gaps
    from portbench.harness import ROOT, draw_etas, load_cell, load_module

    _bench, _cell, cfg, traffic = load_cell(workload)
    cfg = {**cfg, **(overrides or {})}
    driver = load_module(ROOT, "drivers", cfg["entry"])
    dev = torch.device(device)
    for seed in seeds:
        etas = draw_etas(traffic, seed)
        row = {"workload": workload, "seed": seed, "etas": etas}
        t = time.perf_counter()
        ref = driver.reference(cfg, etas, dev, torch.float64)
        row["reference_s"] = time.perf_counter() - t
        if program:
            work = driver.build(cfg, etas, dev, lambda name: contextlib.nullcontext())
            t = time.perf_counter()
            ans = work["unit"]()
            row["program_s"] = time.perf_counter() - t
            row["program"] = gaps(ans, ref)
            del work, ans
        for name in faults:
            wrong = ETA_FAULTS[name](list(etas))
            if wrong == list(etas):
                continue  # no fault of one member's order
            work = driver.build(cfg, wrong, dev, lambda name: contextlib.nullcontext())
            row[name] = gaps(work["unit"](), ref)
            del work
        if control:
            t = time.perf_counter()
            low = driver.reference(cfg, etas, dev, torch.float32)
            row["control_s"] = time.perf_counter() - t
            row["control"] = gaps(low, ref)
            del low
        del ref
        if device == "cuda":
            torch.cuda.empty_cache()
        yield row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", default="", help="comma-separated names of ETA_FAULTS")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    faults = [f for f in args.faults.split(",") if f]
    for row in readings(args.workload, seeds, args.program, args.control, faults=faults):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
