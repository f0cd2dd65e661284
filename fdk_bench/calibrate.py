"""Readings that the limits of ``correct`` are set from, on the card.

    python3 -m fdk_bench.calibrate --workload NAME --seeds S... \
        --control-seeds S... [--seconds 2] [--out PATH]

For each of ``--seeds`` a run of the cell (a short window; the number
compared is the program's), and for each of ``--control-seeds`` the
control: the same run with the plain reference, in the lower precision
the mix names (``control``), put in the program's place.  All in one
process, so that the kernel libraries are built once.  Prints one line
per reading and writes them all as JSON to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from . import run as R


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no card", file=sys.stderr)
        return 2
    bench = R.load_json(os.path.join(R.ROOT, "BENCHMARK.json"))
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    config = R.load_json(R.find("config", cell["config"]))
    mix = R.load_json(R.find("traffic", cell["traffic"]))
    out = {"workload": args.workload, "card": R.power_limit(),
           "program": [], "control": [], "control_precision": mix["control"]}
    runs = [(s, None) for s in args.seeds] + \
        [(s, mix["control"]) for s in args.control_seeds]
    for seed, control in runs:
        res = R.run_cell(config, mix, [], seed=seed, seconds=args.seconds,
                         trace=False, backend="cuda",
                         device=torch.device("cuda", 0), control=control)
        reading = {"seed": seed, "correct": res["correct"],
                   **{k: v["value"] for k, v in res["compared"].items()}}
        out["control" if control else "program"].append(reading)
        print(json.dumps(dict(reading, control=control)), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
