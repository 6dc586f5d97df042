"""The readings that a cell's limits are set from, on the card, with one
process a cell (set-up is long; the benchmark's own runs never run this):

- the control: the plain reference put in the program's place and computed
  in fp8 (reference/numerics.py), compared with the float32 reference by
  compare.py on the units that a run would sample (``--seeds``). Its
  readings have to fail the cell's limits;
- the sound program: whole runs of the cell (run.run_cell, a short window
  at the cell's own load), one a seed (``--program-seeds``);
- planted faults (faults.py) under a whole run of the cell, one run each
  (``--faults``, on ``--fault-seed``). Each has to fail the limits.

    python -m portbench.control --workload 3b.video1080 --seeds 11,12,13 \\
        [--program-seeds 21,22 --seconds 6] [--faults conv_bias_dropped --fault-seed 5]

Prints one JSON line a reading: the compared numbers beside the cell's
limits, and whether they pass.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(name: str, seed: int, requests: int, device="cuda:0", root=None) -> dict:
    """fp8 against float32 on the units sampled from ``requests`` finished
    requests."""
    import torch

    from . import catalog, compare
    from .run import ROOT, port_config, reference_codes, sample_units

    cell = catalog.cell(name, root or ROOT)
    cfg = port_config(cell)
    mix = catalog.generator(cell.traffic).Mix(cell.traffic, abs(int(seed)))
    units = sample_units(cell, mix, list(range(requests)), seed)
    dev = torch.device(device)
    exact = reference_codes(cell, seed, dev, mix, cfg, units, "fp32")
    low = reference_codes(cell, seed, dev, mix, cfg, units, "fp8")
    r = compare.gaps(list(zip(low, exact)))
    ok, checks = compare.judge(r, cell.spec["limits"])
    return {"workload": name, "seed": seed, "units": units, "control_passes": ok, "checks": checks}


def program_run(name: str, seed: int, seconds: float, fault=None, device="cuda:0", root=None) -> dict:
    """One whole run of the cell in this process, with ``fault`` (a name of
    faults.FAULTS) planted, or none."""
    from . import faults
    from .run import ROOT, run_cell

    patch = faults.Patch()
    if fault:
        faults.FAULTS[fault](patch)
    try:
        r = run_cell(name, seed, seconds, False, device, root or ROOT, t0=time.perf_counter())
    finally:
        patch.undo()
    return {"workload": name, "seed": seed, "fault": fault, "correct": r["correct"], "failed": r["failed"],
            "attempted": r["attempted"], "metrics": r["metrics"], "checks": r["checks"]}


def _seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings of a cell's correctness check: control, program, faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="control seeds, comma-separated")
    ap.add_argument("--requests", type=int, default=8, help="finished requests to sample the control's units from")
    ap.add_argument("--program-seeds", default="", help="seeds of whole runs of the sound program")
    ap.add_argument("--seconds", type=float, default=6.0, help="window of the program's and the faults' runs")
    ap.add_argument("--faults", default="", help="names in faults.FAULTS, comma-separated")
    ap.add_argument("--fault-seed", type=int, default=5)
    args = ap.parse_args(argv)
    from .run import set_environment

    set_environment()
    import torch

    if not torch.cuda.is_available():
        print("the readings run on the card", file=sys.stderr)
        return 3
    for s in _seeds(args.program_seeds):
        print(json.dumps(program_run(args.workload, s, args.seconds)), flush=True)
    for f in [f for f in args.faults.split(",") if f]:
        print(json.dumps(program_run(args.workload, args.fault_seed, args.seconds, f)), flush=True)
    for s in _seeds(args.seeds):
        print(json.dumps(readings(args.workload, s, args.requests)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
