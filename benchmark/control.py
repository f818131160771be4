"""The readings a cell's limits are set from, on the card, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 12 --control-seeds 3 \\
        --seconds 3 --out control_<cell>.json

* The program's: for each of ``--seeds`` seeds, a short window of the cell's
  own traffic on the program built once (``run.run_window``), and the
  comparison of its checked forecasts with the float64 reference, as a run
  makes it (``check.numbers``).
* The control's: for the first ``--control-seeds`` seeds, the reference
  computed in bfloat16, the precision below the configuration's float32
  (the model has no matrix product, so TF32 does not apply), put in the
  program's place and compared with the float64 reference the same way.

A field's lower reading is the largest the program gives over the seeds,
its upper reading the smallest the control gives.  The runs of the
benchmark never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import check, spec, traffic as traffic_gen
from benchmark.program import Program
from benchmark.reference.model import Reference
from benchmark.run import run_window, sync


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--first-seed", type=int, default=2**31 + 1000)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", required=True)
    cli = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    bench = spec.load_benchmark(spec.HERE.parent)
    cell = spec.cell(bench, cli.workload)
    config = spec.load_json("configs", cell["config"])
    traffic = spec.load_json("traffic", cell["traffic"])
    nl, pert = config["namelist"], config["assumed"]["perturbation"]
    grid = (nl["nx"], nl["ny"], nl["nz"])
    program = Program(nl, device)
    reference = Reference(nl, device)
    control = Reference(nl, device, torch.bfloat16)
    rows = []
    for n in range(cli.seeds):
        seed = cli.first_seed + 7919 * n
        sample = traffic_gen.Sample(traffic["checked_forecasts"], seed)
        slots = [{k: torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for k, t in program.outputs().items()}
                 for _ in range(traffic["checked_forecasts"])]
        times, window_s, _ = run_window(program, nl, pert, seed, cli.seconds, sample, slots, device)
        sync(device)
        row = {"seed": seed, "forecasts": len(times), "checked": list(sample.chosen), "program": [],
               "control": []}
        for slot, index in enumerate(sample.chosen):
            p = traffic_gen.perturbation(grid, pert, seed, index, device)
            t0 = time.perf_counter()
            ref = check.reference_forecast(reference, p, nl["niter"])
            row["reference_s"] = time.perf_counter() - t0
            row["program"].append(check.numbers(slots[slot], ref))
            if n < cli.control_seeds:
                row["control"].append(check.numbers(check.reference_forecast(control, p, nl["niter"]), ref))
        rows.append(row)
        print(json.dumps(row), flush=True)
    lower = check.worst(r for row in rows for r in row["program"])
    upper = {k: min(r[k] for row in rows for r in row["control"]) for k in check.COMPARED}
    summary = {"workload": cli.workload, "card": torch.cuda.get_device_name(device), "lower": lower,
               "upper": upper, "rows": rows}
    with open(cli.out, "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
