"""The control of a cell: the plain reference put in the program's place
and computed one precision step below what the configuration states
(TF32 on, for float32 with TF32 off), compared with the reference as the
benchmark compares the program.  It has to come out as not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3

Each seed writes the cell's inputs, takes the same seeded sample of
phantoms a run takes (every phantom counts as finished) and prints one
JSON line: each number, its limit and whether it failed.  Needs the card
(TF32 exists only there); the benchmark's own runs never run this.
"""

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def control_numbers(cell, seed: int, device: str, workdir: str) -> dict:
    """The control's numbers for ``cell`` on ``seed``."""
    from benchmark.harness.cohort import Cohort, Pass
    ctx = SimpleNamespace(seed=seed, config=cell.config,
                          traffic=cell.traffic, workload=cell.workload,
                          device=device, workdir=workdir,
                          low_precision=False)
    cohort = Cohort(cell.traffic, seed, workdir)
    cohort.write_inputs()
    done = [Pass(k=p, name=str(p), phantom=p, ok=True, error=None,
                 stages={}, t_end=0.0) for p in range(len(cohort.phantoms))]
    pairs = [(cell.driver.reference(ctx, cohort, p, "tf32"),
              cell.driver.reference(ctx, cohort, p))
             for p in cohort.sample(done, seed)]
    return cell.driver.numbers(pairs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import spec
    if not torch.cuda.is_available():
        print("the control needs a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(spec.load_spec(ROOT), args.workload, ROOT)
    limits = cell.workload["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="control-")
        try:
            with contextlib.redirect_stdout(sys.stderr):
                got = control_numbers(cell, seed, "cuda", workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": got, "limits": limits,
                          "fails": [n for n in limits
                                    if not got[n] <= limits[n]]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
