"""The benchmark of ``ukbb_cardiac_tpu_torch`` on NVIDIA cards.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once on the card(s) of this machine:
the cell's set-up, then ``--seconds`` of its traffic (under
``torch.profiler`` with ``--trace 1``), then the comparison of what the
window produced with the plain reference.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``compared``: each number that decided ``correct`` beside its limit); the
last lines of standard error repeat ``compared``.  With no card, or fewer
than the cell asks for, it exits 3 and prints no result; it exits 4 and
prints no result if JAX or the JAX package was loaded.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the build and kernel caches live at fixed paths inside the checkout
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      os.path.join(ROOT, "build", "bench_cache", "torch"))
os.environ.setdefault("TRITON_CACHE_DIR",
                      os.path.join(ROOT, "build", "bench_cache", "triton"))
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import guard, runner, spec

    cell = spec.cell(spec.load_spec(ROOT), args.workload, ROOT)
    chips = cell.entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    print(f"card: {runner.card_line()}", file=sys.stderr)
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace))
    loaded = guard.forbidden_loaded()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 4
    for name, c in result["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
