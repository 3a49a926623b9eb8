"""The check's control: the plain reference computed in float32 (the
configurations state float64), put in the program's place at the cell's
own size, must come out as not correct.

    python3 heye_bench/control.py --workload <cell> --seeds 1 2 3

Prints per seed the numbers the check compares, each beside its limit.
The benchmark's own runs never run this; it needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cfg: dict, traffic: dict, seeds: list) -> dict:
    """The check's numbers for the float32 reference in the program's
    place, iteration seeds ``seeds``."""
    from heye_bench import check, workload
    from heye_bench.reference import scheduler
    mode = workload.load("modes", traffic["mode"])
    return check.compare(mode.reference_rows(cfg, traffic, seeds,
                                             scheduler.f32),
                         mode.reference_rows(cfg, traffic, seeds))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT)]
    from heye_bench import check, workload
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, cfg, traffic = workload.cell_files(ROOT, bench, args.workload)
    for seed in args.seeds:
        t = time.perf_counter()
        numbers = control_numbers(cfg, traffic,
                                  workload.iteration_seeds(seed, 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": check.verdict(numbers),
                          "seconds": time.perf_counter() - t,
                          "checks": {k: {"value": v,
                                         "limit": check.LIMITS[k]}
                                     for k, v in numbers.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
