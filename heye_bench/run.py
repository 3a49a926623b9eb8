"""Run one cell of the port's benchmark once.

    python3 heye_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Loads the cell's configuration and traffic mix by the names in
BENCHMARK.json, builds and warms up the scheduler on one CUDA device,
measures for ``--seconds``, checks one iteration against the plain
reference, and prints one JSON line last on standard output (the numbers
compared, beside their limits, also last on standard error).  Exits
non-zero, printing no result, without a CUDA device, or when a JAX
module was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _process_age() -> float:
    """Seconds since this process started (0 where /proc is absent)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return max(0.0, uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def main() -> int:
    t_start = T_START - _process_age()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if args.workload not in {w["name"] for w in bench["workloads"]}:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from heye_bench import workload
    cell, cfg, traffic = workload.cell_files(ROOT, bench, args.workload)

    # every build and kernel cache of the program inside the checkout
    cache = ROOT / "build" / "heye_bench"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(cache)
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from heye_bench import harness

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    result = harness.run_cell(bench, args.workload, cfg, traffic, args.seed,
                              args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start, log)
    found = harness.banned_modules()
    if found:
        print(f"JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    checks = result.pop("checks")
    log(f"checks: {json.dumps(checks)}")
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
