"""Writes ``tests/data/torch_dryrun_reference.json``: the reference
package's dry run of every cell on both production meshes, trimmed to what
the port's dry run is compared on (the plan, the status, the peak and
argument bytes of XLA's ``memory_analysis``, and the roofline's FLOPs and
collective bytes).  The port's tests and ``chip_smoke.py`` read the file;
the card's host has no JAX.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_torch_dryrun_reference.py

runs ``python -m repro.launch.dryrun --all --mesh both`` split over
``--procs`` processes (``--cells``, 8 by default: about 3 minutes on 8
host cores), each writing its records to a temporary directory, never to
``results/``.  ``--records DIR`` trims records an earlier run left in
``DIR`` (its ``*.json``) instead of running again.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/data/make_torch_dryrun_reference.py \
        --buffers gemma3-1b train_4k single

writes nothing: it compiles that one cell of the reference with XLA's
buffer assignment dumped and prints the largest values XLA keeps in its
temporary allocation (what its ``memory_analysis`` peak is made of).
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "torch_dryrun_reference.json")
N_CELLS = 40          # (arch x shape) pairs of ``--all``


def _run(out_dir: str, procs: int) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    per = -(-N_CELLS // procs)
    jobs = []
    for i in range(procs):
        lo, hi = i * per, min(N_CELLS, (i + 1) * per)
        if lo >= hi:
            break
        log = open(os.path.join(out_dir, f"part{i}.log"), "w")
        jobs.append((log, subprocess.Popen(
            [sys.executable, "-m", "repro.launch.dryrun", "--all", "--mesh",
             "both", "--cells", f"{lo}:{hi}", "--out",
             os.path.join(out_dir, f"part{i}.json")],
            env=env, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT)))
    for log, proc in jobs:
        proc.wait()
        log.close()
        if proc.returncode != 0:
            raise SystemExit(f"reference dry run failed: see {log.name}")


_BUFFERS = """
import os, sys
import repro.launch.dryrun as RD
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=512 "
                           "--xla_dump_to=" + sys.argv[4]
                           + " --xla_dump_hlo_pass_re=NONE")
rec = RD.run_cell(sys.argv[1], sys.argv[2], sys.argv[3], verbose=False)
print("peak_gb", rec["memory"]["peak_gb"])
"""


def largest_temp_values(arch: str, shape: str, mesh: str,
                        n: int = 12) -> list[tuple[int, str, str]]:
    """(bytes, HLO value, shape) of the ``n`` largest values in the
    temporary allocation of the reference's compiled step for one cell."""
    import re
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with tempfile.TemporaryDirectory(prefix="ref_buffers_") as tmp:
        subprocess.run([sys.executable, "-c", _BUFFERS, arch, shape, mesh,
                        tmp], env=env, cwd=ROOT, check=True,
                       stdout=subprocess.DEVNULL)
        path = max(glob.glob(os.path.join(
            tmp, "*after_optimizations-buffer-assignment.txt")),
            key=os.path.getsize)
        text = open(path).read()
    temp = re.search(r"^allocation \d+: size \d+, preallocated-temp:\n"
                     r"((?: .*\n)*)", text, re.M)
    vals = re.findall(r"<\d+ (\S+) @\d+> \(size=(\d+),offset=\d+\): "
                      r"(\S+)", temp.group(1) if temp else "")
    return sorted(((int(b), name, shp) for name, b, shp in vals),
                  reverse=True)[:n]


def trim(rec: dict) -> dict:
    out = {"status": rec["status"]}
    if rec["status"] == "skipped":
        out["reason"] = rec["reason"]
        return out
    out["plan"] = rec["plan"]
    mem, terms = rec["memory"], rec["roofline"]
    out["memory"] = {"peak_gb": mem["peak_gb"],
                     "argument_gb": mem["argument_gb"]}
    out["roofline"] = {k: terms[k] for k in (
        "hlo_flops_total", "useful_flops_ratio",
        "collective_bytes_per_chip", "collective_breakdown")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, default=8)
    ap.add_argument("--records", default=None)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--buffers", nargs=3, default=None,
                    metavar=("ARCH", "SHAPE", "MESH"))
    args = ap.parse_args(argv)
    if args.buffers:
        for nbytes, name, shape in largest_temp_values(*args.buffers):
            print(f"{nbytes / 1e9:10.3f} GB  {name}  {shape}")
        return 0
    import jax
    with tempfile.TemporaryDirectory(prefix="ref_dryrun_") as tmp:
        src = args.records or tmp
        if args.records is None:
            _run(tmp, args.procs)
        records: dict = {}
        for path in sorted(glob.glob(os.path.join(src, "*.json"))):
            records.update(json.load(open(path)))
    cells = {key.rsplit("|", 1)[0]: trim(rec)
             for key, rec in sorted(records.items())
             if key.endswith("|baseline")}
    doc = {"source": "python -m repro.launch.dryrun --all --mesh both "
                     "(JAX_PLATFORMS=cpu, 512 host devices)",
           "jax_version": jax.__version__,
           "n_chips": {"single": 256, "multi": 512},
           "cells": cells}
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    print(f"{len(cells)} cells -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
