"""Multi-pod dry run on fake ranks: build every (architecture x input-shape)
cell's step on the production meshes and count what one device does --
the reference package's ``launch/dryrun.py`` on PyTorch.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b \\
        --shape train_4k --mesh single --set microbatches=16 --set remat=none

Per cell this script:
  1. asks the placement search (core/placement.py -- H-EYE's predict ->
     check-constraint -> assign loop over layouts) for a Plan,
  2. starts a ``fake`` process group of 256 or 512 ranks (this process is
     rank 0; no collective moves data) and its production mesh, builds the
     state under fake tensors (nothing is allocated), places it with the
     plan's sharding policy and cache mode as DTensors, and runs the step
     once (train_step / prefill / decode_step) under DTensor's implicit
     replication,
  3. counts what rank 0 ran (launch/hlo_analysis.py): matmul FLOPs,
     collective bytes by type, an upper bound of HBM traffic, and the peak
     of live bytes (``MemTracker``: the argument shards, activations,
     gradients, optimizer state) against the planner chip's 16 GB.  A train
     step over microbatches runs one of them and is counted loop-aware, as
     the reference counts a scanned loop (``BuiltStep``),
  4. turns the counts into the reference's three roofline terms and
     appends the record to a JSON file (``build/dryrun.json`` by default).

The step is the port's eager model code on DTensors, not an XLA program:
where DTensor refuses to shard an op the way XLA's partitioner would, the
op runs on gathered arguments (``launch.sharding.GatherOnRefusal``; each
record lists those ops), so the counts are of this execution.  The v5e
constants are the reference's planner model of the TPU fleet, not
measurements of any device.

The fake group is process-global: run this module in a process of its
own (``python -m``), not beside a real process group.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import sys
import time
import traceback

import torch
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode

from .. import tree as tr
from ..configs import all_configs, get_config
from ..configs.shapes import SHAPES, input_specs, shape_applicable
from ..core.placement import Plan, choose_plan, model_flops, predict_plan
from ..models import ParallelCtx, build_model
from ..optim import OptConfig, adamw_update
from ..train.step import _split, init_train_state, make_train_step
from . import hlo_analysis
from .mesh import batch_axes as mesh_batch_axes
from .mesh import make_production_mesh
from .sharding import GatherOnRefusal, batch_sharding, make_shardings, place

HBM_PER_CHIP = 16e9   # TPU v5e (the planner's chip)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float8_e4m3fn": torch.float8_e4m3fn}


def _mesh_info(mesh):
    return tuple(mesh.shape), tuple(mesh.mesh_dim_names)


@dataclasses.dataclass
class BuiltStep:
    """A cell's step, ready to run once: ``run()`` and the trees it reads
    (its arguments, for the memory count).  A train step of ``trips``
    microbatches runs one of them (``run``) and is counted as the
    reference counts its scanned loop, the body times the trip count:
    ``trips`` times the run less ``trips - 1`` times the optimizer update
    (``update``), plus the accumulator's traffic; its peak is the run's
    plus the accumulator (``accum_bytes`` per device)."""

    run: object
    args: tuple
    n_chips: int
    tokens: int
    mode: str
    trips: int = 1
    update: object = None
    accum_bytes: int = 0


def _local_bytes(tree) -> int:
    total = 0
    for x in tr.leaves(tree):
        if isinstance(x, DTensor):
            x = x.to_local()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


def _inputs(specs, mesh, baxes) -> dict:
    batch = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in specs.items()}
    return place(batch, batch_sharding(batch, mesh, baxes))


def build_and_lower(cfg, shape, mesh, plan: Plan) -> BuiltStep:
    """The step of config ``cfg`` at ``shape`` on fake tensors, ready to
    run once (the reference's name: nothing is lowered, the step runs
    eagerly).  Call under an active fake-tensor mode
    (``hlo_analysis.counting``)."""
    if cfg.n_experts > 0 and plan.moe_group != cfg.moe_group:
        cfg = cfg.scaled(moe_group=plan.moe_group)
    baxes = mesh_batch_axes(mesh)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    ctx = ParallelCtx(batch_axes=baxes, model_axis="model",
                      model_size=sizes.get("model", 1), mesh=mesh,
                      use_kernels=False, remat=plan.remat,
                      compute_dtype=torch.bfloat16)
    model = build_model(cfg, ctx, device="cpu")
    specs = input_specs(cfg, shape)
    B, S = shape.global_batch, shape.seq_len
    n_chips = mesh.size()
    gen = torch.Generator().manual_seed(0)

    if shape.mode == "train":
        opt_cfg = OptConfig(state_dtype=_DTYPES[plan.state_dtype])
        state = init_train_state(model, gen, opt_cfg,
                                 param_dtype=_DTYPES[plan.param_dtype])
        state = place(state, make_shardings(state, mesh, policy=plan.policy,
                                            batch_axes=baxes))
        batch = _inputs(specs, mesh, baxes)
        mb = plan.microbatches
        if mb == 1:
            step = make_train_step(model, opt_cfg)
            return BuiltStep(lambda: step(state, batch), (state, batch),
                             n_chips, B * S, "train")
        step = make_train_step(model, opt_cfg, microbatches=1)
        parts = _split(batch, mb)
        first = parts[0]
        adt = _DTYPES[plan.accum_dtype]
        grads = tr.tree_map(lambda p: torch.zeros_like(p, dtype=adt),
                            state["params"])
        return BuiltStep(
            lambda: step(state, first), (state, batch), n_chips, B * S,
            "train", trips=len(parts),
            update=lambda: adamw_update(state["params"], grads, state["opt"],
                                        opt_cfg),
            accum_bytes=_local_bytes(grads))

    params = model.init(gen)
    cache = model.init_cache(B, S, dtype=_DTYPES[plan.cache_dtype])
    params = place(params, make_shardings(params, mesh, policy=plan.policy,
                                          batch_axes=baxes))
    cache = place(cache, make_shardings(cache, mesh, policy=plan.policy,
                                        batch_axes=baxes,
                                        cache_mode=plan.cache_mode))
    batch = _inputs(specs, mesh, baxes)
    if shape.mode == "prefill":
        return BuiltStep(lambda: model.prefill(params, batch, cache),
                         (params, cache, batch), n_chips, B * S, "prefill")
    return BuiltStep(
        lambda: model.decode_step(params, cache, batch["tokens"],
                                  batch["positions"]),
        (params, cache, batch), n_chips, B, "decode")


def _loop(body: hlo_analysis.HloReport, update: hlo_analysis.HloReport,
          trips: int, accum_bytes: int) -> hlo_analysis.HloReport:
    """The counts of ``trips`` microbatches from one (``body``, which ran
    the update once): the body ``trips`` times, the update once, and each
    trip's accumulation (read the accumulator and the gradient, write the
    accumulator)."""
    def scaled(a: dict, b: dict) -> dict:
        return {k: trips * a.get(k, 0) - (trips - 1) * b.get(k, 0)
                for k in set(a) | set(b)}
    return hlo_analysis.HloReport(
        dot_flops=trips * body.dot_flops - (trips - 1) * update.dot_flops,
        hbm_bytes=(trips * body.hbm_bytes - (trips - 1) * update.hbm_bytes
                   + trips * 3 * accum_bytes),
        collective_bytes=scaled(body.collective_bytes,
                                update.collective_bytes),
        collective_count=scaled(body.collective_count,
                                update.collective_count),
        top_traffic=body.top_traffic)


def run_cell(arch: str, shape_name: str, mesh_kind: str,
             plan: Plan | None = None, verbose: bool = True,
             autofit: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    if not ok:
        record.update(status="skipped", reason=why)
        return record

    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    mesh_shape, mesh_axes = _mesh_info(mesh)
    if plan is None:
        plan, pred = choose_plan(cfg, shape, mesh_shape, mesh_axes)
    else:
        pred = predict_plan(cfg, shape, mesh_shape, mesh_axes, plan)

    if autofit:
        # measured-feedback loop: the analytic memory model chooses the
        # starting microbatch count; if the counted peak exceeds HBM,
        # double mb and run again (hypothesis -> measure -> iterate).
        attempts = []
        while True:
            rec = _compile_cell(arch, shape_name, mesh_kind, mesh, cfg,
                                shape, plan, pred, verbose)
            attempts.append({"microbatches": plan.microbatches,
                             "peak_gb": rec.get("memory", {}).get("peak_gb"),
                             "status": rec["status"]})
            over = (rec["status"] == "ok"
                    and not rec["memory"]["fits_hbm"]
                    and shape.mode == "train"
                    and plan.microbatches * 2 <= shape.global_batch)
            # stop when doubling mb no longer helps: the over-HBM component
            # is static state (params/optimizer), which microbatching cannot
            # shave
            if (over and len(attempts) >= 2
                    and attempts[-2]["peak_gb"] is not None
                    and rec["memory"]["peak_gb"]
                    > 0.98 * attempts[-2]["peak_gb"]):
                rec["autofit_attempts"] = attempts
                rec["autofit_stopped"] = "static memory; mb-doubling flat"
                return rec
            if not over:
                rec["autofit_attempts"] = attempts
                return rec
            gc.collect()
            plan = dataclasses.replace(plan,
                                       microbatches=plan.microbatches * 2)
            pred = predict_plan(cfg, shape, mesh_shape, mesh_axes, plan)
            if verbose:
                print(f"  autofit: over HBM -> retry with "
                      f"mb={plan.microbatches}", flush=True)
    return _compile_cell(arch, shape_name, mesh_kind, mesh, cfg, shape,
                         plan, pred, verbose)


def _fault_site(tb) -> str:
    """``file:line`` of the innermost frame of the model or step code in
    ``tb`` (the counting and gathering layers left out)."""
    frames = [f for f in traceback.extract_tb(tb)
              if f"{os.sep}repro_torch{os.sep}" in f.filename
              and not f.filename.endswith(("hlo_analysis.py", "sharding.py"))]
    if not frames:
        return ""
    f = frames[-1]
    return f"{f.filename.split(os.sep + 'src' + os.sep)[-1]}:{f.lineno}"


def _compile_cell(arch, shape_name, mesh_kind, mesh, cfg, shape, plan,
                  pred, verbose) -> dict:
    record: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_kind}
    record["plan"] = dataclasses.asdict(plan)
    record["predicted"] = {
        "mem_gb": pred.mem_bytes / 1e9,
        "t_compute_s": pred.t_compute, "t_memory_s": pred.t_memory,
        "t_collective_s": pred.t_collective, "t_step_s": pred.t_step,
    }

    counter = hlo_analysis.LocalCounter()
    t0 = time.time()
    try:
        with hlo_analysis.counting(counter):
            built = build_and_lower(cfg, shape, mesh, plan)
            record["build_s"] = round(time.time() - t0, 1)
            arg_b = _local_bytes(built.args)
            counter.reset()
            tracker = MemTracker()
            tracker.track_external(*built.args)
            t0 = time.time()
            with CommDebugMode() as comm, tracker, GatherOnRefusal() as g:
                built.run()
            record["run_s"] = round(time.time() - t0, 1)
            rep = counter.finish()
            record["collective_count_run"] = dict(rep.collective_count)
            if built.trips > 1:
                counter.reset()
                with GatherOnRefusal():
                    built.update()
                rep = _loop(rep, counter.finish(), built.trips,
                            built.accum_bytes)
                record["counted"] = (
                    f"one microbatch x {built.trips}, the update once")
    except Exception as e:   # a failure here is a bug in the system
        record.update(status="FAILED", error=f"{type(e).__name__}: {e}"[:1000],
                      at=_fault_site(e.__traceback__),
                      traceback=traceback.format_exc()[-2000:])
        return record

    snap = tracker.get_tracker_snapshot("peak")
    peak = max(dev["Total"] for dev in snap.values()) + built.accum_bytes
    record["memory"] = {
        "argument_gb": arg_b / 1e9, "peak_gb": peak / 1e9,
        "fits_hbm": bool(peak <= HBM_PER_CHIP),
        "peak_by_kind_gb": {str(k).split(".")[-1]: v / 1e9 for dev in
                            snap.values() for k, v in dev.items()
                            if str(k) != "Total"},
    }
    # CommDebugMode's count of the run, beside the counter's
    record["comm_debug"] = {str(k): v for k, v in
                            comm.get_comm_counts().items()}
    record["collective_count"] = dict(rep.collective_count)
    record["gathered"] = dict(g.gathered)
    record["gathered_at"] = dict(g.sites)
    record["top_traffic"] = rep.top_traffic[:5]

    mf = model_flops(cfg, built.tokens,
                     "train" if built.mode == "train" else "serve")
    terms = hlo_analysis.roofline_terms(rep, n_chips=built.n_chips,
                                        model_flops_total=mf)
    record["roofline"] = terms
    record["status"] = "ok"
    if verbose:
        print(f"  memory (MemTracker): arg={arg_b/1e9:.2f}GB "
              f"peak={peak/1e9:.2f}GB fits={peak <= HBM_PER_CHIP}")
        print(f"  counted:         flops={rep.dot_flops:.3e}/device "
              f"collectives={rep.total_collective_bytes:.3e}B "
              f"{dict(rep.collective_bytes)}")
        print(f"  roofline (v5e planner model): "
              f"Tc={terms['t_compute_s']*1e3:.2f}ms "
              f"Tm={terms['t_memory_s']*1e3:.2f}ms "
              f"Tl={terms['t_collective_s']*1e3:.2f}ms "
              f"bound={terms['bottleneck']} "
              f"useful={terms['useful_flops_ratio']:.2f} "
              f"frac={terms['roofline_fraction']:.2f}", flush=True)
    return record


def against_reference(rec: dict, ref: dict) -> dict:
    """The port's record of a cell against the reference's record of it
    (an entry of ``tests/data/torch_dryrun_reference.json``): port /
    reference ratios of the peak bytes, the counted FLOPs a device and the
    collective bytes a device; the plans must be the same."""
    if rec["status"] != "ok" or ref["status"] != "ok":
        return {"port": rec["status"], "reference": ref["status"]}
    if rec["plan"] != ref["plan"]:
        raise ValueError(f"{rec['arch']}|{rec['shape']}|{rec['mesh']}: plan "
                         f"{rec['plan']} against the reference's "
                         f"{ref['plan']}")
    ours, theirs = rec["roofline"], ref["roofline"]

    def ratio(a: float, b: float) -> float:
        return a / b if b else float("inf") if a else 1.0
    return {
        "peak_gb": [rec["memory"]["peak_gb"], ref["memory"]["peak_gb"]],
        "peak_ratio": ratio(rec["memory"]["peak_gb"],
                            ref["memory"]["peak_gb"]),
        "flops_ratio": ratio(ours["hlo_flops_total"],
                             theirs["hlo_flops_total"]),
        "collective_ratio": ratio(ours["collective_bytes_per_chip"],
                                  theirs["collective_bytes_per_chip"]),
    }


def comparison_table(records: dict, reference: dict) -> list[str]:
    """A markdown table of ``records`` (a dry run's output) beside the
    reference's records: a row per (arch, shape), a column per mesh, each
    cell "port / reference peak GB (ratio); FLOPs a device (ratio);
    collective bytes a device (ratio)", or the two statuses where either
    is not ``ok``; then a line of totals."""
    meshes = ("single", "multi")
    rows: dict = {}
    n_ok = n_fit = n_le4 = 0
    for rec in records.values():
        cell = f"{rec['arch']}|{rec['shape']}|{rec['mesh']}"
        ref = reference["cells"].get(cell)
        if ref is None:
            continue
        if rec["status"] != "ok" or ref["status"] != "ok":
            text = f"{rec['status']} / {ref['status']}"
        else:
            c = against_reference(rec, ref)
            n_ok += 1
            n_fit += rec["memory"]["fits_hbm"]
            n_le4 += c["peak_ratio"] <= 4
            n = reference["n_chips"][rec["mesh"]]
            ours, theirs = rec["roofline"], ref["roofline"]
            text = (f"{c['peak_gb'][0]:.2f} / {c['peak_gb'][1]:.2f} "
                    f"({c['peak_ratio']:.2f}x); "
                    f"{ours['hlo_flops_total'] / n:.2e} / "
                    f"{theirs['hlo_flops_total'] / n:.2e} "
                    f"({c['flops_ratio']:.2f}x); "
                    f"{ours['collective_bytes_per_chip']:.1e} / "
                    f"{theirs['collective_bytes_per_chip']:.1e} "
                    f"({c['collective_ratio']:.2f}x)")
            if rec.get("gathered"):
                text += f"; {sum(rec['gathered'].values())} gathered"
        rows.setdefault((rec["arch"], rec["shape"]), {})[rec["mesh"]] = text
    lines = ["| cell | " + " | ".join(meshes) + " |",
             "| --- |" + " --- |" * len(meshes)]
    for (arch, shape), by_mesh in sorted(rows.items()):
        lines.append(f"| {arch} {shape} | "
                     + " | ".join(by_mesh.get(m, "") for m in meshes) + " |")
    lines.append(f"{n_ok} cells ok beside the reference; {n_le4} with the "
                 f"peak within 4x of the reference's; {n_fit} within "
                 f"{HBM_PER_CHIP / 1e9:.0f} GB")
    return lines


def _plan_overrides(pairs: list[str]) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        if k == "microbatches":
            out[k] = int(v)
        elif k == "moe_group":
            out[k] = int(v)
        else:
            out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default=os.path.join("build", "dryrun.json"))
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="override a Plan field (hillclimb variants)")
    ap.add_argument("--autofit", action="store_true",
                    help="if the counted peak exceeds HBM, double the "
                         "microbatch count and run again until it fits")
    ap.add_argument("--variant", default="baseline",
                    help="label stored with overridden-plan records")
    ap.add_argument("--cells", default=None,
                    help="slice of the cell list, e.g. 0:16 (parallel shards)")
    ap.add_argument("--reference", default=None, metavar="JSON",
                    help="the reference's records "
                         "(tests/data/torch_dryrun_reference.json): each "
                         "cell's record gains its ratios to the reference's")
    ap.add_argument("--compare", nargs="+", default=None, metavar="JSON",
                    help="run nothing: print the records of these files "
                         "beside --reference's, a line per cell")
    args = ap.parse_args(argv)
    reference = None
    if args.reference:
        with open(args.reference) as f:
            reference = json.load(f)
    if args.compare:
        if reference is None:
            ap.error("--compare needs --reference")
        records = {}
        for path in args.compare:
            with open(path) as f:
                records.update(json.load(f))
        print("\n".join(comparison_table(records, reference)))
        return 0

    if args.all:
        cell_list = [(a, s) for a in all_configs() for s in SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cell_list = [(args.arch, args.shape)]
    if args.cells:
        lo, hi = args.cells.split(":")
        cell_list = cell_list[int(lo):int(hi)]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    overrides = _plan_overrides(args.set)
    results: dict[str, dict] = {}
    out_path = args.out
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    if os.path.exists(out_path):
        with open(out_path) as f:
            results = json.load(f)

    failures = 0
    for arch, shape_name in cell_list:
        for mesh_kind in meshes:
            key = f"{arch}|{shape_name}|{mesh_kind}|{args.variant}"
            print(f"[dryrun] {key}", flush=True)
            plan = None
            if overrides:
                cfg = get_config(arch)
                mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
                base, _ = choose_plan(cfg, SHAPES[shape_name],
                                      *_mesh_info(mesh))
                plan = dataclasses.replace(base, **overrides)
            rec = run_cell(arch, shape_name, mesh_kind, plan=plan,
                           autofit=args.autofit)
            rec["variant"] = args.variant
            ref = (reference or {}).get("cells", {}).get(
                f"{arch}|{shape_name}|{mesh_kind}")
            if ref is not None and not overrides:
                rec["reference"] = against_reference(rec, ref)
                print(f"  against the reference: {rec['reference']}",
                      flush=True)
            results[key] = rec
            gc.collect()
            if rec["status"] == "FAILED":
                failures += 1
                print(f"  FAILED at {rec['at']}: {rec['error']}", flush=True)
            with open(out_path, "w") as f:
                json.dump(results, f, indent=1)
    print(f"[dryrun] done: {len(cell_list) * len(meshes)} cells, "
          f"{failures} failures -> {out_path}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
