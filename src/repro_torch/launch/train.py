"""End-to-end training entry point of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 20 --batch 4 --seq 1024
    PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
        --steps 200 --batch 8 --seq 128 --smoke --device cpu

Wires the layers together as the reference package's ``launch/train.py``:
config registry -> model -> data pipeline (prefetched onto the device)
-> train step -> AdamW -> periodic async checkpointing ->
restart-from-latest, with the FT manager watching step times for
stragglers.  The model takes the plain route (``use_kernels=False``; the
kernels are forward only), with float32 compute under ``--smoke`` and
bfloat16 otherwise; ``--remat block`` recomputes each superblock in the
backward pass.

As in the reference, the step runs on a mesh over the devices that exist
(``launch/mesh.make_host_mesh``; the production meshes are the dry run's):
the state is placed with ``launch/sharding.make_shardings`` and every
batch with ``batch_sharding``, as DTensors, and each step runs under
``GatherOnRefusal`` (DTensor's implicit replication, and gathered
arguments where DTensor refuses an op's sharding).  This process is one
rank, so on the card (``--device``, the CUDA card by default) the mesh is
(1, 1) and every op runs on the whole tensor.  The loss and the gradient
norm come back partial or replicated and are reduced before they are
read; the report's state is whole tensors.  The run ends its one-rank
process group when it started one.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
from torch.distributed.tensor import DTensor

from ..checkpoint import latest_step, restore
from ..configs import get_config
from ..configs.shapes import TensorSpec
from ..core.topology import build_tpu_fleet
from ..data.pipeline import DataConfig, Prefetcher, synthetic_batches
from ..device import resolve_device
from ..ft.manager import FTConfig, FTManager
from ..models import ParallelCtx, build_model
from ..optim import OptConfig
from ..train.step import init_train_state, make_train_step
from ..tree import tree_map
from . import mesh as mesh_mod
from .sharding import GatherOnRefusal, batch_sharding, make_shardings, place


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-runnable)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--remat", default="none", choices=("none", "block"),
                    help="recompute each superblock in the backward pass")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the state "
                         "(default: the CUDA card; 'cpu' on request)")
    return ap.parse_args(argv)


@dataclass
class TrainReport:
    """What one run did, step by step (``steps`` are 1-based step numbers)
    and the state it ended with.  ``step_ms`` is each step's time: CUDA
    events between step ends on the card, the host clock on the CPU.
    ``ckpt_seconds`` is the time the run spent in its checkpoints (the
    host copy and, at the end, waiting for the writes)."""

    start_step: int
    steps: list[int] = field(default_factory=list)
    losses: list[float] = field(default_factory=list)
    grad_norms: list[float] = field(default_factory=list)
    lrs: list[float] = field(default_factory=list)
    step_ms: list[float] = field(default_factory=list)
    ckpt_seconds: float = 0.0
    state: dict = field(default_factory=dict)
    model: object = None
    ft: object = None


def _whole(x):
    """A DTensor as the whole tensor it stands for (partial sums reduced);
    anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def run(args: argparse.Namespace) -> TrainReport:
    dev = resolve_device(args.device)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    mesh = mesh_mod.make_host_mesh(data=n_dev, device=dev)
    try:
        return _run(args, mesh)
    finally:
        mesh_mod.release()


def _run(args: argparse.Namespace, mesh) -> TrainReport:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    baxes = mesh_mod.batch_axes(mesh)
    ctx = ParallelCtx(batch_axes=baxes, model_axis="model", mesh=mesh,
                      use_kernels=False, remat=args.remat,
                      compute_dtype=torch.float32 if args.smoke
                      else torch.bfloat16)
    model = build_model(cfg, ctx, device=args.device)
    dev = model.device
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        decay_steps=args.steps)

    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             opt_cfg)
    start_step = 0
    if args.resume and latest_step(args.ckpt_dir) is not None:
        start_step = latest_step(args.ckpt_dir)
        state = restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start_step}")
    state = place(state, make_shardings(state, mesh))

    dcfg = DataConfig(batch=args.batch, seq=args.seq, vocab=cfg.vocab,
                      seed=start_step)
    tokens = TensorSpec((args.batch, args.seq), torch.int32)
    b_sh = batch_sharding({"tokens": tokens}, mesh, baxes)["tokens"]
    data = Prefetcher(synthetic_batches(dcfg, cfg), depth=2, device=dev)
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches)
    ft = FTManager(build_tpu_fleet(n_pods=1, hosts_per_pod=1,
                                   chips_per_host=mesh.size(),
                                   device=dev).graph,
                   FTConfig(checkpoint_every=args.ckpt_every),
                   ckpt_dir=args.ckpt_dir)
    rep = TrainReport(start_step=start_step, model=model, ft=ft)

    cuda = dev.type == "cuda"

    def mark():
        if not cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    marks = [mark()]
    metrics_by_step = []
    t_last = time.time()
    try:
        for step in range(start_step, args.steps):
            batch = {k: place(v, b_sh) if v.shape == tokens.shape else v
                     for k, v in next(data).items()}
            with GatherOnRefusal():
                state, metrics = step_fn(state, batch)
            metrics = {k: _whole(v) for k, v in metrics.items()}
            marks.append(mark())
            metrics_by_step.append(metrics)
            if (step + 1) % args.log_every == 0:
                loss = float(metrics["loss"])
                dt = (time.time() - t_last) / args.log_every
                t_last = time.time()
                tok_s = args.batch * args.seq / dt
                print(f"[train] step {step + 1:5d} loss {loss:7.4f} "
                      f"lr {float(metrics['lr']):.2e} "
                      f"gnorm {float(metrics['grad_norm']):6.2f} "
                      f"{dt * 1e3:7.1f} ms/step {tok_s:9.0f} tok/s",
                      flush=True)
                ft.report_step_times({"host0": dt})
            t0 = time.perf_counter()
            if ft.maybe_checkpoint(state, step + 1):
                rep.ckpt_seconds += time.perf_counter() - t0
        t0 = time.perf_counter()
        ft.saver.wait()
        rep.ckpt_seconds += time.perf_counter() - t0
    finally:
        data.close()
    if cuda:
        torch.cuda.synchronize(dev)
        rep.step_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        rep.step_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    for i, m in enumerate(metrics_by_step):
        rep.steps.append(start_step + i + 1)
        rep.losses.append(float(m["loss"]))
        rep.grad_norms.append(float(m["grad_norm"]))
        rep.lrs.append(float(m["lr"]))
    rep.state = tree_map(_whole, state)
    print(f"[train] done at step {args.steps}; "
          f"last checkpoint: {latest_step(args.ckpt_dir)}")
    return rep


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
