"""The port's dry run (``repro_torch.launch.dryrun``) and its per-device
counts (``repro_torch.launch.hlo_analysis``): the local FLOP count of a
two-matmul program against the count written out by hand, the collective
bytes DTensor moves, ``roofline_terms`` against the reference's, and
train / prefill / decode cells at smoke size on a small fake mesh; the
smoke train cell against the reference's own dry run of it (run in a
subprocess), and the committed reference records
(``tests/data/torch_dryrun_reference.json``) against the planner."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.utils.flop_counter import FlopCounterMode

import repro.launch.hlo_analysis as RH
import repro_torch.launch.dryrun as D
import repro_torch.launch.hlo_analysis as TH
from repro_torch.configs import get_config
from repro_torch.configs.shapes import Shape
from repro_torch.core.placement import Plan, model_flops, predict_plan
from repro_torch.launch import mesh as TM
from torch_port_util import fake_mesh

torch.set_num_threads(1)


def test_two_matmul_local_flops_equal_the_hand_count():
    """x (16, 32) rows over data; w1 (32, 64) columns over model; w2
    (64, 32) rows over model (Megatron's MLP).  Each of the 2 x 4 ranks
    multiplies (8, 32) by (32, 16), then (8, 16) by (16, 32): 2*8*32*16 +
    2*8*16*32 = 16384 FLOPs, an eighth of the global 131072; the output
    is a partial sum over model until one all-reduce of (8, 32) float32."""
    counter = TH.LocalCounter()
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        with TH.counting(counter):
            x = distribute_tensor(torch.zeros(16, 32), mesh,
                                  [Shard(0), Replicate()], src_data_rank=None)
            w1 = distribute_tensor(torch.zeros(32, 64), mesh,
                                   [Replicate(), Shard(1)], src_data_rank=None)
            w2 = distribute_tensor(torch.zeros(64, 32), mesh,
                                   [Replicate(), Shard(0)], src_data_rank=None)
            counter.reset()
            with FlopCounterMode(display=False) as outside:
                y = (x @ w1) @ w2
            assert [p.is_partial() for p in y.placements] == [False, True]
            assert counter.report.collective_count == {}
            y.redistribute(mesh, [Shard(0), Replicate()])
            rep = counter.finish()
    assert rep.dot_flops == 2 * 8 * 32 * 16 + 2 * 8 * 16 * 32 == 16384
    # a FlopCounterMode around DTensor sees the global ops
    assert outside.get_total_flops() == 8 * rep.dot_flops
    assert rep.collective_count == {"all-reduce": 1}
    assert rep.collective_bytes == {"all-reduce": 8 * 32 * 4}
    assert rep.hbm_bytes > 0 and rep.top_traffic


def test_roofline_terms_equal_reference():
    kw = dict(dot_flops=3.5e12, hbm_bytes=7.25e10,
              collective_bytes={"all-gather": 1.5e9, "all-reduce": 2.5e8})
    for n_chips, mf in ((256, 5e14), (512, 0.0)):
        got = TH.roofline_terms(TH.HloReport(**kw), n_chips=n_chips,
                                model_flops_total=mf)
        want = RH.roofline_terms(RH.HloReport(**kw), n_chips=n_chips,
                                 model_flops_total=mf)
        assert got == want
    assert (TH.PEAK_FLOPS, TH.HBM_BW, TH.LINK_BW) == (
        RH.PEAK_FLOPS, RH.HBM_BW, RH.LINK_BW)
    assert dataclasses.asdict(TH.HloReport()) == dataclasses.asdict(
        RH.HloReport())


SMOKE_CELLS = {
    "train": ("gemma3-1b", Shape("smoke_train", 32, 8, "train"),
              Plan(microbatches=2, remat="block")),
    "prefill": ("whisper-large-v3", Shape("smoke_prefill", 32, 4, "prefill"),
                Plan(policy="tp_only", remat="none", cache_mode="heads")),
    "decode": ("granite-moe-1b-a400m", Shape("smoke_decode", 64, 8, "decode"),
               Plan(policy="tp_fsdp", remat="none", cache_mode="seq",
                    moe_group=8)),
}


@pytest.mark.parametrize("mode", sorted(SMOKE_CELLS))
def test_smoke_cell_on_a_fake_mesh_ends_ok(mode):
    arch, shape, plan = SMOKE_CELLS[mode]
    cfg = get_config(arch).smoke()
    mesh_shape, axes = (2, 4), ("data", "model")
    with fake_mesh(mesh_shape, axes) as mesh:
        pred = predict_plan(cfg, shape, mesh_shape, axes, plan)
        rec = D._compile_cell(arch, shape.name, "smoke", mesh, cfg, shape,
                              plan, pred, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    terms = rec["roofline"]
    tokens = shape.global_batch * (1 if mode == "decode" else shape.seq_len)
    assert terms["model_flops_total"] == model_flops(
        cfg, tokens, "train" if mode == "train" else "serve")
    # the step computes at least the model FLOPs, but a prefill unembeds
    # only each row's last position, where the model FLOPs count all
    unembedded = shape.global_batch if mode == "prefill" else tokens
    skipped = 2.0 * (tokens - unembedded) * cfg.d_model * cfg.vocab
    assert 0.0 < terms["hlo_flops_total"]
    assert terms["hlo_flops_total"] >= terms["model_flops_total"] - skipped
    mem = rec["memory"]
    assert 0 < mem["argument_gb"] <= mem["peak_gb"]
    assert mem["fits_hbm"]
    # the counter and CommDebugMode see the same collectives
    names = {"all-gather": "all_gather_into_tensor",
             "reduce-scatter": "reduce_scatter_tensor",
             "all-reduce": "all_reduce", "all-to-all": "all_to_all_single"}
    debug = {k.split(".")[-1]: v for k, v in rec["comm_debug"].items()}
    assert {names[k]: v for k, v in rec["collective_count_run"].items()} \
        == debug
    if mode == "train":      # two microbatches: one run, counted twice
        assert rec["counted"] == "one microbatch x 2, the update once"
        assert all(rec["collective_count"][k] >= v for k, v in
                   rec["collective_count_run"].items())
    assert terms["collective_bytes_per_chip"] > 0
    json.dumps(rec)


def test_a_failing_cell_is_recorded(monkeypatch):
    def boom(*a, **k):
        raise IndexError("an op the step cannot run")
    monkeypatch.setattr(D, "build_and_lower", boom)
    cfg = get_config("gemma3-1b").smoke()
    shape = Shape("smoke_train", 32, 8, "train")
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        pred = predict_plan(cfg, shape, (2, 4), ("data", "model"), Plan())
        rec = D._compile_cell("gemma3-1b", shape.name, "smoke", mesh, cfg,
                              shape, Plan(), pred, verbose=False)
    assert rec["status"] == "FAILED"
    assert rec["error"] == "IndexError: an op the step cannot run"
    assert "traceback" in rec and "at" in rec


def test_main_skips_and_writes_its_record(tmp_path):
    out = tmp_path / "dryrun.json"
    assert D.main(["--arch", "gemma3-1b", "--shape", "long_500k",
                   "--mesh", "both", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec) == {"gemma3-1b|long_500k|single|baseline",
                        "gemma3-1b|long_500k|multi|baseline"}
    assert all(r["status"] == "skipped" for r in rec.values())
    assert D._plan_overrides(["microbatches=4", "remat=none",
                              "moe_group=64"]) == {
        "microbatches": 4, "remat": "none", "moe_group": 64}
    TM.release()


REFERENCE_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "torch_dryrun_reference.json")
MESH_KINDS = {"single": ((16, 16), ("data", "model")),
              "multi": ((2, 16, 16), ("pod", "data", "model"))}


def test_reference_file_plans_equal_the_planners():
    """Every cell of the committed reference records: its status is what
    ``shape_applicable`` says, and its plan is ``choose_plan``'s, so the
    file cannot drift from the planner."""
    from repro_torch.configs import all_configs
    from repro_torch.configs.shapes import SHAPES, shape_applicable
    from repro_torch.core.placement import choose_plan
    ref = json.load(open(REFERENCE_FILE))
    cells = ref["cells"]
    assert len(cells) == len(all_configs()) * len(SHAPES) * len(MESH_KINDS)
    assert ref["jax_version"]
    for key, rec in cells.items():
        arch, shape_name, kind = key.split("|")
        cfg, shape = get_config(arch), SHAPES[shape_name]
        applicable, _ = shape_applicable(cfg, shape)
        assert rec["status"] == ("ok" if applicable else "skipped"), key
        if applicable:
            plan, _ = choose_plan(cfg, shape, *MESH_KINDS[kind])
            assert dataclasses.asdict(plan) == rec["plan"], key
    assert sum(r["status"] == "ok" for r in cells.values()) == 64


# The reference's dry run of the smoke train cell on a (2, 4) mesh of its
# host devices, in a process of its own: ``repro.launch.dryrun`` sets
# XLA_FLAGS when it is imported, so no test imports it in this process.
_REFERENCE_SMOKE_CELL = """
import json, sys
import numpy as np
import repro.launch.dryrun as RD
import jax
from repro.configs import get_config
from repro.configs.shapes import SHAPES, Shape
from repro.core.placement import Plan, predict_plan
arch, seq, batch, mb, remat = json.loads(sys.argv[1])
cfg = get_config(arch).smoke()
shape = Shape("smoke_train", seq, batch, "train")
plan = Plan(microbatches=mb, remat=remat)
RD.get_config = lambda name: cfg
SHAPES[shape.name] = shape
mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]).reshape(2, 4),
                         ("data", "model"))
pred = predict_plan(cfg, shape, (2, 4), ("data", "model"), plan)
rec = RD._compile_cell(arch, shape.name, "smoke", mesh, cfg, shape, plan,
                       pred, verbose=False)
print("RECORD " + json.dumps(rec))
"""
PEAK_FACTOR = 4.0      # port peak within 4x of XLA's memory_analysis peak
FLOPS_FACTOR = 2.0     # port counted FLOPs within 2x of XLA's


def test_smoke_train_cell_against_the_reference_dry_run():
    """The smoke train cell on a (2, 4) mesh, the port's count against the
    reference's own compiled program: the port's peak within 4x of XLA's
    ``memory_analysis`` peak, and its counted FLOPs within 2x of XLA's,
    either way."""
    arch, shape, plan = SMOKE_CELLS["train"]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(root, "src"))
    args = json.dumps([arch, shape.seq_len, shape.global_batch,
                       plan.microbatches, plan.remat])
    out = subprocess.run([sys.executable, "-c", _REFERENCE_SMOKE_CELL, args],
                         env=env, cwd=root, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(next(line for line in out.stdout.splitlines()
                          if line.startswith("RECORD "))[len("RECORD "):])
    assert ref["status"] == "ok", ref.get("error")

    cfg = get_config(arch).smoke()
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        pred = predict_plan(cfg, shape, (2, 4), ("data", "model"), plan)
        rec = D._compile_cell(arch, shape.name, "smoke", mesh, cfg, shape,
                              plan, pred, verbose=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["plan"] == ref["plan"]
    c = D.against_reference(rec, ref)
    assert 1 / PEAK_FACTOR <= c["peak_ratio"] <= PEAK_FACTOR, c
    assert 1 / FLOPS_FACTOR <= c["flops_ratio"] <= FLOPS_FACTOR, c
    assert rec["gathered"] == {}


def test_against_reference_ratios_and_table():
    ref = json.load(open(REFERENCE_FILE))
    key = "gemma3-1b|train_4k|single"
    theirs = ref["cells"][key]
    ours = {"arch": "gemma3-1b", "shape": "train_4k", "mesh": "single",
            "status": "ok", "plan": theirs["plan"],
            "memory": {"peak_gb": 2 * theirs["memory"]["peak_gb"],
                       "fits_hbm": False},
            "roofline": {
                "hlo_flops_total": 3 * theirs["roofline"]["hlo_flops_total"],
                "collective_bytes_per_chip":
                    theirs["roofline"]["collective_bytes_per_chip"] / 4},
            "gathered": {"aten.view.default (outer)": 2}}
    c = D.against_reference(ours, theirs)
    assert c["peak_ratio"] == pytest.approx(2.0)
    assert c["flops_ratio"] == pytest.approx(3.0)
    assert c["collective_ratio"] == pytest.approx(0.25)
    skipped = {"arch": "gemma3-1b", "shape": "long_500k", "mesh": "single",
               "status": "skipped"}
    assert D.against_reference(skipped, ref["cells"][
        "gemma3-1b|long_500k|single"]) == {"port": "skipped",
                                             "reference": "skipped"}
    lines = D.comparison_table({"a": ours, "b": skipped}, ref)
    assert lines[2].startswith("| gemma3-1b long_500k | skipped / skipped")
    assert "(2.00x); " in lines[3] and "(3.00x); " in lines[3]
    assert lines[3].endswith("(0.25x); 2 gathered |  |")
    assert lines[-1].startswith("1 cells ok beside the reference; 1 with")
    with pytest.raises(ValueError):
        D.against_reference(dict(ours, plan=dict(theirs["plan"],
                                                 microbatches=1)), theirs)
