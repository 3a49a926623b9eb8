"""The port's placement search (``repro_torch.core.placement``) against the
reference's, with ``==``: every candidate plan, every field of its
predicted cost, the chosen plan, the model FLOPs and the cache bytes, for
all ten configs x four shapes on the (16, 16) and (2, 16, 16) meshes; and
the reference's own placement tests, on the port."""
import dataclasses

import pytest

import repro.configs as Rcfg
import repro.core.placement as R
import repro_torch.configs as Tcfg
import repro_torch.core.placement as T
from repro.core.topology import build_tpu_fleet as r_fleet
from repro_torch.core.topology import build_tpu_fleet as t_fleet

MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")))
COST_FIELDS = ("mem_bytes", "t_compute", "t_memory", "t_collective",
               "flops_chip", "coll_bytes_chip", "t_step", "fits")


def _cost(c) -> tuple:
    return tuple(getattr(c, f) for f in COST_FIELDS)


def _plan(p) -> tuple:
    return dataclasses.astuple(p)


@pytest.mark.parametrize("arch", sorted(Rcfg.all_configs()))
def test_placement_equals_reference(arch):
    rc, tc = Rcfg.get_config(arch), Tcfg.get_config(arch)
    for sname in Rcfg.SHAPES:
        rs, ts = Rcfg.SHAPES[sname], Tcfg.SHAPES[sname]
        r_cands = R.candidate_plans(rc, rs)
        t_cands = T.candidate_plans(tc, ts)
        assert [_plan(p) for p in t_cands] == [_plan(p) for p in r_cands]
        for shape, axes in MESHES:
            for rp, tp in zip(r_cands, t_cands):
                assert _cost(T.predict_plan(tc, ts, shape, axes, tp)) == \
                    _cost(R.predict_plan(rc, rs, shape, axes, rp))
            rplan, rcost = R.choose_plan(rc, rs, shape, axes)
            tplan, tcost = T.choose_plan(tc, ts, shape, axes)
            assert _plan(tplan) == _plan(rplan) and _cost(tcost) == _cost(rcost)
        for mode in ("train", "serve"):
            assert T.model_flops(tc, 12345.0, mode) == \
                R.model_flops(rc, 12345.0, mode)
        B, S = rs.global_batch, rs.seq_len
        assert T.cache_bytes_total(tc, B, S) == R.cache_bytes_total(rc, B, S)


@pytest.mark.parametrize("arch", ["gemma3-4b", "llama4-maverick-400b-a17b"])
def test_choose_plan_with_a_chip_equals_reference(arch):
    """The paper's predict() path: the chip's RooflineModel scores each
    candidate."""
    r_chip = r_fleet(1, 1, 1).graph.pus()[0]
    t_chip = t_fleet(1, 1, 1, device="cpu").graph.pus()[0]
    for sname in ("train_4k", "decode_32k"):
        for shape, axes in MESHES:
            rplan, rcost = R.choose_plan(Rcfg.get_config(arch),
                                         Rcfg.SHAPES[sname], shape, axes,
                                         chip=r_chip)
            tplan, tcost = T.choose_plan(Tcfg.get_config(arch),
                                         Tcfg.SHAPES[sname], shape, axes,
                                         chip=t_chip)
            assert _plan(tplan) == _plan(rplan) and _cost(tcost) == _cost(rcost)


def test_budget_is_the_reference_v5e():
    assert T.HBM_BYTES == R.HBM_BYTES == 16e9
    assert T.HBM_BUDGET == R.HBM_BUDGET


# ---------------------------------------------------------------------------
# the reference's placement tests (tests/test_launch.py), on the port
# ---------------------------------------------------------------------------
def test_choose_plan_fits_most_cells():
    notes = []
    for arch in Tcfg.all_configs():
        cfg = Tcfg.get_config(arch)
        for sname in ("train_4k", "prefill_32k", "decode_32k"):
            plan, cost = T.choose_plan(cfg, Tcfg.SHAPES[sname], (16, 16),
                                       ("data", "model"))
            if plan.notes:
                notes.append((arch, sname))
    # only 400B-class cells may be structurally infeasible on one pod
    assert all("llama4" in a for a, _ in notes), notes


def test_plan_prefers_conservative_dtypes():
    cfg = Tcfg.get_config("gemma3-1b")
    plan, _ = T.choose_plan(cfg, Tcfg.SHAPES["train_4k"], (16, 16),
                            ("data", "model"))
    assert plan.param_dtype == "float32"
    assert plan.state_dtype == "float32"


def test_predict_plan_memory_monotonic_in_microbatches():
    cfg = Tcfg.get_config("gemma3-4b")
    mems = []
    for mb in (1, 4, 16):
        c = T.predict_plan(cfg, Tcfg.SHAPES["train_4k"], (16, 16),
                           ("data", "model"), T.Plan(microbatches=mb))
        mems.append(c.mem_bytes)
    assert mems[0] > mems[1] > mems[2]


def test_model_flops_moe_uses_active_params():
    dense = Tcfg.get_config("minitron-4b")
    moe = Tcfg.get_config("llama4-maverick-400b-a17b")
    f_moe = T.model_flops(moe, 1e6, "train")
    # active-param flops must be ~25x below total-param flops for 400b/17b
    f_if_total = 6.0 * moe.param_count() * 1e6
    assert f_moe < 0.15 * f_if_total
    assert T.model_flops(dense, 1e6, "serve") == pytest.approx(
        T.model_flops(dense, 1e6, "train") / 3.0)


def test_cache_bytes_families():
    g3 = T.cache_bytes_total(Tcfg.get_config("gemma3-4b"), B=1, S=32768)
    rw = T.cache_bytes_total(Tcfg.get_config("rwkv6-1.6b"), B=1, S=32768)
    assert rw < g3 / 50       # state-space cache is constant in S
    # and truly constant: quadrupling S must not change it
    assert rw == T.cache_bytes_total(Tcfg.get_config("rwkv6-1.6b"), B=1,
                                     S=131072)


def test_multipod_candidates_include_pod_fsdp():
    cfg = Tcfg.get_config("llama4-maverick-400b-a17b")
    plans = T.candidate_plans(cfg, Tcfg.SHAPES["train_4k"])
    assert any(p.policy == "fsdp_pod" for p in plans)
    plan, cost = T.choose_plan(cfg, Tcfg.SHAPES["train_4k"], (2, 16, 16),
                               ("pod", "data", "model"))
    assert cost.mem_bytes < 16e9 or plan.notes
