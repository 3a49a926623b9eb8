"""Serving on the port against the reference package: ``ServeEngine`` on
carried recurrentgemma-9b smoke weights (float32) gives the same tokens and
the same slot counters, the ``launch.serve`` driver runs end to end on the
CPU, and ``place_tenants`` places the tenants on the same simulated chips.

Tokens are argmaxes of logits that agree to ~1e-6 (tests/test_torch_models.py),
so they are compared for identity."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.launch.serve as r_serve
from repro.configs import get_config as r_config
from repro.models import ParallelCtx as RCtx, build_model as r_build
from repro.serve.engine import Request as RRequest, ServeEngine as RServe
import repro_torch.launch.serve as t_serve
from repro_torch.configs import get_config as t_config
from repro_torch.interop import params_from_numpy
from repro_torch.models import ParallelCtx as TCtx, build_model as t_build
from repro_torch.serve.engine import Request as TRequest, ServeEngine as TServe
from torch_port_util import export_params

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"


def _prompts(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(2, 7)).astype(np.int32)
            for _ in range(n)]


def _engines(max_slots=3, max_len=32):
    rcfg = r_config(ARCH).smoke()
    rmodel = r_build(rcfg, RCtx(compute_dtype=jnp.float32))
    rparams = rmodel.init(jax.random.key(0))
    tcfg = t_config(ARCH).smoke()
    tmodel = t_build(tcfg, TCtx(compute_dtype=torch.float32), device="cpu")
    tparams = params_from_numpy(tcfg, export_params(rparams), device="cpu")
    return (RServe(rmodel, rparams, max_slots=max_slots, max_len=max_len),
            TServe(tmodel, tparams, max_slots=max_slots, max_len=max_len),
            rcfg.vocab)


def test_serve_engine_run_matches_reference():
    """Seven requests over three slots: admission waves, continuous
    batching, slot recycling, and requests capped by ``max_len``."""
    reng, teng, vocab = _engines(max_slots=3, max_len=12)
    prompts = _prompts(vocab, 7)
    new = [4, 9, 3, 6, 12, 2, 5]
    rdone = reng.run([RRequest(i, p, max_new=m)
                      for i, (p, m) in enumerate(zip(prompts, new))])
    tdone = teng.run([TRequest(i, p, max_new=m)
                      for i, (p, m) in enumerate(zip(prompts, new))])
    assert [r.rid for r in tdone] == [r.rid for r in rdone]
    assert {r.rid: r.out for r in tdone} == {r.rid: r.out for r in rdone}
    for attr in ("admitted_total", "slot_rejections", "_tokens_decoded"):
        assert getattr(teng, attr) == getattr(reng, attr), attr
    assert teng.free == reng.free and not teng.active


def test_admission_reports_slot_exhaustion_like_reference():
    reng, teng, vocab = _engines(max_slots=2)
    prompts = _prompts(vocab, 4, seed=1)
    out = []
    for eng, Req in ((reng, RRequest), (teng, TRequest)):
        reqs = [Req(i, p) for i, p in enumerate(prompts)]
        admitted = eng.admit_many(reqs[:3])
        refused = eng.admit(reqs[3])
        out.append(([r.rid for r in admitted],
                    [r.rid for r in eng.last_admission.rejected], refused,
                    eng.admitted_total, eng.slot_rejections,
                    [r.out for r in admitted], eng.pos.tolist()))
    assert out[0] == out[1]


def test_place_tenants_matches_reference():
    want = r_serve.place_tenants(5, slo_s=0.05, est_s=0.02)
    got = t_serve.place_tenants(5, slo_s=0.05, est_s=0.02, device="cpu")
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9, atol=1e-12)


def test_serve_main_runs_on_cpu(capsys):
    argv = ["--arch", ARCH, "--requests", "5", "--slots", "2",
            "--max-new", "3", "--max-len", "16", "--smoke", "--device", "cpu"]
    assert t_serve.main(argv) == 0
    text = capsys.readouterr().out
    assert "[serve] 5 requests, 15 tokens" in text
    report = t_serve.run(t_serve.parse_args(argv))
    assert len(report.done) == 5 and report.tokens == 15
    assert all(len(r.out) == 3 for r in report.done)
    assert report.admitted_total == 5 and len(report.latencies) == 5
