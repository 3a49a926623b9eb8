"""Training on a mesh: ``repro_torch.launch.train`` on a one-rank CPU
mesh (a gloo group of one) against the same steps on plain tensors; a
model's forward with the ``ParallelCtx`` mesh fields set against the
forward without them; and checkpoints of DTensor state, written by the
port or by the reference, restored bit for bit with their placements.
Held within 1e-6 relative (a one-rank mesh runs the same local ops)."""
import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

import repro.checkpoint as Rck
import repro.optim as Ro
from repro.models import build_model as r_build_model
from repro.train.step import init_train_state as r_init_state
import repro_torch.checkpoint as Tck
from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, synthetic_batches
from repro_torch.launch import mesh as TM
from repro_torch.launch import train as train_launch
from repro_torch.launch.sharding import (GatherOnRefusal, batch_sharding,
                                         make_shardings, place)
from repro_torch.models import ParallelCtx, build_model
from repro_torch.optim import OptConfig
from repro_torch.train.step import init_train_state, make_train_step
from torch_port_util import host_mesh

torch.set_num_threads(1)

REL = 1e-6


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("arch,microbatches", [("gemma3-1b", 1),
                                               ("granite-moe-1b-a400m", 2)])
def test_launch_train_on_a_mesh_equals_plain_steps(tmp_path, arch,
                                                   microbatches):
    steps, B, S = 3, 4, 16
    rep = train_launch.run(train_launch.parse_args(
        ["--smoke", "--device", "cpu", "--arch", arch, "--steps",
         str(steps), "--batch", str(B), "--seq", str(S), "--microbatches",
         str(microbatches), "--log-every", "100", "--ckpt-every", "100",
         "--ckpt-dir", str(tmp_path)]))
    assert not torch.distributed.is_initialized()     # its group released
    assert not any(isinstance(x, DTensor) for x in tr.leaves(rep.state))

    cfg = get_config(arch).smoke()
    model = build_model(cfg, ParallelCtx(use_kernels=False,
                                         compute_dtype=torch.float32),
                        device="cpu")
    opt = OptConfig(lr=3e-3, warmup_steps=5, decay_steps=steps)
    state = init_train_state(model, torch.Generator().manual_seed(0), opt)
    step = make_train_step(model, opt, microbatches=microbatches)
    data = synthetic_batches(DataConfig(batch=B, seq=S, vocab=cfg.vocab,
                                        seed=0), cfg)
    for i in range(steps):
        batch = {k: torch.as_tensor(v) for k, v in next(data).items()}
        state, m = step(state, batch)
        assert _rel(rep.losses[i], float(m["loss"])) <= REL
        assert _rel(rep.grad_norms[i], float(m["grad_norm"])) <= REL
        assert rep.lrs[i] == float(m["lr"])
    for a, b in zip(tr.leaves(rep.state), tr.leaves(state)):
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, rtol=REL, atol=REL)


FORWARD = {"dense": ("gemma3-1b", {}),
           "moe": ("granite-moe-1b-a400m", {"moe_impl": "einsum"}),
           "encdec": ("whisper-large-v3", {})}


@pytest.mark.parametrize("family", sorted(FORWARD))
def test_forward_with_mesh_fields_equals_without(family):
    arch, over = FORWARD[family]
    cfg = get_config(arch).smoke().scaled(**over) if over else \
        get_config(arch).smoke()
    plain_ctx = ParallelCtx(use_kernels=False, compute_dtype=torch.float32)
    plain = build_model(cfg, plain_ctx, device="cpu")
    params = plain.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (4, 16)))}
    if cfg.is_encdec:
        batch["frames"] = torch.as_tensor(rng.standard_normal(
            (4, cfg.src_seq, cfg.d_model)).astype(np.float32))
    want, want_aux = plain.forward(params, batch)
    with host_mesh() as mesh:
        ctx = ParallelCtx(batch_axes=TM.batch_axes(mesh), model_axis="model",
                          mesh=mesh, use_kernels=False,
                          compute_dtype=torch.float32)
        model = build_model(cfg, ctx, device="cpu")
        dparams = place(params, make_shardings(params, mesh))
        dbatch = place(batch, batch_sharding(batch, mesh, ctx.batch_axes))
        with GatherOnRefusal():
            got, aux = model.forward(dparams, dbatch)
        got, aux = got.full_tensor(), aux.full_tensor() \
            if isinstance(aux, DTensor) else aux
    torch.testing.assert_close(got, want, rtol=REL, atol=REL)
    torch.testing.assert_close(aux, want_aux, rtol=REL, atol=REL)


def _dtensor_state(mesh, arch="gemma3-1b"):
    model = build_model(get_config(arch).smoke(),
                        ParallelCtx(use_kernels=False), device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(1),
                             OptConfig())
    state["opt"]["m"] = tr.tree_map(lambda x: x.to(torch.bfloat16),
                                    state["opt"]["m"])
    return place(state, make_shardings(state, mesh))


def test_checkpoint_of_dtensor_state_restores_bit_for_bit(tmp_path):
    with host_mesh() as mesh:
        state = _dtensor_state(mesh)
        Tck.save(state, str(tmp_path), 5)
        like = tr.tree_map(torch.zeros_like, state)
        back = Tck.restore(str(tmp_path), like)
        for a, b in zip(tr.leaves(back), tr.leaves(state)):
            assert isinstance(a, DTensor)
            assert a.placements == b.placements and a.device_mesh is mesh
            assert a.dtype == b.dtype
            assert torch.equal(a.to_local(), b.to_local())
        # the files hold whole tensors, as the reference's
        plain = Tck.restore(str(tmp_path), tr.tree_map(
            lambda x: x.full_tensor(), like))
        for a, b in zip(tr.leaves(plain), tr.leaves(state)):
            assert not isinstance(a, DTensor)
            assert torch.equal(a, b.full_tensor())


def test_reference_checkpoint_restores_into_dtensor_state(tmp_path):
    from repro.configs import get_config as r_get_config
    r_model = r_build_model(r_get_config("gemma3-1b").smoke())
    r_state = r_init_state(r_model, jax.random.key(0), Ro.OptConfig())
    Rck.save(r_state, str(tmp_path), 3)
    want = [np.asarray(x) for x in jax.tree.leaves(r_state)]
    with host_mesh() as mesh:
        like = _dtensor_state(mesh)
        like["opt"]["m"] = tr.tree_map(lambda x: x.float(), like["opt"]["m"])
        back = Tck.restore(str(tmp_path), like)
        got = tr.leaves(back)
        assert len(got) == len(want)
        for a, b, l in zip(got, want, tr.leaves(like)):
            assert isinstance(a, DTensor) and a.placements == l.placements
            np.testing.assert_array_equal(a.full_tensor().numpy(), b)


def test_prefill_and_decode_on_a_mesh_equal_plain():
    """The cache as DTensors: prefill writes it, each decode step writes
    its slot by a masked select (DTensor cannot index-put in place)."""
    cfg = get_config("gemma3-1b").smoke()
    plain = build_model(cfg, ParallelCtx(use_kernels=False,
                                         compute_dtype=torch.float32),
                        device="cpu")
    params = plain.init(torch.Generator().manual_seed(5))
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    cache = plain.init_cache(2, 16, dtype=torch.float32)
    want = [plain.prefill(params, {"tokens": tokens}, cache)[0]]
    for i in range(3):
        pos = torch.full((2,), 12 + i)
        want.append(plain.decode_step(params, cache, tokens[:, i:i + 1],
                                      pos)[0])
    with host_mesh() as mesh:
        ctx = ParallelCtx(batch_axes=TM.batch_axes(mesh), model_axis="model",
                          mesh=mesh, use_kernels=False,
                          compute_dtype=torch.float32)
        model = build_model(cfg, ctx, device="cpu")
        dparams = place(params, make_shardings(params, mesh))
        dcache = model.init_cache(2, 16, dtype=torch.float32)
        dcache = place(dcache, make_shardings(dcache, mesh, cache_mode="seq"))
        with GatherOnRefusal():
            got = [model.prefill(dparams, {"tokens": tokens}, dcache)[0]]
            for i in range(3):
                pos = torch.full((2,), 12 + i)
                got.append(model.decode_step(dparams, dcache,
                                             tokens[:, i:i + 1], pos)[0])
        got = [g.full_tensor() for g in got]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=REL, atol=REL)
