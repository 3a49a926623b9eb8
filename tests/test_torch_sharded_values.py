"""The sharded step's values on more than one rank: four CPU processes on
gloo (a ``FileStore`` under ``tmp_path``) form a (2, 2) ``("data",
"model")`` mesh and run a smoke gemma3's train step (two microbatches,
``remat="block"``) and its prefill, and a smoke granite-moe's (its
experts split over the model axis), on DTensors placed by the ``tp_fsdp``
policy, against the port's plain step on plain tensors in this process:
the loss, the moments and the prefill logits within 1e-6; the updated
parameters within 1e-6 plus what each side's own moments explain of
Adam's ill-conditioned step (``test_torch_train.py``'s rule: the ranks'
partial sums round apart from the plain sums, and a gradient near
``eps`` turns that into a visible step).  The plain step is held against
the reference by ``test_torch_train.py``, so this closes the chain to
the reference.

Also on the four ranks: the vocabulary-sharded loss moves only rows
across ranks.  Its collectives, forward and backward, carry tensors of
at most a rank's (B, S) rows, the same bytes at two vocabulary sizes, and
the logits' gradient keeps the logits' placements."""
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch import tree as tr
from repro_torch.configs import get_config
from repro_torch.models import ParallelCtx, build_model
from repro_torch.optim import OptConfig
from repro_torch.train.step import (cross_entropy, init_train_state,
                                    make_train_step)

REL = 1e-6
WORLD, MESH = 4, (2, 2)
B, S, MICROBATCHES = 8, 16, 2
VOCABS = (512, 1024)          # the loss's bytes at two vocabulary sizes


# a dense model over two microbatches (4 heads, one kv head, vocab 512),
# and an MoE model (4 experts, top 2, GQA 4:2) with 8 groups of 16 tokens
MODELS = {"gemma3": ("gemma3-1b", {}, MICROBATCHES),
          "moe": ("granite-moe-1b-a400m", {"moe_group": 16}, 1)}


def _cfg(name: str):
    arch, over, _ = MODELS[name]
    cfg = get_config(arch).smoke()
    return cfg.scaled(**over) if over else cfg


def _opt() -> OptConfig:
    return OptConfig(lr=3e-3, warmup_steps=1, decay_steps=4)


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(7)
    return {k: torch.as_tensor(rng.integers(0, vocab, (B, S)))
            for k in ("tokens", "labels")}


def _labels_with_ignored(vocab: int) -> torch.Tensor:
    rng = np.random.default_rng(11)
    labels = rng.integers(0, vocab, (B, S))
    labels[rng.random((B, S)) < 0.25] = -1
    return torch.as_tensor(labels)


def _logits(vocab: int) -> torch.Tensor:
    rng = np.random.default_rng(13)
    return torch.as_tensor(rng.standard_normal((B, S, vocab)).astype(
        np.float32) * 4)


class _Collectives(TorchDispatchMode):
    """Records the element count of every functional collective's input
    that the DTensors below it issue."""

    def __init__(self) -> None:
        super().__init__()
        self.numels: list[int] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if (func.namespace == "_c10d_functional"
                and func._overloadpacket.__name__ != "wait_tensor"):
            self.numels += [t.numel() for t in tree_leaves(args[0])
                            if isinstance(t, torch.Tensor)]
        return func(*args, **(kwargs or {}))


def _loss_collectives(mesh, vocab: int) -> dict:
    """The loss forward and backward on logits split over the batch
    (data) and the vocabulary (model)."""
    from repro_torch.launch.sharding import P, Sharding, place
    logits = place(_logits(vocab), Sharding(mesh, P("data", None, "model")))
    logits.requires_grad_(True)
    labels = place(_labels_with_ignored(vocab), Sharding(mesh, P("data")))
    rec = _Collectives()
    with rec:
        loss = cross_entropy(logits, labels)
        (grad,) = torch.autograd.grad(loss, logits)
    return dict(loss=float(loss.full_tensor()), numels=rec.numels,
                grad=grad.full_tensor(),
                grad_placements=tuple(grad.placements),
                logits_placements=tuple(logits.placements))


def _worker(rank: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, WORLD),
                            rank=rank, world_size=WORLD)
    try:
        _run_rank(rank, out)
    finally:
        dist.destroy_process_group()


def _run_rank(rank: int, out: str) -> None:
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh(MESH, ("data", "model"))
    runs = {name: _run_model(mesh, name) for name in MODELS}
    losses = {v: _loss_collectives(mesh, v) for v in VOCABS}
    if rank == 0:
        torch.save(dict(runs=runs, losses=losses), out)


def _run_model(mesh, name: str) -> dict:
    from repro_torch.launch.sharding import (GatherOnRefusal,
                                             batch_sharding, make_shardings,
                                             place)
    cfg, microbatches = _cfg(name), MODELS[name][2]
    ctx = ParallelCtx(batch_axes=("data",), model_axis="model",
                      model_size=MESH[1], mesh=mesh, use_kernels=False,
                      remat="block", compute_dtype=torch.float32)
    model = build_model(cfg, ctx, device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), _opt())
    params0 = tr.tree_map(torch.clone, state["params"])
    state = place(state, make_shardings(state, mesh, policy="tp_fsdp",
                                        batch_axes=ctx.batch_axes))
    batch = _batch(cfg.vocab)
    step = make_train_step(model, _opt(), microbatches=microbatches)
    with GatherOnRefusal() as g:
        state, metrics = step(state, place(batch, batch_sharding(
            batch, mesh, ctx.batch_axes)))
        params = [p.full_tensor() for p in tr.leaves(state["params"])]
        moments = [[x.full_tensor() for x in tr.leaves(state["opt"][k])]
                   for k in ("m", "v")]
        loss = float(metrics["loss"].full_tensor())

        dparams = place(params0, make_shardings(params0, mesh,
                                                policy="tp_fsdp",
                                                batch_axes=ctx.batch_axes))
        cache = model.init_cache(B, S, dtype=torch.float32)
        cache = place(cache, make_shardings(cache, mesh, policy="tp_fsdp",
                                            batch_axes=ctx.batch_axes))
        tokens = place(batch["tokens"], batch_sharding(
            batch["tokens"], mesh, ctx.batch_axes))
        logits, _ = model.prefill(dparams, {"tokens": tokens}, cache)
        prefill = logits.full_tensor()
    return dict(loss=loss, params=params, moments=moments, prefill=prefill,
                gathered=dict(g.gathered))


def _sharded_run(tmp_path) -> dict:
    out = str(tmp_path / "rank0.pt")
    mp.start_processes(_worker, args=(str(tmp_path / "store"), out),
                       nprocs=WORLD, start_method="spawn")
    return torch.load(out, weights_only=False)


def _plain_run(name: str):
    cfg, microbatches = _cfg(name), MODELS[name][2]
    model = build_model(cfg, ParallelCtx(use_kernels=False, remat="block",
                                         compute_dtype=torch.float32),
                        device="cpu")
    state = init_train_state(model, torch.Generator().manual_seed(0), _opt())
    params0 = tr.tree_map(torch.clone, state["params"])
    step = make_train_step(model, _opt(), microbatches=microbatches)
    state, metrics = step(state, _batch(cfg.vocab))
    cache = model.init_cache(B, S, dtype=torch.float32)
    prefill, _ = model.prefill(params0, {"tokens": _batch(cfg.vocab)[
        "tokens"]}, cache)
    moments = [tr.leaves(state["opt"][k]) for k in ("m", "v")]
    return (float(metrics["loss"]), tr.leaves(state["params"]), moments,
            prefill)


def _adam_ratio(m, v, cfg: OptConfig) -> torch.Tensor:
    """Adam's first step ``m_hat / (sqrt(v_hat) + eps)`` in float64."""
    m, v = m.double(), v.double()
    return (m / (1 - cfg.b1)) / (torch.sqrt(v / (1 - cfg.b2)) + cfg.eps)


def test_sharded_step_and_prefill_on_four_ranks_equal_plain(tmp_path):
    torch.set_num_threads(1)
    out = _sharded_run(tmp_path)
    for name in MODELS:
        got = out["runs"][name]
        loss, params, moments, prefill = _plain_run(name)

        # the train step: the loss, the moments, then every new parameter
        assert abs(got["loss"] - loss) <= REL * abs(loss), name
        for got_k, want_k in zip(got["moments"], moments):
            for a, b in zip(got_k, want_k):
                torch.testing.assert_close(a, b, rtol=REL, atol=REL)
        assert len(got["params"]) == len(params)
        opt, n_wide, n = _opt(), 0, 0
        for a, b, gm, gv, pm, pv in zip(got["params"], params,
                                        *got["moments"], *moments):
            lr = opt.lr      # step 1 ends the one-step warmup: lr whole
            wide = lr * (_adam_ratio(gm, gv, opt) - _adam_ratio(pm, pv, opt)
                         ).abs()
            n_wide, n = n_wide + int((wide > REL).sum()), n + wide.numel()
            bound = REL + REL * b.double().abs() + wide
            assert bool(((a.double() - b.double()).abs() <= bound).all())
        assert n_wide < 0.01 * n, (name, n_wide, n)
        # nothing of the step or the prefill fell back to a gathered op
        assert got["gathered"] == {}, (name, got["gathered"])
        # prefill: the last position's logits
        torch.testing.assert_close(got["prefill"], prefill, rtol=REL,
                                   atol=REL)

    # the vocabulary-sharded loss: values and gradient against plain ones
    rows = (B // MESH[0]) * S            # a rank's (B, S) rows
    for vocab in VOCABS:
        rec = out["losses"][vocab]
        logits = _logits(vocab).requires_grad_(True)
        want = cross_entropy(logits, _labels_with_ignored(vocab))
        (want_grad,) = torch.autograd.grad(want, logits)
        assert abs(rec["loss"] - float(want)) <= REL * abs(float(want))
        torch.testing.assert_close(rec["grad"], want_grad, rtol=REL,
                                   atol=REL)
        assert rec["logits_placements"] == (Shard(0), Shard(2))
        assert rec["grad_placements"] == rec["logits_placements"]
        # only rows cross ranks, never a tensor of the vocabulary's width
        assert rec["numels"] and max(rec["numels"]) <= rows
    small, large = (out["losses"][v]["numels"] for v in VOCABS)
    assert small == large
