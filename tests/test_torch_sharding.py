"""The port's mesh and sharding layer (``repro_torch.launch.mesh`` /
``.sharding``) against the reference's rules: the partition spec of every
leaf of every config's parameter tree, train state and cache trees, at
full width, under the five policies and three cache modes, on both
production meshes (a fake process group of 256 or 512 ranks); the spec's
DTensor placements and the block order of a tensor dim split over two
mesh axes; ``ParallelCtx``'s mesh members; and the reference's own
sharding-rule tests, on the port."""
import jax
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

import repro.configs as Rcfg
import repro.launch.sharding as RS
import repro_torch.configs as Tcfg
import repro_torch.launch.sharding as TS
from repro.models import build_model as r_build_model
from repro.optim import OptConfig as ROpt
from repro.train.step import init_train_state as r_init_state
from repro_torch.launch import mesh as TM
from repro_torch.models import ParallelCtx, build_model
from repro_torch.optim import OptConfig
from repro_torch.train.step import init_train_state
from torch_port_util import fake_mesh

POLICIES = ("tp_fsdp", "tp_only", "fsdp_only", "fsdp_pod", "tp_fsdp_moeff")
CACHE_MODES = ("batch", "seq", "heads")
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_SHAPES = ("decode_32k", "long_500k")


class _RefMesh:
    """What the reference's ``_resolve`` reads of a mesh."""

    def __init__(self, shape, axes):
        self.axis_names = axes

        class devices:
            pass
        devices.shape = shape
        self.devices = devices


def _ref_trees(arch: str) -> dict:
    """The reference's trees as ShapeDtypeStructs (nothing allocated)."""
    cfg = Rcfg.get_config(arch)
    model = r_build_model(cfg)
    key = jax.random.key(0)
    trees = {"params": jax.eval_shape(lambda: model.init(key)),
             "state": jax.eval_shape(
                 lambda: r_init_state(model, key, ROpt()))}
    for s in CACHE_SHAPES:
        sh = Rcfg.SHAPES[s]
        trees[s] = jax.eval_shape(
            lambda sh=sh: model.init_cache(sh.global_batch, sh.seq_len))
    return trees


def _port_trees(arch: str) -> dict:
    """The port's trees as fake tensors (nothing allocated)."""
    cfg = Tcfg.get_config(arch)
    with FakeTensorMode():
        model = build_model(cfg, ParallelCtx(use_kernels=False), device="cpu")
        trees = {"params": model.init(torch.Generator()),
                 "state": init_train_state(model, torch.Generator(),
                                           OptConfig())}
        for s in CACHE_SHAPES:
            sh = Tcfg.SHAPES[s]
            trees[s] = model.init_cache(sh.global_batch, sh.seq_len)
    return trees


def _ref_specs(tree, mesh_shape, axes, policy, cache_mode) -> list:
    flat, _ = RS.tree_paths_and_leaves(tree)
    mesh = _RefMesh(mesh_shape, axes)
    baxes = tuple(a for a in axes if a != "model")
    return [(path, tuple(leaf.shape), tuple(RS._resolve(
        RS._logical_for(path, len(leaf.shape), cache_mode, policy),
        leaf.shape, mesh, policy, baxes))) for path, leaf in flat]


def _port_specs(tree, mesh, policy, cache_mode) -> list:
    baxes = TM.batch_axes(mesh)
    sh = TS.make_shardings(tree, mesh, policy=policy, batch_axes=baxes,
                           cache_mode=cache_mode)
    flat, _ = TS.tree_paths_and_leaves(tree)
    specs = [s for _, s in TS.tree_paths_and_leaves(sh)[0]]
    assert all(isinstance(s, TS.Sharding) and s.mesh is mesh for s in specs)
    return [(path, tuple(leaf.shape), tuple(s.spec))
            for (path, leaf), s in zip(flat, specs)]


@pytest.mark.parametrize("arch", sorted(Rcfg.all_configs()))
def test_specs_equal_reference_leaf_by_leaf(arch):
    ref, port = _ref_trees(arch), _port_trees(arch)
    for kind, (shape, axes) in MESHES.items():
        with fake_mesh(shape, axes) as mesh:
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            for tree in ("params", "state") + CACHE_SHAPES:
                modes = CACHE_MODES if tree in CACHE_SHAPES else ("batch",)
                for policy in POLICIES:
                    for cm in modes:
                        want = _ref_specs(ref[tree], shape, axes, policy, cm)
                        got = _port_specs(port[tree], mesh, policy, cm)
                        assert len(got) == len(want) > 0
                        assert got == want, (kind, tree, policy, cm)


def test_placements_of_specs():
    with fake_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        P = TS.PartitionSpec
        cases = {P(None, "model"): (Replicate(), Replicate(), Shard(1)),
                 P(("pod", "data"), None, "model"):
                     (Shard(0), Shard(0), Shard(2)),
                 P(("data", "pod"), "model"): (Shard(0), Shard(0), Shard(1)),
                 P(): (Replicate(),) * 3}
        for spec, want in cases.items():
            assert TS.Sharding(mesh, spec).placements() == want
            assert TS.spec_placements(mesh, spec) == want
        assert TS.replicated(mesh).placements() == (Replicate(),) * 3
        b = TS.batch_sharding({"tokens": torch.zeros(8, 4),
                               "odd": torch.zeros(3, 4)}, mesh,
                              TM.batch_axes(mesh))
        assert tuple(b["tokens"].spec) == (("pod", "data"), None)
        assert tuple(b["odd"].spec) == ()
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


@pytest.mark.parametrize("rank", range(8))
def test_two_axes_on_one_dim_split_in_mesh_order(rank):
    """``fsdp_pod`` names ``("data", "pod")`` for one tensor dim; the port
    splits it in the mesh's order, pod-major (JAX splits data-major).
    Every rank holds a block of the same size."""
    shape, axes = (2, 2, 2), ("pod", "data", "model")
    with fake_mesh(shape, axes, rank=rank) as mesh:
        spec = TS._resolve(("fsdp", "tp"), (8, 4), mesh, "fsdp_pod",
                           ("pod", "data"))
        assert tuple(spec) == (("data", "pod"), "model")
        full = torch.arange(32.0).reshape(8, 4)
        local = distribute_tensor(full, mesh, TS.Sharding(mesh, spec)
                                  .placements(), src_data_rank=None).to_local()
        pod, data, model = mesh.get_coordinate()
        row = (pod * 2 + data) * 2            # pod-major
        col = model * 2
        assert local.shape == (2, 2)
        assert torch.equal(local, full[row:row + 2, col:col + 2])


def test_production_meshes_and_batch_axes():
    for multi, (shape, axes) in ((False, MESHES["single"]),
                                 (True, MESHES["multi"])):
        TM.release()
        try:
            mesh = TM.make_production_mesh(multi_pod=multi)
            assert tuple(mesh.shape) == shape
            assert tuple(mesh.mesh_dim_names) == axes
            assert TM.batch_axes(mesh) == tuple(a for a in axes
                                                if a != "model")
        finally:
            TM.release()


def test_make_mesh_refuses_a_group_it_did_not_start():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    TM.release()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        with pytest.raises(RuntimeError, match="ranks"):
            TM.make_mesh((16, 16), ("data", "model"))
        TM.release()                      # not ours: left alone
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# ParallelCtx's mesh members
# ---------------------------------------------------------------------------
def test_ctx_shard_is_identity_without_a_mesh():
    x = torch.randn(4, 8)
    ctx = ParallelCtx(batch_axes=("data",), model_axis="model")
    assert ctx.shard(x, ("data",), "model") is x
    assert ParallelCtx().shard(x, None, None) is x
    assert ctx.head_axis(8) == "model"
    assert ParallelCtx(model_axis="model", model_size=16).head_axis(8) is None
    assert ParallelCtx().head_axis(8) is None


def test_ctx_shard_yields_the_resolved_placements():
    with fake_mesh((2, 4), ("data", "model")) as mesh:
        ctx = ParallelCtx(batch_axes=("data",), model_axis="model",
                          model_size=4, mesh=mesh)
        x = distribute_tensor(torch.randn(4, 6, 8, 2), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        y = ctx.shard(x, ctx.batch_axes or None, None,
                      ctx.head_axis(8), None)
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 6, 2, 2)
        assert ctx.shard(y, ("data",), None, "model", None) is y
        plain = torch.randn(3)
        assert ctx.shard(plain, "data") is plain


# ---------------------------------------------------------------------------
# the reference's sharding-rule tests (tests/test_launch.py), on the port
# ---------------------------------------------------------------------------
def test_logical_rules():
    lf = TS._logical_for
    assert lf("stack/rem/0/attn/wq", 2) == ("fsdp", "tp")
    assert lf("stack/rem/0/attn/wo", 2) == ("tp", "fsdp")
    assert lf("embed", 2) == ("tp", "fsdp")
    assert lf("stack/blocks/0/moe/wg", 3) == ("tp", "fsdp", None)
    # stacked scan layers get a leading None
    assert lf("stack/blocks/0/attn/wq", 3) == (None, "fsdp", "tp")
    # caches honor cache_mode
    assert lf("blocks/0/attn/k", 4) == ("batch", None, None, None)
    assert lf("blocks/0/attn/k", 4, "seq") == ("batch", "ctp", None, None)
    # 5-dim stacked cache pads a leading None
    assert lf("blocks/0/attn/k", 5, "heads") == (
        None, "batch", None, "ctp", None)
    assert lf("unknown/leaf", 3) == (None, None, None)


def test_resolve_divisibility_fallback():
    with fake_mesh((1, 1), ("data", "model")) as mesh:   # everything divides
        spec = TS._resolve(("fsdp", "tp"), (8, 8), mesh, "tp_fsdp",
                           ("data",))
        assert isinstance(spec, TS.PartitionSpec)
    with fake_mesh((4, 4), ("data", "model")) as mesh:
        spec = TS._resolve(("fsdp", "tp"), (6, 8), mesh, "tp_fsdp",
                           ("data",))
        assert spec[0] is None          # 6 % 4 != 0 -> replicated
        assert spec[1] == "model"
        spec = TS._resolve(("batch", None), (8, 3), mesh, "tp_fsdp",
                           ("data",))
        assert spec[0] == "data"
        # ctp always maps to model regardless of policy
        spec = TS._resolve(("batch", "ctp", None, None), (8, 64, 2, 4),
                           mesh, "fsdp_only", ("data",))
        assert spec[1] == "model"


def test_make_shardings_tree():
    with fake_mesh((1, 1), ("data", "model")) as mesh:
        tree = {"embed": torch.zeros((16, 8)),
                "stack": {"rem": ({"mlp": {"wg": torch.zeros((8, 32))}},)}}
        sh = TS.make_shardings(tree, mesh)
        flat, _ = TS.tree_paths_and_leaves(sh)
        assert [p for p, _ in flat] == ["embed", "stack/rem/0/mlp/wg"]
        assert all(hasattr(s, "spec") for _, s in flat)


def test_gather_on_refusal_runs_an_op_without_a_rule_on_replicas():
    """``searchsorted`` has no DTensor sharding rule: on replicated
    arguments every rank runs it on its own copies."""
    x = torch.sort(torch.randn(4, 6), dim=1).values
    with fake_mesh((2, 2), ("data", "model")) as mesh:
        d = distribute_tensor(x, mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with pytest.raises(NotImplementedError):
            torch.searchsorted(d, d)
        with TS.GatherOnRefusal() as g:
            got = torch.searchsorted(d, d * 0.5)
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == (Replicate(), Replicate())
        assert torch.equal(got.to_local(), torch.searchsorted(x, x * 0.5))
        assert g.gathered == {"aten.searchsorted.Tensor (local)": 1}
