"""The port stands alone and runs where it is told to: it imports neither
``jax`` nor the reference package, and every entry point raises without a
CUDA device unless given ``device="cpu"``."""
import os
import subprocess
import sys

import pytest
import torch

import repro_torch.core as T
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.launch import train as train_launch
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.step import init_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_and_chip_smoke_import_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.core, repro_torch.interop\n"
        "import repro_torch.kernels.build, repro_torch.kernels.flash_attention\n"
        "import repro_torch.kernels.lru_scan, repro_torch.configs\n"
        "import repro_torch.models, repro_torch.models.transformer\n"
        "import repro_torch.models.moe, repro_torch.configs.shapes\n"
        "import repro_torch.serve.engine, repro_torch.launch.serve\n"
        "import repro_torch.serve.admission, repro_torch.core.serving\n"
        "import repro_torch.optim, repro_torch.train.step, repro_torch.tree\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint\n"
        "import repro_torch.ft.manager, repro_torch.launch.train\n"
        "import repro_torch.core.placement, repro_torch.launch.mesh\n"
        "import repro_torch.launch.sharding, repro_torch.launch.hlo_analysis\n"
        "import repro_torch.launch.dryrun\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'repro' or m.startswith('repro.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT, env.get("PYTHONPATH", "")])
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_or_reference_import():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    hits = [(f, line) for f in files for line in open(f) if pat.match(line)]
    assert not hits, hits

torch.set_num_threads(1)   # tiny tensors; keep pytest workers off each other


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _cpu_graph():
    return T.build_testbed(device="cpu").graph


def _smoke_cfg():
    return get_config("recurrentgemma-9b").smoke()


def _model_without_cpu_request():
    model = build_model(_smoke_cfg(), device="cpu")
    model._device_req = None      # as if built without device="cpu"
    return model


ENTRY_POINTS = {
    "resolve_device": lambda g: resolve_device(None),
    "build_testbed": lambda g: T.build_testbed(),
    "HWGraph.compiled": lambda g: T.HWGraph().compiled(),
    "DecoupledSlowdown": lambda g: T.DecoupledSlowdown(g),
    "NoSlowdown": lambda g: T.NoSlowdown(g),
    "Traverser": lambda g: T.Traverser(g),
    "heye_traverser": lambda g: T.heye_traverser(g),
    "ground_truth_traverser": lambda g: T.ground_truth_traverser(g),
    "ActiveLedger": lambda g: T.ActiveLedger(),
    "build_orchestrators": lambda g: T.build_orchestrators(g, None),
    "SchedulerSession": lambda g: T.SchedulerSession(g, lambda t, now: None),
    "ServeLoop": lambda g: T.ServeLoop(g, lambda t, now: None, []),
    "graph_from_spec": lambda g: interop.graph_from_spec(
        {"nodes": [], "edges": []}),
    "snapshot_from_numpy": lambda g: interop.snapshot_from_numpy({}),
    "ledger_from_numpy": lambda g: interop.ledger_from_numpy({}),
    "build_tpu_fleet": lambda g: T.build_tpu_fleet(1, 1, 2),
    "build_model.init": lambda g: build_model(_smoke_cfg()).init(
        torch.Generator()),
    "Model.init_cache": lambda g: build_model(_smoke_cfg()).init_cache(1, 8),
    "ServeEngine": lambda g: ServeEngine(_model_without_cpu_request(), None),
    "params_from_numpy": lambda g: interop.params_from_numpy(
        _smoke_cfg(), {"stack": {"blocks": (), "rem": ()}}),
    "init_train_state": lambda g: init_train_state(
        build_model(_smoke_cfg()), torch.Generator()),
    "launch.train.main": lambda g: train_launch.main(
        ["--smoke", "--steps", "1", "--batch", "2", "--seq", "8"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_cuda_unless_cpu_is_asked(no_cuda, name):
    g = _cpu_graph()
    g._device_req = None          # as if built without device="cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name](g)


def test_explicit_cpu_is_honoured_and_inherited(no_cuda):
    g = _cpu_graph()
    cpu = torch.device("cpu")
    assert g.device == cpu and g.compiled().device == cpu
    trav = T.heye_traverser(g)
    root = T.build_orchestrators(g, trav)
    sess = T.SchedulerSession(g, root)
    assert trav.device == trav.slowdown.device == cpu
    assert root.ledger.device == root.device == sess.device == cpu
    assert g.compiled().ncr_rclass.device == cpu


def test_cuda_request_without_cuda_raises(no_cuda):
    with pytest.raises(RuntimeError):
        resolve_device("cuda")


def test_chip_smoke_fails_without_cuda():
    """No CPU path in the smoke script: exit code != 0, no result line."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a CUDA device")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


# ---------------------------------------------------------------------------
# every public name of a reference module is in its port
# ---------------------------------------------------------------------------
# The reference's names the port does not carry, each with its reason.
NOT_PORTED = {
    # TPU-only: the Pallas kernels and their forced entry points (the port's
    # kernels are CUDA, behind their own wrappers), and the pytree alias
    "*_pallas": "a Pallas kernel (TPU)",
    "*_forced": "a Pallas kernel forced on (TPU)",
    "kernels/flash_attention.py:flash_attention_bhsd":
        "the Pallas kernel itself (pallas_call, TPU); the port's is "
        "flash_attention",
    "*:Pytree": "JAX's pytree alias",
    # the reference's numpy oracles stay in the reference; the port's tests
    # import them from there, as they import kernels/ref.py
    "kernels/walk_kernel.py:scan_reduce_ref": "a numpy oracle of the tests",
    # XLA's HLO text: torch produces none (launch/hlo_analysis.py)
    "launch/hlo_analysis.py:analyze_hlo": "parses XLA HLO text",
    # the reference's group-sharded walk form (REPRO_SHARDED_WALK): the
    # port walks over one ledger and one snapshot, driven per root group
    # where a wave spans groups, and decides the same
    "ShardedLedger": "the port keeps one ledger for every ORC",
    "ShardedHWGraph": "the port slices no snapshot per ORC group",
    "core/compiled.py:GroupShard": "one group's slice of ShardedHWGraph",
    "core/compiled.py:CompiledHWGraph.sharded":
        "builds ShardedHWGraph, which the port does not carry",
    "core/orchestrator.py:ActiveLedger.shard_for":
        "routes a device to its ledger shard; the port has one ledger",
}


def _not_ported(rel: str, name: str) -> bool:
    """Whether ``rel:name`` is exempt; ``name`` may be ``Class.member``,
    which an entry names as ``rel:Class.member``."""
    import fnmatch
    return any(fnmatch.fnmatch(f"{rel}:{name}", pat if ":" in pat
                               else f"*:{pat}") for pat in NOT_PORTED)


def _module_names(path: str, instance_attrs: bool) -> dict:
    """Top-level names a module's source defines: {name: members}, where a
    class's members are its methods and class-level fields, and with
    ``instance_attrs`` also the attributes its methods assign on ``self``
    (None for anything but a class).  A package's ``__init__.py`` also
    defines the names it imports."""
    import ast
    tree = ast.parse(open(path).read())
    out: dict = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = None
        elif isinstance(node, ast.ClassDef):
            members = set()
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    members.add(sub.name)
                elif isinstance(sub, ast.AnnAssign) and isinstance(
                        sub.target, ast.Name):
                    members.add(sub.target.id)
                elif isinstance(sub, ast.Assign):
                    members.update(t.id for t in sub.targets
                                   if isinstance(t, ast.Name))
            if instance_attrs:
                members.update(
                    sub.attr for sub in ast.walk(node)
                    if isinstance(sub, ast.Attribute)
                    and isinstance(sub.ctx, ast.Store)
                    and isinstance(sub.value, ast.Name)
                    and sub.value.id == "self")
            out[node.name] = members
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out[t.id] = None
        elif isinstance(node, ast.ImportFrom) and node.module and \
                path.endswith("__init__.py"):
            # a package's re-exports are its public names (its submodules
            # are the other test's)
            out.update((a.asname or a.name, None) for a in node.names)
    return out


def test_port_modules_carry_the_reference_public_names():
    """For every reference module that has a port module: each public
    top-level name and each public method or field of its classes is in
    the port (as a method, field or attribute set on ``self``),
    or ``NOT_PORTED`` gives its reason (and every entry there is used).
    Private helpers (the reference's ``mesh._auto``, the HLO parser's
    ``_parse_computations`` ...) are each package's own."""
    ref_root = os.path.join(ROOT, "src", "repro")
    port_root = os.path.join(ROOT, "src", "repro_torch")
    missing, ported, used = [], 0, set()
    for d, _, names in os.walk(ref_root):
        for n in names:
            if not n.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(d, n), ref_root)
            port = os.path.join(port_root, rel)
            if not os.path.exists(port):
                continue
            ported += 1
            ref = _module_names(os.path.join(d, n), False)
            got = _module_names(port, True)
            for name, members in ref.items():
                if name.startswith("_"):
                    continue
                if _not_ported(rel, name):
                    used.add(f"{rel}:{name}")
                    continue
                if name not in got:
                    missing.append(f"{rel}:{name}")
                    continue
                for m in sorted(members or ()):
                    if m.startswith("_") or m in (got[name] or ()):
                        continue
                    if _not_ported(rel, f"{name}.{m}"):
                        used.add(f"{rel}:{name}.{m}")
                    else:
                        missing.append(f"{rel}:{name}.{m}")
    assert ported and not missing, missing
    import fnmatch
    stale = [pat for pat in NOT_PORTED if not any(fnmatch.fnmatch(
        u, pat if ":" in pat else f"*:{pat}") for u in used)]
    assert not stale, stale


def test_every_reference_module_but_the_kernel_helpers_has_a_port():
    ref_root = os.path.join(ROOT, "src", "repro")
    port_root = os.path.join(ROOT, "src", "repro_torch")
    unported = sorted(
        os.path.relpath(os.path.join(d, n), ref_root)
        for d, _, names in os.walk(ref_root) for n in names
        if n.endswith(".py") and not os.path.exists(os.path.join(
            port_root, os.path.relpath(os.path.join(d, n), ref_root))))
    # the reference's jit wrappers and oracles: the port's kernel modules
    # carry their own wrappers and plain versions
    assert unported == ["kernels/ops.py", "kernels/ref.py"]


def test_configs_export_the_shapes():
    import repro.configs as R
    import repro_torch.configs as C
    from repro_torch.configs import SHAPES, Shape, cells, input_specs
    assert SHAPES is C.shapes.SHAPES and Shape is C.shapes.Shape
    assert cells is C.shapes.cells and input_specs is C.shapes.input_specs
    assert sorted(SHAPES) == sorted(R.SHAPES)
    assert [c[:3] for c in cells(include_skipped=True)] == \
        [c[:3] for c in R.cells(include_skipped=True)]
