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
