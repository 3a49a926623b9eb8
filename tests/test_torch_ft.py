"""The port's fault-tolerance manager (``repro_torch.ft.manager``) against
the reference's (``repro.ft.manager``) on the same fleets, and the port's
training entry point (``repro_torch.launch.train``) end to end on the
CPU."""
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as T
from repro.ft.manager import FTConfig as RFTConfig, FTManager as RFTManager
from repro_torch import tree as tr
from repro_torch.checkpoint import latest_step, restore
from repro_torch.ft.manager import FTConfig, FTManager
from repro_torch.launch import train as train_launch

torch.set_num_threads(1)


def _plan(p) -> tuple:
    return (p.restore_step, p.mesh_shape, p.mesh_axes, p.lost_hosts)


def _pair(n_pods=1, hosts=4, chips=8, **kw):
    """(reference manager, port manager) over the same TPU fleet."""
    rtb = R.build_tpu_fleet(n_pods=n_pods, hosts_per_pod=hosts,
                            chips_per_host=chips)
    ttb = T.build_tpu_fleet(n_pods=n_pods, hosts_per_pod=hosts,
                            chips_per_host=chips, device="cpu")
    return (RFTManager(rtb.graph, RFTConfig(**kw)),
            FTManager(ttb.graph, FTConfig(**kw)))


def test_straggler_detection_patience_matches_reference():
    rft, tft = _pair(hosts=4, chips=2, straggler_patience=2)
    hosts = tft.alive_hosts()
    assert hosts == rft.alive_hosts()
    slow = {h: 1.0 for h in hosts}
    slow[hosts[0]] = 3.0
    ok = {h: 1.0 for h in hosts}
    for times in (slow, slow, ok, slow, slow, slow):
        got = tft.report_step_times(times)
        assert got == rft.report_step_times(times)
    # strike 1, strike 2 -> confirmed; recovery resets the strikes
    assert tft.report_step_times(ok) == []
    assert tft.report_step_times(slow) == []
    assert tft.report_step_times(slow) == [hosts[0]]
    assert tft.report_step_times({"only": 9.0}) == []


@pytest.mark.parametrize("n_pods, hosts, chips", [(1, 4, 8), (2, 3, 4)])
def test_failure_and_join_plans_match_reference(n_pods, hosts, chips):
    rft, tft = _pair(n_pods, hosts, chips)
    assert tft.alive_chips() == rft.alive_chips() == n_pods * hosts * chips
    lost = tft.alive_hosts()[:2]
    tplan, rplan = tft.on_failure(lost), rft.on_failure(lost)
    assert _plan(tplan) == _plan(rplan)
    assert tft.alive_chips() == rft.alive_chips()
    assert set(tplan.lost_hosts) == set(lost)
    for host in lost:
        tplan, rplan = tft.on_join(host), rft.on_join(host)
        assert _plan(tplan) == _plan(rplan)
    assert tft.alive_chips() == n_pods * hosts * chips
    for mp in (1, 4, 16):
        assert _plan(tft.plan_mesh(mp)) == _plan(rft.plan_mesh(mp))


def _fleet_scheduler(pkg, tb, est_s):
    model = pkg.CallableModel(fn=lambda t, pu, unit: est_s * t.size)
    for chip in tb.graph.pus():
        chip.model = model
        chip.max_tenancy = 2
    return pkg.build_orchestrators(tb.graph, pkg.heye_traverser(tb.graph))


def test_remap_after_failure_matches_reference():
    """Orphaned streams re-placed in one batch through map_batch(route=True):
    the same chips as the reference's, none on the dead host."""
    rtb = R.build_tpu_fleet(n_pods=1, hosts_per_pod=3, chips_per_host=2)
    ttb = T.build_tpu_fleet(n_pods=1, hosts_per_pod=3, chips_per_host=2,
                            device="cpu")
    picks = []
    for pkg, tb, Mgr in ((R, rtb, RFTManager), (T, ttb, FTManager)):
        root = _fleet_scheduler(pkg, tb, est_s=0.02)
        ft = Mgr(tb.graph)
        dead = ft.alive_hosts()[0]
        ft.on_failure([dead])
        origin = next(o.group for o in root.iter_tree()
                      if o.is_device_orc() and o.group != dead)
        tasks = []
        for i in range(5):
            t = pkg.Task(kind="serve_stream", deadline=0.05, size=1.0 + i,
                         usage={"pu": 1.0, "mem": 0.4})
            t.origin = origin
            tasks.append(t)
        res = ft.remap(root, tasks)
        picks.append([r.pu if r is not None else None for r in res])
        assert not any(p is not None and p.startswith(dead + ".")
                       for p in picks[-1])
    assert picks[1] == picks[0]
    assert any(p is not None for p in picks[1])


def test_checkpoint_cadence(tmp_path):
    tb = T.build_tpu_fleet(n_pods=1, hosts_per_pod=2, chips_per_host=2,
                           device="cpu")
    ft = FTManager(tb.graph, FTConfig(checkpoint_every=10),
                   ckpt_dir=str(tmp_path))
    state = {"w": torch.ones((4,))}
    assert not ft.maybe_checkpoint(state, step=5)
    assert ft.maybe_checkpoint(state, step=10)
    ft.saver.wait()
    assert latest_step(str(tmp_path)) == 10
    assert ft.last_committed == 10
    assert ft.plan_mesh().restore_step == 10


def test_recovery_plan_no_chips_raises():
    tb = T.build_tpu_fleet(n_pods=1, hosts_per_pod=1, chips_per_host=2,
                           device="cpu")
    ft = FTManager(tb.graph)
    with pytest.raises(RuntimeError, match="no healthy chips"):
        ft.on_failure(ft.alive_hosts())


# ---------------------------------------------------------------------------
# launch.train on the CPU
# ---------------------------------------------------------------------------
def _args(tmp_path, *extra):
    return train_launch.parse_args(
        ["--smoke", "--device", "cpu", "--arch", "gemma3-1b", "--batch", "8",
         "--seq", "32", "--log-every", "4", "--ckpt-dir", str(tmp_path),
         *extra])


def test_train_launch_loss_falls(tmp_path, capsys):
    assert train_launch.main(["--smoke", "--device", "cpu", "--steps", "12",
                              "--batch", "8", "--seq", "32", "--log-every",
                              "4", "--ckpt-every", "6", "--ckpt-dir",
                              str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("[train] step") == 3
    assert "last checkpoint: 12" in out
    rep = train_launch.run(_args(tmp_path / "b", "--steps", "12",
                                 "--ckpt-every", "100"))
    assert rep.steps == list(range(1, 13))
    assert all(np.isfinite(rep.losses)) and all(np.isfinite(rep.grad_norms))
    assert np.mean(rep.losses[-4:]) < np.mean(rep.losses[:4]) - 0.05, \
        rep.losses
    assert len(rep.step_ms) == 12
    assert latest_step(str(tmp_path / "b")) is None


def test_train_launch_resume_restores_state(tmp_path, monkeypatch):
    """Stop at step 6 (checkpoint), resume to 12: the resumed run starts
    from the checkpointed state bit for bit, with the data seeded by the
    start step (as the reference's launch/train.py)."""
    first = train_launch.run(_args(tmp_path, "--steps", "6",
                                   "--ckpt-every", "6"))
    assert latest_step(str(tmp_path)) == 6
    saved = restore(str(tmp_path), first.state)
    for a, b in zip(tr.leaves(saved), tr.leaves(first.state)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(saved["opt"]["step"]) == 6

    seen = {}
    orig = train_launch.restore

    def spy(directory, like, step=None):
        out = orig(directory, like, step)
        seen["state"] = tr.tree_map(torch.clone, out)   # trained in place
        return out

    monkeypatch.setattr(train_launch, "restore", spy)
    resumed = train_launch.run(_args(tmp_path, "--steps", "12",
                                     "--ckpt-every", "6", "--resume"))
    assert resumed.start_step == 6 and resumed.steps == list(range(7, 13))
    for a, b in zip(tr.leaves(seen["state"]), tr.leaves(saved)):
        assert torch.equal(a, b)
    assert int(resumed.state["opt"]["step"]) == 12
    assert latest_step(str(tmp_path)) == 12
