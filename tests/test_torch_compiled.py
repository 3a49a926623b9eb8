"""CompiledHWGraph of the port against the reference's on equal fleets:
snapshot arrays equal exactly, ``transfer_time`` within 1e-9 (the values
are the same doubles; the bound is the suite's), ``route_edges`` equal by
edge name."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401

from torch_port_util import SNAPSHOT_ARRAYS, TOL, make_testbeds

FLEETS = [None, 1, 2]


@pytest.fixture(scope="module", params=FLEETS, ids=lambda m: f"mult={m}")
def comps(request):
    rtb, ttb = make_testbeds(request.param)
    return rtb, ttb, rtb.graph.compiled(), ttb.graph.compiled()


@pytest.mark.parametrize("name", SNAPSHOT_ARRAYS)
def test_snapshot_arrays_equal(comps, name):
    _, _, rc, tc = comps
    want = np.asarray(getattr(rc, name))
    got = getattr(tc, name).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


def test_snapshot_name_tables_equal(comps):
    _, _, rc, tc = comps
    assert tc.pu_names == rc.pu_names
    assert tc.pu_class_kind == rc.pu_class_kind
    assert tc.pu_device == [str(d) for d in rc.pu_device]
    assert tc.dev_ord_names == rc.dev_ord_names
    assert tc.resource_names == rc.resource_names
    assert tc.rclass_names == rc.rclass_names
    assert tc.routable_names == rc.routable_names
    assert tc.compute_paths == rc.compute_paths


def test_snapshot_dtypes_and_device(comps):
    import torch
    _, ttb, _, tc = comps
    assert tc.device == ttb.graph.device == torch.device("cpu")
    assert tc.mem_cap.dtype == torch.float64
    assert tc.max_tenancy.dtype == torch.int64
    assert tc.pu_alive.dtype == torch.bool


def test_transfer_time_and_routes_equal(comps):
    rtb, ttb, rc, tc = comps
    devs = rtb.edges + rtb.servers
    assert devs == ttb.edges + ttb.servers
    rng = np.random.default_rng(0)
    for _ in range(40):
        a, b = rng.choice(len(devs), 2)
        src, dst = devs[a], devs[b]
        nbytes = float(rng.uniform(0, 2e6))
        assert tc.transfer_time(src, dst, nbytes) == pytest.approx(
            rc.transfer_time(src, dst, nbytes), rel=TOL, abs=0)
        assert [e.name for e in tc.route_edges(src, dst)] == \
            [e.name for e in rc.route_edges(src, dst)]
        assert tc.device_name(ttb.graph.pus(under=src)[0].name) == src


def test_lazy_route_rows_and_ensure_routes(comps):
    _, ttb, _, tc = comps
    g = ttb.graph
    fresh = type(tc)(g)
    assert not fresh._rt.built.any()
    built = fresh.ensure_routes(ttb.edges[:2] + ["no_such_device"])
    assert built == 2 and fresh._rt.built.sum() == 2
    assert fresh.ensure_routes(ttb.edges[:2]) == 0
    i = fresh.routable_index[ttb.edges[0]]
    tc.ensure_routes([ttb.edges[0]])
    np.testing.assert_array_equal(fresh._rt.ibw_row(i), tc._rt.ibw_row(i))
    np.testing.assert_array_equal(fresh._rt.lat[i], tc._rt.lat[i])


def test_nearest_common_resource_matches(comps):
    _, _, rc, tc = comps
    names = rc.pu_names[:7]
    for a in names:
        for b in names:
            assert tc.nearest_common_resource(a, b) == \
                rc.nearest_common_resource(a, b)


def test_mutation_invalidates_and_rebuilds():
    """A runtime mutation no longer drops the snapshot: it is absorbed as
    one copy-on-write delta (``delta_count`` +1, no rebuild), the patched
    snapshot equals a fresh build of the mutated graph, and its prices
    are the reference package's."""
    import repro.core as R
    import repro_torch.core as T
    from repro_torch.core.compiled import CompiledHWGraph
    rtb, ttb = make_testbeds(None)
    g = ttb.graph
    c0 = g.compiled()
    src, dst = ttb.edges[0], ttb.servers[0]
    c0.transfer_time(src, dst, 1e6)              # a built row crosses it
    n0, d0 = g.recompile_count, g.delta_count
    link = f"link_{ttb.edges[0]}"
    g.apply_churn(T.Churn(bandwidth=[(link, 1e6)]))
    rtb.graph.apply_churn(R.Churn(bandwidth=[(link, 1e6)]))
    c1 = g.compiled()
    assert c1 is not c0
    assert g.recompile_count == n0 and g.delta_count == d0 + 1
    fresh = CompiledHWGraph(g)
    for name in SNAPSHOT_ARRAYS:
        assert torch.equal(getattr(c1, name), getattr(fresh, name)), name
    devs = ttb.edges + ttb.servers
    for a in devs:
        for b in devs:
            assert c1.transfer_time(a, b, 1e6) == pytest.approx(
                fresh.transfer_time(a, b, 1e6), abs=TOL, rel=TOL)
    assert c1.transfer_time(src, dst, 1e6) == pytest.approx(
        rtb.graph.compiled().transfer_time(src, dst, 1e6), rel=TOL)


def test_summary_equals_reference():
    rtb, ttb = make_testbeds()
    want = rtb.graph.compiled().summary()
    assert ttb.graph.compiled().summary() == want
    assert want.startswith("CompiledHWGraph(") and want.endswith(", v0)")
