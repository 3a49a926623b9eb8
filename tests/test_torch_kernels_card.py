"""The walk's fused re-walk kernel on the card (``csrc/rewalk.cu``, through
``walk_kernel.rewalk_entry``), held to the bit against its plain version
on the same card, which is the two-step path it replaces: B1's
same-device kernel, the constraint terms in PyTorch, the splice, the
effective layer and B4's kernel.  The nine values it returns and every
column it rewrites are compared as bit patterns, on seeded single-device
segments of every shape in ``rewalk_cases.CASES``.  The ordered commit's
appends (``csrc/ledger_append.cu``, through ``walk_kernel.ledger_append``
and ``walk_kernel.view_append``) are held to the bit against their plain
versions on the same card, every entry of the buffers compared, the
untouched ones too, at the buffers' first and last slots and across a
move into new buffers.

A CUDA kernel has no CPU form, so these tests skip without a card.  This
file imports no JAX; on the card run it alone, without the suite's
``conftest.py`` (which imports JAX):

    python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.device import host_list
from repro_torch.kernels import walk_kernel as wk
from rewalk_cases import CASES, MUTABLE, bits, copy_of, segment


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the fused re-walk kernel is CUDA "
                    "C++ with no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("case", CASES)
def test_rewalk_entry_is_its_plain_version_to_the_bit(card, case):
    for seed in range(4):
        seg, tables = segment(card, case, seed)
        ref = copy_of(seg)
        before = wk.launches["rewalk_entry"]
        got = wk.rewalk_entry(seg, *tables)
        assert wk.launches["rewalk_entry"] == before + 1
        want = host_list(wk.rewalk_entry_plain(ref, *tables))
        torch.cuda.synchronize()
        assert (bits(got) == bits(want)).all(), (case, seed, got, want)
        for name in MUTABLE:
            a, b = getattr(seg, name), getattr(ref, name)
            if a.dtype == torch.bool:
                assert torch.equal(a, b), (case, seed, name)
            else:
                assert (bits(a) == bits(b)).all(), (case, seed, name)
        if case == "infeasible":
            assert got[0] == -1.0
        if case == "empty_device":
            assert got[7:] == [0.0, float("inf")]


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (float64 compared as its bit patterns)."""
    if a.dtype == torch.float64:
        a, b = a.view(torch.int64), b.view(torch.int64)
    return torch.equal(a, b)


def _filled(dev, dtype, n: int, rng) -> torch.Tensor:
    if dtype == torch.bool:
        return torch.as_tensor(rng.random(n) < 0.5, device=dev)
    if dtype == torch.int64:
        return torch.as_tensor(rng.integers(-5, 1 << 40, n), device=dev)
    x = rng.uniform(-1.0, 3.0, n)
    x[rng.random(n) < 0.1] = np.inf
    return torch.as_tensor(x, device=dev)


@pytest.mark.card
@pytest.mark.parametrize("i", [0, 17, 63])
def test_ledger_append_is_its_plain_version_to_the_bit(card, i):
    rng = np.random.default_rng(i)
    cols = [_filled(card, t, 64, rng) for _, t in wk.LEDGER_COLS]
    ref = [c.clone() for c in cols]
    row = (0.1 + 1 / 3, 1.75, float("inf"), 0.3, 1e-300, (1 << 50) + 3, -1)
    before = wk.launches["ledger_append"]
    wk.ledger_append(wk.Columns(wk.LEDGER_COLS, cols), i, row)
    assert wk.launches["ledger_append"] == before + 1
    wk.ledger_append_plain(ref, i, row)
    torch.cuda.synchronize()
    for (name, _), a, b in zip(wk.LEDGER_COLS, cols, ref):
        assert _same(a, b), name


# (slot n, rows copied, buffer rows, device ordinal, ordinals): a slot in
# the middle, the first and the last slot, a move into new buffers, no
# ordinal, and a copy over many blocks
VIEW_CASES = {"middle": (9, 0, 16, 3, 8), "first": (0, 0, 16, 0, 8),
              "last": (15, 0, 16, 7, 8), "move": (16, 16, 34, 2, 8),
              "no_ordinal": (5, 0, 16, -1, 8),
              "many_blocks": (4700, 4700, 9402, 299, 300)}


@pytest.mark.card
@pytest.mark.parametrize("case", sorted(VIEW_CASES))
def test_view_append_is_its_plain_version_to_the_bit(card, case):
    n, ncopy, cap, o, nd = VIEW_CASES[case]
    rng = np.random.default_rng(len(case))
    L = 128
    types = [t for _, t in wk.VIEW_COLS]
    dst = [_filled(card, t, cap, rng) for t in types]
    src = [_filled(card, t, max(ncopy, 1), rng) for t in types]
    led = [_filled(card, t, L, rng) for _, t in wk.LEDGER_COLS]
    led[4][L - 1] = 0.0                     # umem at i: Ma takes it
    mem_cap = torch.as_tensor(rng.uniform(0.3, 1.0, 40), device=card)
    na_src = torch.as_tensor(rng.integers(0, 50, nd), device=card)
    for i, pidx in ((L - 1, 39), (3, 0), (64, 17)):
        got, want = [c.clone() for c in dst], [c.clone() for c in dst]
        na_got = torch.full_like(na_src, -7)
        na_want = na_got.clone()
        args = (i, mem_cap, pidx, n, 0.25 + 1e-17 * i, max(o, 0), na_src)
        before = wk.launches["view_append"]
        wk.view_append(wk.Columns(wk.VIEW_COLS, got), src if ncopy else None,
                       ncopy, wk.Columns(wk.LEDGER_COLS, led), *args,
                       na_got, o)
        assert wk.launches["view_append"] == before + 1
        wk.view_append_plain(want, src if ncopy else None, ncopy, led, *args,
                             na_want, o)
        torch.cuda.synchronize()
        for (name, _), a, b in zip(wk.VIEW_COLS, got, want):
            assert _same(a, b), (case, i, name)
        assert torch.equal(na_got, na_want), (case, i)
