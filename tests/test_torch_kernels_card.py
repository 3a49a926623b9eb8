"""The walk's fused re-walk kernel on the card (``csrc/rewalk.cu``, through
``walk_kernel.rewalk_entry``), held to the bit against its plain version
on the same card, which is the two-step path it replaces: B1's
same-device kernel, the constraint terms in PyTorch, the splice, the
effective layer and B4's kernel.  The nine values it returns and every
column it rewrites are compared as bit patterns, on seeded single-device
segments of every shape in ``rewalk_cases.CASES``.

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
