"""The model path's two kernels, B5 (flash attention) and B6 (LRU scan):
their plain PyTorch versions -- what the wrappers run for CPU tensors --
held against the reference's Pallas kernels (interpret mode, through
``repro.kernels.ops``) and its oracles (``repro.kernels.ref``), on the same
seeded numpy inputs.  The CUDA kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances: float32 attention 1e-5 absolute and relative (both sides sum in
float32 in another order); bfloat16 attention 1e-2 (one bf16 rounding of
the output, 2^-8 relative, on either side).  The bfloat16 CUDA kernel
rounds P to bf16 before P.V; a tile-wise emulation of its rounding points
holds the rule it is held to on the card (``fa.bf16_allowed``) against
the plain version: the emulation must land well inside it, and a mask off
by one key far outside it.  The LRU scan 1e-6 relative
with a 1e-6 absolute floor: the plain version rounds the product and the
sum of every step, XLA on the CPU contracts ``a*h + b`` into one fused
multiply-add, so the two differ by an ulp of the terms (observed <= 3.3e-7
absolute), which is large relative only where h cancels towards 0."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lru_scan as ls
from repro_torch.models.recurrent import associative_scan

torch.set_num_threads(1)

F32_TOL = 1e-5
BF16_TOL = 1e-2
LRU_TOL = 1e-6


def _qkv(seed, B, S, Hq, Hkv, hd, scale=1.0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, hd)).astype(np.float32) * scale
    k = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32) * scale
    v = rng.standard_normal((B, S, Hkv, hd)).astype(np.float32)
    return q, k, v


def _port(q, k, v, dtype=torch.float32, **kw):
    args = [torch.tensor(a).to(dtype) for a in (q, k, v)]
    return fa.flash_attention(*args, **kw).float().numpy()


def _ref(q, k, v, dtype=jnp.float32, **kw):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    return np.asarray(ref.attention_ref(*args, **kw).astype(jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# B5: flash attention
# ---------------------------------------------------------------------------
CASES = {
    # name: (B, S, Hq, Hkv, hd, kwargs, block)
    "mha": (1, 128, 2, 2, 64, {}, 128),
    "gqa": (2, 256, 4, 2, 64, {}, 128),
    "mqa": (1, 256, 8, 1, 128, {}, 128),
    "hd256": (1, 256, 4, 4, 256, {}, 128),
    "mqa16_hd256_window": (1, 128, 16, 1, 256, {"window": 48}, 64),
    "window16": (1, 256, 4, 2, 64, {"window": 16}, 128),
    "window64": (1, 256, 4, 2, 64, {"window": 64}, 128),
    "window_past_S": (1, 256, 4, 2, 64, {"window": 512}, 128),
    "softcap20": (1, 256, 4, 4, 64, {"softcap": 20.0}, 128),
    "softcap50_window": (1, 256, 4, 2, 64,
                         {"softcap": 50.0, "window": 32}, 128),
    "hd96": (1, 128, 2, 2, 96, {}, 128),
    "gqa_hd96": (2, 256, 4, 2, 96, {}, 128),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_plain_matches_pallas_and_oracle_f32(case):
    B, S, Hq, Hkv, hd, kw, blk = CASES[case]
    q, k, v = _qkv(1, B, S, Hq, Hkv, hd)
    got = _port(q, k, v, causal=True, **kw)
    _close(got, _ref(q, k, v, causal=True, **kw), F32_TOL)
    pallas = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, block_q=blk,
                                 block_k=blk, **kw)
    _close(got, np.asarray(pallas), F32_TOL)


@pytest.mark.parametrize("case", ["gqa", "mqa", "hd256", "window16",
                                  "softcap50_window", "gqa_hd96"])
def test_flash_plain_matches_oracle_bf16(case):
    B, S, Hq, Hkv, hd, kw, _ = CASES[case]
    q, k, v = _qkv(2, B, S, Hq, Hkv, hd)
    got = _port(q, k, v, dtype=torch.bfloat16, causal=True, **kw)
    _close(got, _ref(q, k, v, dtype=jnp.bfloat16, causal=True, **kw),
           BF16_TOL)


def test_flash_plain_extreme_logits():
    """x100 logits: the softmax must not overflow or turn NaN."""
    q, k, v = _qkv(3, 1, 128, 2, 2, 64, scale=100.0)
    got = _port(q, k, v, causal=True)
    assert np.isfinite(got).all()
    _close(got, _ref(q, k, v, causal=True), F32_TOL)
    pallas = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=True, block_q=64,
                                 block_k=64)
    _close(got, np.asarray(pallas), F32_TOL)


def test_flash_plain_non_causal():
    q, k, v = _qkv(4, 1, 64, 2, 1, 32)
    _close(_port(q, k, v, causal=False), _ref(q, k, v, causal=False),
           F32_TOL)


@pytest.mark.parametrize("hd", [64, 96])
def test_flash_plain_unmasked_matches_pallas(hd):
    """The encoder's form (causal=False, no window, MHA) at an S that no
    128-row tile divides (the reference kernel takes it as one block), at
    whisper's hd 64 and phi-3's hd 96."""
    q, k, v = _qkv(9 + hd, 2, 150, 4, 4, hd)
    got = _port(q, k, v, causal=False)
    _close(got, _ref(q, k, v, causal=False), F32_TOL)
    pallas = ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False)
    _close(got, np.asarray(pallas), F32_TOL)


def test_flash_takes_any_sequence_length():
    """The reference kernel refuses an S its block does not divide; the
    port takes any S (the CUDA kernel masks the ragged last tile) and
    agrees with the oracle there."""
    from repro.kernels.flash_attention import flash_attention_bhsd
    z = jnp.zeros((2, 100, 64))
    with pytest.raises(ValueError):
        flash_attention_bhsd(z, z, z, num_kv_heads=2, block_q=64, block_k=64,
                             interpret=True)
    q, k, v = _qkv(5, 2, 100, 4, 2, 64)
    for kw in ({}, {"window": 30}):
        _close(_port(q, k, v, causal=True, **kw),
               _ref(q, k, v, causal=True, **kw), F32_TOL)


def test_flash_causality():
    """Perturbing future tokens must not change past outputs."""
    q, k, v = _qkv(6, 1, 128, 2, 2, 64)
    out1 = _port(q, k, v)
    k2, v2 = k.copy(), v.copy()
    k2[:, 64:] += 100.0
    v2[:, 64:] -= 50.0
    np.testing.assert_array_equal(out1[:, :64], _port(q, k2, v2)[:, :64])


def test_flash_wrapper_on_cpu_is_the_plain_version():
    q, k, v = (torch.tensor(a) for a in _qkv(7, 1, 32, 4, 1, 16))
    before, by_shape = fa.launches, dict(fa.launches_by_shape)
    got = fa.flash_attention(q, k, v, window=8, softcap=30.0)
    want = fa.flash_attention_plain(q, k, v, window=8, softcap=30.0)
    assert torch.equal(got, want) and got.dtype == q.dtype
    assert fa.launches == before         # no kernel launch on the CPU
    assert dict(fa.launches_by_shape) == by_shape


def test_flash_wrapper_on_cpu_is_the_plain_version_bf16():
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(7, 1, 48, 4, 2, 32))
    before, by_shape = fa.launches, dict(fa.launches_by_shape)
    got = fa.flash_attention(q, k, v, window=8)
    want = fa.flash_attention_plain(q, k, v, window=8)
    assert torch.equal(got, want) and got.dtype == torch.bfloat16
    assert fa.launches == before
    assert dict(fa.launches_by_shape) == by_shape


def test_flash_wrapper_refuses_bf16_inputs_the_kernel_does_not_take():
    q, k, v = (torch.tensor(a).bfloat16() for a in _qkv(8, 1, 32, 4, 2, 16))
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.float(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k.transpose(1, 2), v)          # not contiguous
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :16].contiguous(), v[:, :16].contiguous())
    with pytest.raises(ValueError):                          # no fallback
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# B5, bfloat16: the tensor-core kernel's rounding, emulated tile by tile
# ---------------------------------------------------------------------------
def _emulate_tc(q, k, v, *, causal=True, window=None, softcap=None,
                mask_window=None):
    """The bf16 kernel's arithmetic in plain PyTorch, over the tiles it runs
    at this head dim (``fa.BF16_TILES``: query tiles of its block's rows,
    kv tiles of its keys, over the kernel's loop bounds): scores in float32
    from bf16 inputs; without a soft cap kept raw, masked with the power of
    two nearest -2^30 / scale, each weight exp2(fma(s, c, -m*c)) with c =
    scale*log2(e) and m the running raw max (from -inf); with one scaled,
    soft-capped, masked with the finite NEG_INF, c = log2(e); the
    correction exp2(m_old*c - m*c); P rounded to bf16 (the row sums add
    the rounded values), float32 accumulation, the output rounded to bf16.
    ``mask_window`` replaces the window in the mask alone (the loop bounds
    keep ``window``): a model of a mask error."""
    B, S, Hq, hd = q.shape
    block_q, block_k, _ = fa.BF16_TILES[hd]
    rep = Hq // k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.float().repeat_interleave(rep, dim=2).transpose(1, 2)
    mw = window if mask_window is None else mask_window
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    if softcap is None:
        c = scale * log2e
        masked = -2.0 ** (30 + int(torch.round(-torch.log2(scale))))
    else:
        c, masked = log2e, fa.NEG_INF
    out = torch.empty(B, Hq, S, hd)
    for q0 in range(0, S, block_q):
        rows = torch.arange(q0, min(q0 + block_q, S))
        k_begin, k_end = 0, S
        if causal:
            k_end = min(S, q0 + block_q)
        if window is not None:
            k_begin = max(0, q0 - window + 1)
        m = torch.full((B, Hq, len(rows)), -float("inf"))
        mc = torch.full((B, Hq, len(rows)), -float("inf"))
        l = torch.zeros((B, Hq, len(rows)))
        acc = torch.zeros((B, Hq, len(rows), hd))
        for t in range(k_begin // block_k, -(-k_end // block_k)):
            keys = torch.arange(t * block_k, min(t * block_k + block_k, S))
            s = qf[:, :, rows] @ kf[:, :, keys].transpose(-1, -2)
            if softcap is not None:
                s = softcap * torch.tanh(s * scale / softcap)
            live = torch.ones((len(rows), len(keys)), dtype=torch.bool)
            if causal:
                live &= keys[None, :] <= rows[:, None]
            if mw is not None:
                live &= keys[None, :] > rows[:, None] - mw
            s = torch.where(live, s, torch.full_like(s, masked))
            m = torch.maximum(m, s.amax(-1))
            mc_new = m * c
            corr = torch.exp2(mc - mc_new)
            arg = (s.double() * c.double() - mc_new.double()[..., None]).float()
            p = torch.exp2(arg).bfloat16().float()
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + p @ vf[:, :, keys]
            mc = mc_new
        out[:, :, rows] = acc / l[..., None]
    return out.transpose(1, 2).bfloat16()


def _ratio(got, plain):
    """Worst |got - plain| over what the bf16 kernel is allowed."""
    d = (got.double() - plain.double()).abs()
    return float((d / fa.bf16_allowed(plain)).max())


_BQ, _BK, _ = fa.BF16_TILES[64]
TC_CASES = {
    # name: (B, S, Hq, Hkv, hd, kwargs, logit scale); S below one query
    # tile, windows below one kv tile, GQA / MQA, non-causal, soft caps,
    # x100 logits, S that no tile divides, the path's shape cut in S; the
    # edges of hd 64's tiles: S one below, one above and one above twice a
    # kv tile, windows one key either side of one, GQA 2:1 and hd 96
    # unmasked at S that no tile divides
    "S40_window16_hd16": (2, 40, 4, 1, 16, {"window": 16}, 1.0),
    "gqa_ragged_hd64": (1, 333, 4, 2, 64, {}, 1.0),
    "noncausal_hd32": (1, 200, 4, 2, 32, {"causal": False}, 1.0),
    "softcap30_window_hd128": (1, 300, 4, 2, 128,
                               {"softcap": 30.0, "window": 100}, 1.0),
    "softcap50_hd64": (1, 256, 4, 2, 64, {"softcap": 50.0}, 1.0),
    "x100_hd64": (1, 256, 2, 2, 64, {}, 100.0),
    "path_mqa_hd256_window": (1, 384, 4, 1, 256, {"window": 128}, 1.0),
    "encoder_noncausal_hd64": (2, 300, 4, 4, 64, {"causal": False}, 1.0),
    "phi3_causal_hd96": (1, 333, 4, 4, 96, {}, 1.0),
    "S_bk_minus_1_hd64": (1, _BK - 1, 4, 2, 64, {}, 1.0),
    "S_bk_plus_1_hd64": (1, _BK + 1, 4, 2, 64, {}, 1.0),
    "S_2bk_plus_1_hd64": (1, 2 * _BK + 1, 4, 4, 64, {}, 1.0),
    "window_bk_minus_1_hd64": (1, 4 * _BK + 3, 4, 2, 64,
                               {"window": _BK - 1}, 1.0),
    "window_bk_plus_1_hd64": (1, 4 * _BK + 3, 4, 2, 64,
                              {"window": _BK + 1}, 1.0),
    "gqa21_ragged_hd64": (2, 3 * _BQ + 5, 8, 4, 64, {}, 1.0),
    "unmasked_ragged_hd96": (1, 2 * fa.BF16_TILES[96][1] + 37, 4, 4, 96,
                             {"causal": False}, 1.0),
}


def _tc_inputs(case):
    B, S, Hq, Hkv, hd, kw, scale = TC_CASES[case]
    q, k, v = _qkv(30 + S, B, S, Hq, Hkv, hd, scale)
    return [torch.tensor(a).bfloat16() for a in (q, k, v)], kw


@pytest.mark.parametrize("case", sorted(TC_CASES))
def test_bf16_tolerance_holds_the_kernel_rounding(case):
    """The emulation lands well inside the rule.  Its worst ratio, 0.54-0.63
    here, is set by the output's own rounding: where the two sides round
    an output of 3x its row's RMS one bf16 step apart, that step alone is
    0.6 of the rule.  0.7 leaves that margin and no more."""
    (q, k, v), kw = _tc_inputs(case)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    assert _ratio(_emulate_tc(q, k, v, **kw), plain) <= 0.7


@pytest.mark.parametrize("shift", [-1, 1])
@pytest.mark.parametrize("case", sorted(c for c in TC_CASES
                                        if "window" in TC_CASES[c][5]))
def test_bf16_tolerance_catches_a_window_off_by_one(case, shift):
    (q, k, v), kw = _tc_inputs(case)
    plain = fa.flash_attention_plain(q, k, v, **kw)
    wrong = _emulate_tc(q, k, v, mask_window=kw["window"] + shift, **kw)
    assert _ratio(wrong, plain) >= 10.0


def test_bf16_tiles_cover_every_head_dim():
    """One entry of the per-hd tile table for every head dim the kernel is
    built for: query rows a whole number of 64-row warpgroups, keys a whole
    number of 16-key wgmma slices, a ring of at least two stages."""
    assert sorted(fa.BF16_TILES) == sorted(fa.KERNEL_HEAD_DIMS)
    for hd, (bq, bk, stages) in fa.BF16_TILES.items():
        assert bq % 64 == 0 and bk % 16 == 0 and stages >= 2, hd


def test_bf16_tiles_match_the_kernel_source():
    """The wrapper's table is the kernel's (``fatc::Tiles``: BK, STAGES and
    NWG warpgroups of 64 rows); on the card ``chip_smoke.py`` holds it
    against what the built library reports."""
    import re
    from pathlib import Path
    src = (Path(fa.__file__).parent / "csrc" / "flash_attention_tc.cuh"
           ).read_text()
    found = {int(hd): (64 * int(nwg), int(bk), int(st)) for hd, bk, st, nwg in
             re.findall(r"struct Tiles<(\d+)> \{ static constexpr int "
                        r"BK = (\d+), STAGES = (\d+), NWG = (\d+); \};",
                        src)}
    assert found == fa.BF16_TILES


@pytest.mark.parametrize("hd", fa.KERNEL_HEAD_DIMS)
def test_bf16_grid_refusal_follows_the_tile(hd):
    """The grid's second dimension is ceil(S / query rows) at this hd's
    tile: the last S it takes passes, one more raises."""
    bq = fa.BF16_TILES[hd][0]
    fa.check_bf16_grid(2, 65535 * bq, 8, hd)
    with pytest.raises(ValueError):
        fa.check_bf16_grid(2, 65535 * bq + 1, 8, hd)


def test_flash_wrapper_refuses_what_the_kernel_does_not_take():
    q, k, v = (torch.tensor(a) for a in _qkv(8, 1, 32, 4, 2, 16))
    with pytest.raises(ValueError):
        fa.flash_attention(q.transpose(1, 2), k, v)          # not contiguous
    with pytest.raises(TypeError):
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError):
        fa.flash_attention(q, k[:, :, :1].contiguous(), v)   # k/v differ
    with pytest.raises(ValueError):
        fa.flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError):                          # no fallback
        fa.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


# ---------------------------------------------------------------------------
# B6: LRU scan
# ---------------------------------------------------------------------------
def _ab(seed, B, S, W, lo=0.7, hi=0.999):
    rng = np.random.default_rng(seed)
    a = rng.uniform(lo, hi, (B, S, W)).astype(np.float32)
    b = rng.standard_normal((B, S, W)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,W,bs,bw", [
    (1, 64, 128, 32, 128),
    (2, 256, 256, 128, 128),
    (1, 128, 100, 64, 64),     # W padded to a block multiple by ops
    (3, 96, 64, 256, 512),     # blocks clamp to dims
])
def test_lru_plain_matches_pallas_and_oracle(B, S, W, bs, bw):
    a, b = _ab(10 + S, B, S, W)
    got = ls.lru_scan(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(ref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(ops.lru_scan(jnp.asarray(a), jnp.asarray(b),
                                     block_s=bs, block_w=bw))
    np.testing.assert_allclose(got, want, rtol=LRU_TOL, atol=LRU_TOL)
    np.testing.assert_allclose(got, pallas, rtol=LRU_TOL, atol=LRU_TOL)


def test_lru_plain_edge_decays():
    """a in [0, 1] including a = 0 (reset) and a = 1 (pure sum) columns."""
    a, b = _ab(20, 2, 77, 33, lo=0.0, hi=1.0)
    a[..., 0] = 0.0
    a[..., 1] = 1.0
    got = ls.lru_scan(torch.tensor(a), torch.tensor(b)).numpy()
    want = np.asarray(ref.lru_scan_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=LRU_TOL, atol=LRU_TOL)
    np.testing.assert_array_equal(got[..., 0], b[..., 0])


def test_lru_associative_scan_matches_plain():
    """The models' use_kernels=False route (log-depth scan) against the
    sequential plain version (sums in another order: 1e-5)."""
    a, b = (torch.tensor(x) for x in _ab(21, 2, 53, 17))
    np.testing.assert_allclose(associative_scan(a, b).numpy(),
                               ls.lru_scan_plain(a, b).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_lru_wrapper_on_cpu_and_refusals():
    a, b = (torch.tensor(x) for x in _ab(22, 1, 16, 8))
    before = ls.launches
    assert torch.equal(ls.lru_scan(a, b), ls.lru_scan_plain(a, b))
    assert ls.launches == before
    with pytest.raises(TypeError):
        ls.lru_scan(a.double(), b.double())
    with pytest.raises(ValueError):
        ls.lru_scan(a, b[:, :8].contiguous())
    with pytest.raises(ValueError):
        ls.lru_scan(a.transpose(1, 2), b.transpose(1, 2))
    with pytest.raises(ValueError):
        ls.lru_scan(a.to("meta"), b.to("meta"))
