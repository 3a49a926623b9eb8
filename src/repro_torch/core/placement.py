"""Placement search: H-EYE's predict -> check-constraints -> assign loop
applied to sharding-layout choice, as in the reference package's
``core/placement.py`` (copied as it stands).

The paper's Orchestrator maps a Task onto a PU by querying a pluggable
``predict()`` and rejecting candidates that break constraints.  Here the
"task" is one training/serving step of an assigned architecture, the
"PUs" are candidate *layouts* (sharding policy x microbatching x remat x
optimizer dtype x cache sharding) on a fixed mesh, the constraint is HBM
capacity, and the objective is the predicted roofline step time.  The
prediction is the same three-term roofline the paper lists among its
supported model classes (core/predict.RooflineModel); the dry run
(``launch/dryrun.py``) then builds the chosen plan's step on fake ranks
and counts what it does.

The chip model is the reference's: the attributes of the simulated TPU
v5e chips of ``core.topology.TPU_V5E`` (16 GB of HBM, 90 % of it the
budget), so that the plans equal the reference's.  They describe the
modelled fleet, not the device this port runs on.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Optional

from .hwgraph import ProcessingUnit
from .predict import RooflineModel
from .task import Task
from .topology import TPU_V5E

HBM_BYTES = TPU_V5E["hbm_bytes"]
HBM_BUDGET = 0.90 * HBM_BYTES          # leave headroom for XLA scratch


@dataclass(frozen=True)
class Plan:
    """One candidate layout for a (arch x shape x mesh) cell."""

    policy: str = "tp_fsdp"            # param sharding (launch/sharding.py)
    microbatches: int = 1
    remat: str = "block"               # "none" | "block"
    state_dtype: str = "float32"       # optimizer m/v dtype
    param_dtype: str = "float32"       # master param dtype (bf16 = pure-bf16)
    accum_dtype: str = "float32"       # microbatch grad-accumulation dtype
    cache_mode: str = "batch"          # "batch" | "seq" | "heads"
    cache_dtype: str = "bfloat16"      # KV cache dtype (float8_e4m3fn = kv8)
    moe_group: int = 1024              # GShard dispatch group size
    notes: str = ""

    def describe(self) -> str:
        return (f"{self.policy}/mb{self.microbatches}/remat-{self.remat}"
                f"/opt-{self.state_dtype}/cache-{self.cache_mode}")


@dataclass
class PlanCost:
    """Analytic prediction for a Plan (all per-chip, seconds / bytes)."""

    mem_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    flops_chip: float
    coll_bytes_chip: float

    @property
    def t_step(self) -> float:
        # collectives overlap with compute at best; worst case serialize.
        # Use max(compute, memory) + 0.5*collective as the planner's blend.
        return max(self.t_compute, self.t_memory) + 0.5 * self.t_collective

    @property
    def fits(self) -> bool:
        return self.mem_bytes <= HBM_BUDGET


# ---------------------------------------------------------------------------
# analytic cost model
# ---------------------------------------------------------------------------
def _param_shards(policy: str, dp: int, tp: int, pods: int) -> float:
    if policy in ("tp_fsdp", "tp_fsdp_moeff"):
        return dp * tp
    if policy == "fsdp_pod":
        return dp * tp * pods
    if policy == "tp_only":
        return tp
    if policy == "fsdp_only":
        return dp
    raise ValueError(policy)


def model_flops(cfg, tokens: float, mode: str) -> float:
    """MODEL_FLOPS per the assignment: 6*N*D train (2*N*D inference),
    N = active non-embedding params, + the unembed matmul."""
    n_act = cfg.active_param_count() - cfg.vocab * cfg.d_model * (
        1 if cfg.tie_embeddings else 2)
    fwd = 2.0 * n_act * tokens + 2.0 * tokens * cfg.d_model * cfg.vocab
    return 3.0 * fwd if mode == "train" else fwd


def cache_bytes_total(cfg, B: int, S: int, dtype_bytes: int = 2) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.kind_of_layer(i)
        if kind == "global":
            total += 2 * B * S * cfg.n_kv * cfg.hd * dtype_bytes
        elif kind in ("local", "enc"):
            C = min(cfg.window, S)
            total += 2 * B * C * cfg.n_kv * cfg.hd * dtype_bytes
        elif kind == "rglru":
            w = cfg.lru_width or cfg.d_model
            total += B * w * 4 + B * (cfg.conv1d_size - 1) * w * dtype_bytes
        elif kind == "rwkv":
            total += B * cfg.n_heads * cfg.hd * cfg.hd * 4
        if cfg.is_encdec and cfg.cross_attn and kind != "enc":
            total += 2 * B * cfg.src_seq * cfg.n_kv * cfg.hd * dtype_bytes
    return total


def predict_plan(cfg, shape, mesh_shape: tuple[int, ...],
                 mesh_axes: tuple[str, ...], plan: Plan) -> PlanCost:
    sizes = dict(zip(mesh_axes, mesh_shape))
    tp = sizes.get("model", 1)
    dp = sizes.get("data", 1)
    pods = sizes.get("pod", 1)
    n_chips = tp * dp * pods
    dp_total = dp * pods                       # batch shards over non-model axes

    B, S = shape.global_batch, shape.seq_len
    mode = shape.mode
    tokens = B * S if mode in ("train", "prefill") else B
    dtype_b = 2                                # bf16 compute
    N = cfg.param_count()
    pshards = _param_shards(plan.policy, dp, tp, pods)
    state_b = 4 if plan.state_dtype == "float32" else 2

    # ---- memory ----
    # superblock length P: remat=block checkpoints at superblock granularity,
    # so the backward peak holds P layers' intermediates simultaneously.
    P = len(cfg.layer_pattern)
    if cfg.n_experts > 0:
        P = P * cfg.moe_every // math.gcd(P, cfg.moe_every)
    P = min(P, cfg.n_layers)

    # TP policies shard the d_ff / head dims of intermediates over the model
    # axis (via ctx.shard constraints in the layer code).
    tp_act = tp if plan.policy in ("tp_fsdp", "tp_only", "fsdp_pod",
                                   "tp_fsdp_moeff") else 1

    def layer_stored(t_chip: float, backward: bool = True) -> float:
        """Bytes of live intermediates per layer (backward keeps more).
        Coefficients calibrated against compiled single-pod cells."""
        per = (2 * cfg.d_ff / tp_act + 10 * cfg.d_model
               + 2 * cfg.n_heads * cfg.hd / tp_act)
        if cfg.n_experts > 0:
            # einsum (GShard) dispatch one-hots: k slots x (E*C) entries per
            # token, experts sharded over the model axis.  Calibrated against
            # the compiled granite-moe cell (45 GB @ mb=1, g=64).
            EC = cfg.n_experts * math.ceil(
                plan.moe_group * cfg.capacity_factor * max(1, cfg.top_k)
                / cfg.n_experts)
            per += max(1, cfg.top_k) * EC * 2 / max(tp, 1)
        if backward:
            if "rglru" in cfg.layer_pattern:
                # associative_scan holds O(log S) fp32 (a,b) pairs in backward
                per += 15 * (cfg.lru_width or cfg.d_model)
            if "rwkv" in cfg.layer_pattern:
                # five fp32 projections + chunked-scan carries/outputs
                per += 4 * cfg.d_model
        return t_chip * per * dtype_b

    param_b = 4 if plan.param_dtype == "float32" else 2
    accum_b = 4 if plan.accum_dtype == "float32" else 2
    mem = float(param_b) * N / pshards         # master params
    if mode == "train":
        mem += 2.0 * state_b * N / pshards     # adam m, v
        mem += float(accum_b) * N / pshards    # grad accumulation buffer
        mb = max(1, plan.microbatches)
        t_chip = tokens / (mb * dp_total)      # tokens per chip per microbatch
        if plan.remat == "block":
            act = cfg.n_layers * t_chip * cfg.d_model * dtype_b   # residuals
            act += P * layer_stored(t_chip)    # recompute peak inside a block
        else:
            act = cfg.n_layers * layer_stored(t_chip)
        # fp32 logits + grad + softmax stats; vocab-TP only shards when the
        # vocab divides the model axis (odd vocabs replicate — pad to fix)
        tp_vocab = tp if cfg.vocab % tp == 0 else 1
        act += 3.0 * t_chip * cfg.vocab * 4 / tp_vocab
        # empirical calibration vs compiled cells: XLA (CPU-backend fusion,
        # scan double-buffers, fp32 norm saves) lands ~2.5x the naive count
        mem += 2.5 * act
    else:
        mem = 2.0 * N / pshards                # bf16 weights for serving
        cshards = 1.0
        if B % dp_total == 0:
            cshards *= dp_total
        # cache "ctp" roles shard over the model axis under EVERY policy
        if plan.cache_mode == "seq" and S % tp == 0:
            cshards *= tp
        elif plan.cache_mode == "heads" and cfg.n_kv % tp == 0:
            cshards *= tp
        mem += cache_bytes_total(cfg, B, S) / cshards
        t_chip = max(1.0, tokens / dp_total)
        if mode == "prefill":
            mem += 2.0 * layer_stored(t_chip, backward=False)  # live fwd set
        tp_vocab = tp if cfg.vocab % tp == 0 else 1
        # logits are computed for the last position only (B rows)
        mem += max(1.0, B / dp_total) * cfg.vocab * 4 / tp_vocab
        mem *= 1.15

    # ---- compute ----
    flops_total = model_flops(cfg, tokens, "train" if mode == "train" else "serve")
    flops_chip = flops_total / n_chips
    t_compute = flops_chip / TPU_V5E["peak_flops"]

    # ---- HBM traffic ----
    mb = max(1, plan.microbatches)
    if mode == "train":
        # params re-read per microbatch (fwd+bwd), opt state r/w once
        traffic = (2.0 * N / pshards) * 2 * mb + 4.0 * state_b * N / pshards
        traffic += tokens / dp_total * cfg.n_layers * cfg.d_model * dtype_b * 6
    else:
        traffic = 2.0 * N / pshards
        # per-step cache reads scale with the cache's shard count: seq/heads
        # modes spread the 32k cache over the model axis too (the gemma3-4b
        # decode hillclimb measured 10x on exactly this term)
        cache_shards = 1.0
        if B % dp_total == 0:
            cache_shards *= dp_total
        if plan.cache_mode == "seq" and S % tp == 0:
            cache_shards *= tp
        elif plan.cache_mode == "heads" and cfg.n_kv % tp == 0:
            cache_shards *= tp
        traffic += cache_bytes_total(cfg, B, S) / cache_shards
        traffic += tokens / dp_total * cfg.n_layers * cfg.d_model * dtype_b * 4
    t_memory = traffic / TPU_V5E["mem_bw"]

    # ---- collectives ----
    coll = 0.0
    t_tok = tokens / dp_total                  # tokens this chip processes
    if tp > 1:
        # per layer: all-reduce (or AG+RS pair) of the activation, fwd+bwd
        per_layer = 2.0 * t_tok * cfg.d_model * dtype_b * (tp - 1) / tp
        coll += per_layer * cfg.n_layers * (2 if mode == "train" else 1)
        if cfg.n_experts > 0:
            coll += 2.0 * t_tok * cfg.d_model * dtype_b * (
                sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i)))
    if mode == "train":
        if plan.policy in ("tp_fsdp", "fsdp_only", "fsdp_pod"):
            shard_n = dp_total if plan.policy == "fsdp_pod" else dp
            ag = 2.0 * N / tp * (shard_n - 1) / shard_n
            coll += ag * (mb + 1)              # re-gather per microbatch + bwd
            coll += 2.0 * ag                   # grad reduce-scatter (fp32->2x)
        else:
            coll += 2.0 * 4.0 * N / tp * (dp_total - 1) / dp_total  # grad AR
    t_collective = coll / TPU_V5E["link_bw"]

    return PlanCost(mem_bytes=mem, t_compute=t_compute, t_memory=t_memory,
                    t_collective=t_collective, flops_chip=flops_chip,
                    coll_bytes_chip=coll)


# ---------------------------------------------------------------------------
# the H-EYE loop over candidate layouts
# ---------------------------------------------------------------------------
def candidate_plans(cfg, shape) -> list[Plan]:
    out: list[Plan] = []
    if shape.mode == "train":
        moe_groups = [256] if cfg.n_experts >= 64 else (
            [64] if cfg.n_experts else [1024])
        # dtype regimes, most conservative first: fp32 master everywhere ->
        # low-precision optimizer -> pure-bf16 (master+accum+state bf16; the
        # documented escape hatch for 400B-class models on a 4 TB pod).
        regimes = [("float32", "float32", "float32"),
                   ("float32", "bfloat16", "float32"),
                   ("float32", "bfloat16", "bfloat16"),
                   ("bfloat16", "bfloat16", "bfloat16")]
        for policy in ("tp_fsdp", "fsdp_pod"):
            for mb in (1, 2, 4, 8, 16, 32):
                if shape.global_batch % mb:
                    continue
                for remat in ("block", "none"):
                    for pdt, sdt, adt in regimes:
                        for g in moe_groups:
                            out.append(Plan(policy=policy, microbatches=mb,
                                            remat=remat, state_dtype=sdt,
                                            param_dtype=pdt, accum_dtype=adt,
                                            moe_group=g))
    else:
        moe_g = 64 if cfg.n_experts else 1024
        for policy in ("tp_only", "fsdp_only", "tp_fsdp"):
            for cache in ("batch", "seq", "heads"):
                out.append(Plan(policy=policy, microbatches=1, remat="none",
                                cache_mode=cache, moe_group=moe_g))
    return out


def choose_plan(cfg, shape, mesh_shape: tuple[int, ...],
                mesh_axes: tuple[str, ...],
                chip: Optional[ProcessingUnit] = None) -> tuple[Plan, PlanCost]:
    """H-EYE's Alg.1 pattern over layouts: predict each candidate, reject the
    ones whose memory constraint fails, pick the best objective.  ``chip``
    (a ProcessingUnit from core.topology.build_tpu_fleet) carries the HW
    attrs; its RooflineModel is the pluggable predict() of the paper."""
    model = RooflineModel()
    feasible: list[tuple[Plan, PlanCost, float]] = []
    fallback: Optional[tuple[Plan, PlanCost, float]] = None
    for plan in candidate_plans(cfg, shape):
        cost = predict_plan(cfg, shape, mesh_shape, mesh_axes, plan)
        if chip is not None:
            task = Task(kind=f"{cfg.name}:{shape.name}",
                        attrs={"flops": cost.flops_chip,
                               "bytes": cost.t_memory * TPU_V5E["mem_bw"],
                               "coll_bytes": cost.coll_bytes_chip})
            t = model.predict(task, chip)      # paper predict() interface
            t = t + 0.5 * cost.t_collective
        else:
            t = cost.t_step
        entry = (plan, cost, t)
        if fallback is None or cost.mem_bytes < fallback[1].mem_bytes:
            fallback = entry
        if not cost.fits:                      # constraint check (Alg.1 l.11)
            continue
        feasible.append(entry)
    if not feasible:
        assert fallback is not None
        plan, cost, _ = fallback
        return replace(plan, notes="NO plan fits HBM; min-memory fallback"), cost
    # among near-optimal feasible plans (<=10% slower than the best), prefer
    # the most numerically conservative dtype regime
    t_best = min(e[2] for e in feasible)

    def bf16_count(p: Plan) -> int:
        return sum(d != "float32" for d in
                   (p.param_dtype, p.accum_dtype, p.state_dtype))

    near = [e for e in feasible if e[2] <= 1.10 * t_best]
    plan, cost, _ = min(near, key=lambda e: (bf16_count(e[0]), e[2]))
    return plan, cost
