"""Hybrid data-model parallelism: phase accounting and analytic costs (the
port's own copy of ``repro/core/hybrid.py``, on the port's ``ModelConfig``).

``strategy.phase_boundary_fn`` implements the mechanism; this module carries
the *model* of why it wins — the paper's argument made quantitative so the
benchmarks and EXPERIMENTS.md can report per-strategy communication volumes
on any mesh (it also reproduces Table 3's qualitative ordering analytically).

Per training step and global batch B, sequence lengths M (src), N (tgt),
hidden h, params P_backbone / P_head, devices D:

  DATA    grad all-reduce of (P_backbone + P_head) every step
          -> bytes ≈ 2 * 4 * (P_b + P_h) * (D-1)/D   per device (ring)
  MODEL   activations hop between stages (pipeline) or psum per layer (TP);
          no parameter sync.
  HYBRID  activations hop (backbone) + ONE reshard of the hidden states
          S,H (B*(M+N)*h values) + grad all-reduce of P_head only.

The paper's observation "4U of 40U parameters in the head" is exactly the
statement bytes(HYBRID grad sync) ≈ 0.1 * bytes(DATA grad sync).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig

#: activation bytes per element by compute dtype.  Gradients are NOT in this
#: table on purpose: accumulation and the all-reduce stay fp32 (master
#: weights), so grad bytes are 4 regardless of compute dtype.
ACT_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def act_bytes_for(compute_dtype: Optional[str], default: int) -> int:
    """Dtype-aware activation bytes; ``default`` preserves legacy callers
    that pass raw ``act_bytes`` and no dtype."""
    if compute_dtype is None:
        return default
    try:
        return ACT_BYTES[compute_dtype]
    except KeyError:
        raise ValueError(f"unknown compute dtype {compute_dtype!r}")


@dataclass(frozen=True)
class CommCost:
    """Per-step, per-device communication volume in bytes (fp32 grads,
    activation dtype 2 bytes).

    ``overlap_hidden`` counts the bytes whose transfer executes UNDER
    backbone compute (the delayed head-grad psum of every microbatch but
    the last, when the plan's overlap flag is on): they still cross the
    wire — ``total`` includes them — but ``exposed`` subtracts them, which
    is the volume the step-time model should charge for."""

    grad_sync: float
    activation_reshard: float
    pipeline_hops: float
    overlap_hidden: float = 0.0

    @property
    def total(self) -> float:
        return self.grad_sync + self.activation_reshard + self.pipeline_hops

    @property
    def exposed(self) -> float:
        return self.total - self.overlap_hidden


def seq2seq_param_split(cfg: ModelConfig) -> tuple[int, int]:
    """(backbone, head) parameter counts for the paper's model."""
    h, e, v = cfg.d_model, cfg.emb_size, cfg.vocab_size
    emb = 2 * v * e
    lstm = lambda in_dim: 4 * h * (in_dim + h + 1)
    enc = sum(lstm(e if i == 0 else h) for i in range(cfg.num_layers))
    dec_in0 = e + (h if cfg.input_feeding else 0)
    dec = sum(lstm(dec_in0 if i == 0 else h) for i in range(cfg.num_layers))
    head = h * h + 2 * h * h + h * v  # W_alpha + W_c + F_c
    return emb + enc + dec, head


def strategy_comm_cost(
    cfg: ModelConfig,
    *,
    strategy: str,
    devices: int,
    batch: int,
    src_len: int,
    tgt_len: int,
    grad_bytes: int = 4,
    act_bytes: int = 2,
    micro_batches: int = 1,
    overlap: bool = False,
    compute_dtype: Optional[str] = None,
) -> CommCost:
    """``micro_batches`` > 1 syncs the hybrid head's grads once per
    microbatch (the accumulation loop's per-micro all-reduce); ``overlap``
    hides all but the last of those under the next microbatch's backbone
    compute (reported via ``CommCost.overlap_hidden``).

    ``compute_dtype`` makes the activation byte terms dtype-aware
    (overriding ``act_bytes``); grad bytes stay 4 — accumulation and the
    all-reduce are fp32 under the master-weight scheme.  For the ``data``
    strategy, ``overlap`` models the BUCKETED all-reduce: every bucket's
    sync but the last microbatch's executes under the next microbatch's
    backward, hiding ``(k-1)/k`` of the grad volume."""
    pb, ph = seq2seq_param_split(cfg)
    h = cfg.d_model
    k = micro_batches
    act_bytes = act_bytes_for(compute_dtype, act_bytes)
    ring = 2 * (devices - 1) / devices  # ring all-reduce factor
    hidden_vals = batch * (src_len + tgt_len) * h
    hop_vals = batch * (src_len + tgt_len) * h  # one hand-off per stage boundary
    if strategy == "data":
        grad_sync = ring * grad_bytes * (pb + ph)
        return CommCost(
            grad_sync=grad_sync,
            activation_reshard=0.0,
            pipeline_hops=0.0,
            overlap_hidden=grad_sync * (k - 1) / k if (overlap and k > 1) else 0.0,
        )
    if strategy == "model":
        return CommCost(grad_sync=0.0, activation_reshard=0.0, pipeline_hops=act_bytes * hop_vals)
    if strategy == "hybrid":
        head_sync = k * ring * grad_bytes * ph
        return CommCost(
            grad_sync=head_sync,
            activation_reshard=act_bytes * hidden_vals * (devices - 1) / devices,
            pipeline_hops=act_bytes * hop_vals,
            overlap_hidden=head_sync * (k - 1) / k if overlap else 0.0,
        )
    if strategy == "hybrid_opt":
        # vocab-sharded head: no head grad all-reduce; reshard replaced by
        # the logits' psum (counted as activation bytes of the lse stats).
        return CommCost(
            grad_sync=0.0,
            activation_reshard=act_bytes * batch * tgt_len * h,
            pipeline_hops=act_bytes * hop_vals,
        )
    raise ValueError(strategy)


@dataclass(frozen=True)
class CommContract:
    """The plan's *declared* comm set, matchable against lowered HLO.

    ``allowed`` is the closed set of collective kinds GSPMD may emit for
    this plan; anything else is an unexpected reshard (SHRD001 — the
    stack-into-shard_map bug class).  ``required`` kinds must appear or the
    step is not actually synchronizing (SHRD003).  ``ceiling_bytes`` is a
    per-kind per-device order-of-magnitude tripwire (SHRD002), NOT the
    analytic CommCost: GSPMD legitimately all-reduces per scan timestep, so
    the lowered volume runs ~seq_len x the single-shot analytic terms.
    ``min_all_reduce_ops`` pins the bucketed delayed-psum promise: at least
    one all-reduce instruction per grad bucket must survive lowering."""
    allowed: frozenset
    required: frozenset
    ceiling_bytes: float
    min_all_reduce_ops: int = 0


def comm_contract(
    cfg: ModelConfig,
    *,
    strategy: str,
    devices: int,
    batch: int,
    src_len: int,
    tgt_len: int,
    micro_batches: int = 1,
    overlap: bool = False,
    pipelined: bool = False,
    compute_dtype: Optional[str] = None,
    bucket_count: int = 0,
) -> CommContract:
    """Build the audit contract for one training plan from the same terms
    as :func:`strategy_comm_cost`.

    Kind sets are the empirically closed sets per strategy family:

    * no mesh / 1 device — NO collectives at all;
    * ``data`` — grad all-reduce (per-timestep under the scan), the
      microbatch loop's collective-permute, and the bucketed path's small
      all-to-alls.  **Never all-gather**: a data-parallel graph gathering an
      activation means GSPMD un-sharded the batch axis mid-graph — exactly
      the stack-into-shard_map reshard;
    * model/hybrid/hybrid_opt — every kind is legitimate (stacked-stage
      shard_map pipelines all-gather their stage params each step, rings
      permute, phase boundaries all-to-all)."""
    all_kinds = frozenset(
        {"all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"}
    )
    if devices <= 1:
        return CommContract(frozenset(), frozenset(), 0.0)
    pb, ph = seq2seq_param_split(cfg)
    ab = act_bytes_for(compute_dtype, 4)
    steps = src_len + tgt_len
    grad_volume = 4.0 * (pb + ph)  # grads sync fp32 under master weights
    act_volume = float(ab) * batch * steps * cfg.d_model
    # per-timestep resharding under the scan multiplies either term by the
    # step count; 16x on top of that is slack, not precision — the ceiling
    # is a tripwire for runaway resharding, the KIND set does the real work
    ceiling = 16.0 * steps * (grad_volume + act_volume)
    if strategy == "data":
        allowed = frozenset({"all-reduce", "reduce-scatter", "all-to-all", "collective-permute"})
        required = frozenset({"all-reduce"})
    else:
        allowed = all_kinds
        required = frozenset({"all-reduce"}) if strategy in ("hybrid", "hybrid_opt") else frozenset()
        if pipelined:
            required = required | frozenset({"collective-permute"})
    min_ar = bucket_count if (strategy in ("data", "hybrid") and overlap and bucket_count) else 0
    return CommContract(allowed, required, ceiling, min_all_reduce_ops=min_ar)


def serve_comm_contract(*, devices: int) -> CommContract:
    """Serve ticks: a meshless engine must lower to zero collectives; a
    sharded one may use any kind (KV-head gathers, vocab-shard psums,
    slot-axis permutes) but the per-tick volume is activation-scale —
    the ceiling is set by the audit caller from the cache byte size."""
    if devices <= 1:
        return CommContract(frozenset(), frozenset(), 0.0)
    all_kinds = frozenset(
        {"all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute"}
    )
    return CommContract(all_kinds, frozenset(), float("inf"))


def pipeline_activation_model(
    cfg: ModelConfig,
    *,
    schedule: str,
    num_stages: int,
    micro_batches: int,
    batch: int,
    src_len: int,
    tgt_len: int,
    act_bytes: int = 2,
    carry_bytes: int = 4,
    compute_dtype: Optional[str] = None,
    virtual_stages: int = 1,
) -> dict:
    """Predicted peak stashed-activation bytes per pipeline stage for the
    seq2seq backbone's backward, per :class:`PipelineSchedule` kind.

    One (stage, m, t) work unit stashes the per-layer recurrent carries its
    cells consumed — ``2 * Lp * B_mb * H`` fp32 values (h_in + c_in; the
    gates are recomputed analytically, never stashed) — so a stage's peak
    is ``peak_stash_steps * unit_bytes``, a table property:

    * ``gpipe``: ``k*S`` steps live at the fwd/bwd boundary — linear in
      ``micro_batches``, the memory wall this module's Table-3 throughput
      terms run into when k is pushed up;
    * ``1f1b``: ``min(k, NS)*S`` by the table (``S`` in the single-program
      executor) — bounded by pipeline depth, flat in k.

    The encoder and decoder backwards are separate scheduled executions
    that never overlap, so the stash peak is the MAX of the two sides; the
    boundary buffers (one [B, H] hand-off vector per token-step,
    ``act_bytes`` each — the ~6·Lp× smaller residual the recompute works
    from) are saved at forward time and live through both backwards, so
    they SUM.

    ``batch`` is whatever batch the caller accounts for (global, or
    per-shard for a per-device number).

    ``compute_dtype`` makes the boundary-buffer bytes dtype-aware (the
    hand-off vectors are saved in the activation dtype); the recurrent
    carries stay fp32 — the executor keeps h/c in fp32 regardless.

    ``virtual_stages`` > 1 (interleaved): the table runs over ``v*NS``
    virtual stages whose work units each cover ``Lp/v`` layers, so the
    per-unit stash shrinks by ``1/v`` while per-DEVICE stash counts sum
    over the device's v chunks — net stash bytes match gpipe, but the
    per-unit granularity (and the table's bubble/live numbers) change.
    """
    from repro_torch.core.schedule import PipelineSchedule

    act_bytes = act_bytes_for(compute_dtype, act_bytes)
    chunks = virtual_stages if schedule == "interleaved" else 1
    h = cfg.d_model
    lp = max(cfg.num_layers // num_stages, 1)
    b_mb = batch / micro_batches
    # h_in + c_in per layer, fp32; one unit covers a CHUNK's layers
    unit = 2 * (lp / chunks) * b_mb * h * carry_bytes
    out = {"schedule": schedule, "unit_bytes": unit, "virtual_stages": chunks * num_stages}
    stash = bubble = live = 0
    boundary = 0.0
    for S in (src_len, tgt_len):
        sched = PipelineSchedule(
            seq_len=S, num_stages=num_stages, micro_batches=micro_batches, kind=schedule,
            chunks=chunks,
        )
        stash = max(stash, sched.peak_activation_bytes(unit))
        boundary += chunks * micro_batches * S * b_mb * h * act_bytes
        bubble = max(bubble, sched.bubble_fraction)
        live = max(live, sched.max_live_microbatches)
    out.update(
        peak_stash_bytes=stash,
        boundary_bytes=boundary,
        peak_bytes=stash + boundary,
        bubble_fraction=bubble,
        peak_live_microbatches=live,
        time_stretch=max(
            PipelineSchedule(
                seq_len=S, num_stages=num_stages, micro_batches=micro_batches,
                kind=schedule, chunks=chunks,
            ).time_stretch()
            for S in (src_len, tgt_len)
        ),
    )
    return out


def _param_groups(cfg: ModelConfig, input_feeding: bool) -> tuple[float, float, float]:
    """(encoder-side, decoder-side, head) parameter counts.  Embeddings are
    split onto their side; ``input_feeding`` widens the first decoder layer."""
    h, e, v = cfg.d_model, cfg.emb_size, cfg.vocab_size
    lstm = lambda in_dim: 4 * h * (in_dim + h + 1)
    enc = v * e + sum(lstm(e if i == 0 else h) for i in range(cfg.num_layers))
    dec_in0 = e + (h if input_feeding else 0)
    dec = v * e + sum(lstm(dec_in0 if i == 0 else h) for i in range(cfg.num_layers))
    head = h * h + 2 * h * h + h * v  # W_alpha + W_c + F_c
    return enc, dec, head


def _num_sync_arrays(cfg: ModelConfig) -> int:
    """Parameter arrays a data-parallel sync must move: (wx, wh, b) per LSTM
    layer on both sides, two embedding tables, three head matrices."""
    return 3 * cfg.num_layers * 2 + 2 + 3


def scaling_factor_model(
    cfg: ModelConfig,
    *,
    strategy: str,
    devices: int,
    batch: int,
    src_len: int,
    tgt_len: int,
    flops_per_sec: float,
    link_bytes_per_sec: float,
    input_feeding: bool = False,
    base_batch: int = 64,
    batch_half_util: float = 64.0,
    sync_latency_per_array: float = 0.026,
    micro_batches: int = 1,
    overlap: bool = False,
    schedule: str = "gpipe",
    virtual_stages: int = 1,
    compute_dtype: Optional[str] = None,
) -> float:
    """Analytic Table-3 scaling factor vs the paper's 1-GPU baseline.

    Throughput ratio (src tokens/s of the D-device config over the 1-device
    ``base_batch`` run), i.e. ``(batch/base_batch) * t_base / t_strategy``.
    Three mechanisms, each tied to a paper observation:

    * **Batch-utilization curve** ``rate(B) = flops_per_sec * B/(B+B0)``:
      per-step kernel-launch overhead and partial GEMM tiles make small
      per-device batches inefficient.  Multi-GPU configs run ~4x the
      mini-batch (Table 3 note) — this is where the super-linear
      4.13-4.20x comes from.
    * **Per-array sync latency**: 2019-era synchronous data parallelism
      (MXNet kvstore / OpenNMT-lua) pushes each parameter array to a root
      device, updates, and broadcasts — per-array round-trip latency
      dominates the wire time.  ``sync_latency_per_array`` is calibrated
      once against the paper's own measured data-parallel row (1.60x);
      both toolkits measure the same, so it is a framework constant, not
      a NVLink property.  The ring-bandwidth term is kept for the bytes.
    * **Wavefront bubble** ``(L+D-1)/(L*D)`` for the pipelined stacks;
      with input-feeding the decoder (and the head chained behind it)
      cannot wavefront and runs serially (paper Fig. 2) — Table 3's
      "w/ model parallelism" row IS the input-feeding baseline, so pass
      ``input_feeding=True`` to reproduce it.

    HYBRID runs the backbone as the wavefront and the head data-parallel
    on batch shards (lower ``rate(B/D)`` utilization, head-only sync, one
    activation reshard at link speed) — the paper's §3.2 schedule.

    **Microbatching** (``micro_batches=k``, the ExecutionPlan schedule):

    * the wavefront interleaves the k slices through ONE fill/drain —
      bubble ``(k*L + D - 1)/(k*L*D)`` instead of ``(L + D - 1)/(L*D)``
      per microbatch — but every per-tick GEMM now carries batch B/k, so
      the utilization curve ``rate(B/k)`` pushes the other way;
    * the hybrid head syncs its grads once per microbatch (k sync events);
      ``overlap=True`` is the trainer's delayed psum — every sync but the
      last executes under the next microbatch's backbone compute, so only
      one sync event is exposed.  Hybrid-with-overlap therefore dominates
      hybrid for every k > 1.

    **Schedules beyond gpipe** (``schedule`` / ``virtual_stages``): the
    wavefront term generalizes from the gpipe closed form to the schedule
    table's ``time_stretch()`` — elapsed lockstep ticks over ideal
    per-device compute — which reproduces the gpipe closed form exactly
    and prices 1f1b the same (identical F/B timeline) but zerobubble
    strictly cheaper (W units fill the drain).  The gpipe default keeps
    the legacy closed form so existing calibrations are bit-identical.

    **Half precision** (``compute_dtype``): bf16/fp16 double the GEMM
    rate (``flops_per_sec`` is the fp32 rate); the 1-GPU baseline stays
    fp32, so mixed precision shows up as super-linear scaling — exactly
    how Ott et al. report it.  For the ``data`` strategy, ``overlap``
    additionally models the bucketed all-reduce: only the last
    microbatch's bucket syncs are exposed (wire term / k).
    """
    p_enc, p_dec, p_head = _param_groups(cfg, input_feeding)
    h = cfg.d_model
    k = micro_batches
    mp = 2.0 if compute_dtype in ("bfloat16", "float16") else 1.0
    rate = lambda B: mp * flops_per_sec * B / (B + batch_half_util)
    rate_base = lambda B: flops_per_sec * B / (B + batch_half_util)
    F = lambda P, B, L: 6.0 * P * B * L  # fwd+bwd flops of group P over B x L tokens
    ring = 2 * (devices - 1) / devices
    if schedule == "gpipe" and virtual_stages == 1:
        # microbatched wavefront: k*L token-steps share one (D-1)-tick
        # fill/drain (legacy closed form, kept bit-identical)
        bubble = lambda L: (k * L + devices - 1) / (k * L * devices)
    else:
        from repro_torch.core.schedule import PipelineSchedule

        def bubble(L):
            sched = PipelineSchedule(
                seq_len=L, num_stages=devices, micro_batches=k, kind=schedule,
                chunks=virtual_stages if schedule == "interleaved" else 1,
            )
            return sched.time_stretch() / devices

    def sync_t(param_count: float, n_arrays: int) -> float:
        return ring * 4.0 * param_count / link_bytes_per_sec + n_arrays * sync_latency_per_array

    # the 1-GPU baseline row (batch = base_batch, everything serial, fp32)
    t_base = (
        F(p_enc, base_batch, src_len) + F(p_dec, base_batch, tgt_len) + F(p_head, base_batch, tgt_len)
    ) / rate_base(base_batch)

    f_enc, f_dec, f_head = F(p_enc, batch, src_len), F(p_dec, batch, tgt_len), F(p_head, batch, tgt_len)
    reshard = 2.0 * batch * (src_len + tgt_len) * h * (devices - 1) / devices / link_bytes_per_sec

    if strategy == "data":
        Bd = batch / devices
        # grad accumulation: same total flops at microbatch-size utilization
        t = (F(p_enc, Bd, src_len) + F(p_dec, Bd, tgt_len) + F(p_head, Bd, tgt_len)) / rate(Bd / k)
        full_sync = sync_t(p_enc + p_dec + p_head, _num_sync_arrays(cfg))
        if overlap and k > 1:
            # bucketed delayed all-reduce: wire time of all buckets but the
            # last microbatch's hides under backward compute; the per-array
            # latency is not hidden (it is serialization, not bandwidth)
            wire = ring * 4.0 * (p_enc + p_dec + p_head) / link_bytes_per_sec
            full_sync -= wire * (k - 1) / k
        t += full_sync
    elif strategy == "model":
        # paper Fig. 2: layers on 3 GPUs, attention-softmax on the 4th, all
        # wavefronted; input-feeding serializes decoder + head.
        if input_feeding:
            t = f_enc * bubble(src_len) / rate(batch / k) + (f_dec + f_head) / rate(batch / k)
        else:
            t = (f_enc * bubble(src_len) + (f_dec + f_head) * bubble(tgt_len)) / rate(batch / k)
    elif strategy in ("hybrid", "hybrid_opt"):
        Bd = batch / devices
        if input_feeding:  # HybridNMTIF: decoder serial, head data-parallel per step
            t_bb = f_enc * bubble(src_len) / rate(batch / k) + f_dec / rate(batch / k)
        else:  # HybridNMT: full wavefront backbone
            t_bb = (f_enc * bubble(src_len) + f_dec * bubble(tgt_len)) / rate(batch / k)
        if strategy == "hybrid":
            t_head = F(p_head, Bd, tgt_len) / rate(Bd / k)
            n_exposed_syncs = 1 if overlap else k
            t = t_bb + t_head + n_exposed_syncs * sync_t(p_head, 3) + reshard
        else:  # beyond-paper: vocab-sharded head — no head sync, full-batch GEMMs
            t = t_bb + f_head / devices / rate(batch / k) + reshard / 2
    else:
        raise ValueError(strategy)
    return (batch / base_batch) * t_base / t
