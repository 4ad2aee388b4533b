"""PipelineSchedule: precomputed per-tick work tables for the wavefront
pipeline — forward AND backward.  The port's own copy of
``repro/core/schedule.py`` (which imports no JAX; the port imports nothing of
``repro``): the same tables, so every rank of ``core/pipeline.py`` orders its
sends and receives by the same schedule as the JAX executor.

:class:`repro_torch.core.plan.WavefrontSchedule` does the *forward* clock
arithmetic (stage s computes global token-step ``u = m*S + t`` at tick
``s + u``).  The backward, however, was whatever autodiff produced by
transposing one big ``lax.scan``: every stage stashes activations for all
``k*S`` token-steps, so raising ``micro_batches`` — the throughput lever —
raises peak memory linearly.  This module makes the *whole* schedule an
explicit object:

* a **work table**: for every clock tick and stage, which (microbatch m,
  timestep t) is computed, forward or backward.  The table is the single
  source of truth for tick counts, bubble fractions, and — the point —
  **activation liveness**: a token-step's activations are live from its
  forward unit to its backward unit, and peak live count per stage is a
  table property, not an emergent autodiff artifact.

Two instances:

``gpipe``
    Today's behavior: the full forward wavefront (``k*S + NS - 1`` ticks,
    table-identical to ``WavefrontSchedule``), then the mirrored backward
    wavefront.  Every stage holds all ``k`` microbatches' activations at
    the fwd/bwd boundary — peak live microbatches per stage is ``k``.

``1f1b``
    One-forward-one-backward (PipeDream-flush / Megatron's memory
    schedule, applied at the wavefront's (m, t) granularity): a stage
    starts a microbatch's backward as soon as the backward wave reaches
    it, and is *gated* from starting a new microbatch's forward while
    ``min(k, NS - s)`` microbatches are in flight.  Peak live microbatches
    per stage is ``min(k, NS - s)`` — bounded by pipeline depth,
    independent of ``k``.

Two more instances:

``interleaved``
    Megatron-style virtual stages: each of the NS devices owns ``v`` layer
    *chunks* (``chunks`` field), so the wavefront runs over ``v * NS``
    virtual stages of ``L / (v*NS)`` layers each.  The table IS the gpipe
    table at ``v * NS`` stages — the ``stage`` column is the *virtual*
    stage, device = ``stage % NS`` — which makes ``interleaved`` at
    ``chunks=1`` literally identical to ``gpipe``.  At the wavefront's
    (m, t) granularity the units are already one-token thin, so unlike the
    microbatch-granular transformer case the fill/drain does NOT shrink
    (the u=0 token must cross ``v*NS - 1`` boundaries of 1/v-cost units:
    fill time ``NS - 1/v`` vs gpipe's ``NS - 1``); what the table buys is
    a pipeline ``v`` times deeper than the mesh with per-device work
    unchanged — the honest accounting is the point.

``zerobubble``
    The 1f1b table with each backward unit split into an input-grad unit
    (kind ``"B"``: d_gates + the dx/dh chain — the critical path) and a
    weight-grad unit (kind ``"W"``: the dWx/dWh GEMMs — no dependents).
    ``W(s, u)`` becomes ready once ``B(s, u)`` is done and is packed
    greedily into slots where the stage would otherwise idle, so the
    table-level bubble fraction drops strictly below 1f1b's whenever
    1f1b had a bubble to fill.  The stash lives until the LAST of
    B/W — zero-bubble trades activation liveness for bubble.

The table models the parallel-hardware timeline (what NS devices would
execute).  The executor in ``core/pipeline.py`` (one process per stage)
realizes the same dependency order with the same liveness bound via
per-group recompute; see its module docstring for the exact correspondence.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Tuple

SCHEDULES = ("gpipe", "1f1b", "interleaved", "zerobubble")

FWD = "F"
BWD = "B"
WGT = "W"  # zerobubble's deferred weight-grad unit


class Unit(NamedTuple):
    """One cell of the work table: at clock ``tick``, ``stage`` computes
    (``micro``, ``t``) in direction ``kind`` (``"F"`` or ``"B"``)."""

    tick: int
    stage: int
    kind: str
    micro: int
    t: int


def _build_gpipe(S: int, NS: int, k: int) -> Tuple[Unit, ...]:
    """Closed form: forward wavefront then its mirror.  Forward ticks are
    exactly WavefrontSchedule's arithmetic (``tick = s + m*S + t``); the
    backward of token-step u at stage s runs at
    ``TT + (NS-1-s) + (k*S-1-u)`` where ``TT = k*S + NS - 1``."""
    TT = k * S + NS - 1
    units = []
    for s in range(NS):
        for u in range(k * S):
            m, t = divmod(u, S)
            units.append(Unit(s + u, s, FWD, m, t))
            units.append(Unit(TT + (NS - 1 - s) + (k * S - 1 - u), s, BWD, m, t))
    return tuple(sorted(units))


def _build_1f1b(S: int, NS: int, k: int) -> Tuple[Unit, ...]:
    """Greedy event simulation at (m, t) granularity.

    Per tick each stage runs at most one unit, preferring backward;
    forward units execute in (m, t) order, backward in (m ascending,
    t descending) order — both orders keep exactly one recurrent carry
    live per direction, which is what the executor implements.  A stage
    may not START a new microbatch's forward (t == 0) while
    ``min(k, NS - s)`` microbatches are in flight (forward started,
    backward not finished) — the 1F1B depth gate.
    """
    n = k * S
    done_f = [[-1] * n for _ in range(NS)]  # completion tick of F(s, u)
    done_b = [[-1] * n for _ in range(NS)]
    pf = [0] * NS  # next forward u per stage (lexicographic (m, t))
    bwd_cur: List = [None] * NS  # (m, next t) when mid-backward
    bwd_next_m = [0] * NS  # next microbatch to start backward (ascending)
    n_bwd_done = [0] * NS
    limit = [min(k, NS - s) for s in range(NS)]
    units: List[Unit] = []
    remaining = 2 * NS * n
    tick = 0
    while remaining:
        chosen = []
        for s in range(NS):
            unit = None
            # backward first (the "1B" half): finish the in-progress
            # microbatch, else start the next one at t = S-1
            if bwd_cur[s] is not None:
                cand = bwd_cur[s]
            elif bwd_next_m[s] < k:
                cand = (bwd_next_m[s], S - 1)
            else:
                cand = None
            if cand is not None:
                m, t = cand
                u = m * S + t
                ok = 0 <= done_f[s][u] < tick
                if ok and t < S - 1:
                    ok = 0 <= done_b[s][u + 1] < tick
                if ok and s < NS - 1:
                    ok = 0 <= done_b[s + 1][u] < tick
                if ok:
                    unit = (BWD, m, t)
            if unit is None and pf[s] < n:
                m, t = divmod(pf[s], S)
                ok = s == 0 or 0 <= done_f[s - 1][pf[s]] < tick
                if ok and t == 0:
                    ok = (m - n_bwd_done[s]) < limit[s]  # depth gate
                if ok:
                    unit = (FWD, m, t)
            if unit is not None:
                chosen.append((s, unit))
        if not chosen:
            raise RuntimeError(
                f"1f1b schedule deadlock at tick {tick} "
                f"(S={S}, NS={NS}, k={k}; {remaining} units left)"
            )
        for s, (kind, m, t) in chosen:
            u = m * S + t
            if kind == FWD:
                done_f[s][u] = tick
                pf[s] += 1
            else:
                done_b[s][u] = tick
                if bwd_cur[s] is None:  # starting this microbatch's backward
                    bwd_next_m[s] += 1
                bwd_cur[s] = (m, t - 1) if t > 0 else None
                if t == 0:
                    n_bwd_done[s] += 1
            units.append(Unit(tick, s, kind, m, t))
            remaining -= 1
        tick += 1
    return tuple(units)


def _build_zerobubble(S: int, NS: int, k: int) -> Tuple[Unit, ...]:
    """The 1f1b event simulation with the backward split into B (input-grad,
    the dependency chain) and W (weight-grad, no dependents).  Per tick each
    stage prefers B, then gated F — exactly 1f1b's choices, so the F/B
    timeline is tick-identical to 1f1b — and only when neither is runnable
    does it retire the oldest pending W.  Every slot 1f1b left idle inside
    the steady state is therefore a W slot; leftover W units drain after
    the last B."""
    n = k * S
    done_f = [[-1] * n for _ in range(NS)]
    done_b = [[-1] * n for _ in range(NS)]
    pf = [0] * NS
    bwd_cur: List = [None] * NS
    bwd_next_m = [0] * NS
    n_bwd_done = [0] * NS
    limit = [min(k, NS - s) for s in range(NS)]
    pend_w: List[List[Tuple[int, int]]] = [[] for _ in range(NS)]  # FIFO of (m, t)
    units: List[Unit] = []
    remaining = 3 * NS * n
    tick = 0
    while remaining:
        chosen = []
        for s in range(NS):
            unit = None
            if bwd_cur[s] is not None:
                cand = bwd_cur[s]
            elif bwd_next_m[s] < k:
                cand = (bwd_next_m[s], S - 1)
            else:
                cand = None
            if cand is not None:
                m, t = cand
                u = m * S + t
                ok = 0 <= done_f[s][u] < tick
                if ok and t < S - 1:
                    ok = 0 <= done_b[s][u + 1] < tick
                if ok and s < NS - 1:
                    ok = 0 <= done_b[s + 1][u] < tick
                if ok:
                    unit = (BWD, m, t)
            if unit is None and pf[s] < n:
                m, t = divmod(pf[s], S)
                ok = s == 0 or 0 <= done_f[s - 1][pf[s]] < tick
                if ok and t == 0:
                    ok = (m - n_bwd_done[s]) < limit[s]
                if ok:
                    unit = (FWD, m, t)
            if unit is None and pend_w[s]:
                m, t = pend_w[s][0]
                if done_b[s][m * S + t] < tick:  # B finished a previous tick
                    unit = (WGT, m, t)
            if unit is not None:
                chosen.append((s, unit))
        if not chosen:
            raise RuntimeError(
                f"zerobubble schedule deadlock at tick {tick} "
                f"(S={S}, NS={NS}, k={k}; {remaining} units left)"
            )
        for s, (kind, m, t) in chosen:
            u = m * S + t
            if kind == FWD:
                done_f[s][u] = tick
                pf[s] += 1
            elif kind == BWD:
                done_b[s][u] = tick
                pend_w[s].append((m, t))
                if bwd_cur[s] is None:
                    bwd_next_m[s] += 1
                bwd_cur[s] = (m, t - 1) if t > 0 else None
                if t == 0:
                    n_bwd_done[s] += 1
            else:
                pend_w[s].pop(0)
            units.append(Unit(tick, s, kind, m, t))
            remaining -= 1
        tick += 1
    return tuple(units)


@functools.lru_cache(maxsize=128)
def _table(seq_len: int, num_stages: int, micro_batches: int, kind: str, chunks: int = 1) -> Tuple[Unit, ...]:
    if kind == "gpipe":
        return _build_gpipe(seq_len, num_stages, micro_batches)
    if kind == "1f1b":
        return _build_1f1b(seq_len, num_stages, micro_batches)
    if kind == "interleaved":
        # the gpipe wavefront over chunks * NS VIRTUAL stages; the stage
        # column is the virtual stage, device = stage % num_stages
        return _build_gpipe(seq_len, chunks * num_stages, micro_batches)
    if kind == "zerobubble":
        return _build_zerobubble(seq_len, num_stages, micro_batches)
    raise ValueError(f"schedule must be one of {SCHEDULES}, got {kind!r}")


@dataclass(frozen=True)
class PipelineSchedule:
    """A concrete (seq_len, num_stages, micro_batches, kind) work table.

    Forward arithmetic is shared with (and, for ``gpipe``, identical to)
    :class:`repro_torch.core.plan.WavefrontSchedule`; the table adds the
    backward half and the liveness accounting.
    """

    seq_len: int
    num_stages: int
    micro_batches: int = 1
    kind: str = "gpipe"
    chunks: int = 1  # virtual layer chunks per device (interleaved only)

    def __post_init__(self):
        if self.seq_len < 1 or self.num_stages < 1 or self.micro_batches < 1:
            raise ValueError(f"degenerate schedule {self}")
        if self.kind not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}, got {self.kind!r}")
        if self.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {self.chunks}")
        if self.chunks > 1 and self.kind != "interleaved":
            raise ValueError(f"chunks > 1 requires kind='interleaved', got {self.kind!r}")

    # -- the table ----------------------------------------------------------

    def table(self) -> Tuple[Unit, ...]:
        """All work units, sorted by (tick, stage)."""
        return _table(self.seq_len, self.num_stages, self.micro_batches, self.kind, self.chunks)

    @property
    def virtual_stages(self) -> int:
        """Rows of the table's stage column: ``chunks * num_stages``
        (``== num_stages`` for every kind but interleaved)."""
        return self.chunks * self.num_stages if self.kind == "interleaved" else self.num_stages

    def device_of(self, stage: int) -> int:
        """The mesh device executing table row ``stage``."""
        return stage % self.num_stages

    @property
    def wavefront(self):
        """The forward-only clock arithmetic (the plan's schedule object)."""
        from repro_torch.core.plan import WavefrontSchedule

        return WavefrontSchedule(
            seq_len=self.seq_len, num_stages=self.num_stages, micro_batches=self.micro_batches
        )

    @property
    def forward_ticks(self) -> int:
        """Ticks of the forward wavefront alone (``k*S + VS - 1`` over the
        VS = virtual_stages rows) — the trip count of the executor's
        forward scan for every kind."""
        return self.micro_batches * self.seq_len + self.virtual_stages - 1

    @property
    def total_ticks(self) -> int:
        """Length of the table's timeline (forward + backward)."""
        return self.table()[-1].tick + 1

    @property
    def work_units(self) -> int:
        """Units in the table: one F and one B per (row, m, t) — plus one
        W per (row, m, t) for zerobubble's split backward."""
        per = 3 if self.kind == "zerobubble" else 2
        return per * self.virtual_stages * self.micro_batches * self.seq_len

    @property
    def bubble_fraction(self) -> float:
        """Fraction of (tick, row) slots idle over the whole table."""
        return 1.0 - self.work_units / (self.virtual_stages * self.total_ticks)

    def time_stretch(self) -> float:
        """Elapsed time over ideal per-device compute time, from the table
        with per-kind unit costs (one forward unit of a gpipe-sized stage
        = 1): F=1, fused B=2 (4 GEMMs vs the forward's 2), zerobubble's
        split B=1 and W=1, all scaled by 1/chunks for interleaved's
        thinner virtual stages.  Lockstep: a tick lasts as long as the
        busiest device's units that tick.  For gpipe this reproduces the
        closed form ``(k*S + NS - 1) / (k*S)`` exactly."""
        unit = 1.0 / self.chunks
        cost = {FWD: unit, BWD: unit if self.kind == "zerobubble" else 2.0 * unit, WGT: unit}
        per_tick: Dict[int, Dict[int, float]] = {}
        total = 0.0
        for u in self.table():
            dev = per_tick.setdefault(u.tick, {})
            d = self.device_of(u.stage)
            dev[d] = dev.get(d, 0.0) + cost[u.kind]
            total += cost[u.kind]
        elapsed = sum(max(d.values()) for d in per_tick.values())
        return elapsed / (total / self.num_stages)

    # -- liveness accounting ------------------------------------------------

    def peak_live_microbatches(self, stage: int) -> int:
        """Max microbatches in flight at table row ``stage`` (forward
        started, backward not finished).  ``gpipe``: k.  ``1f1b``:
        min(k, NS - s).  ``zerobubble``: a microbatch stays in flight
        until its LAST backward-kind unit (B or W — the deferred
        weight-grads keep the stash alive), the memory cost of filling
        the bubble.

        Liveness brackets: in flight from F(t=0) until the last non-F
        unit of that microbatch at this row (B(t=0) for gpipe/1f1b)."""
        start: Dict[int, int] = {}
        end: Dict[int, int] = {}
        for u in self.table():
            if u.stage != stage:
                continue
            if u.kind == FWD:
                if u.t == 0:
                    start[u.micro] = u.tick
            else:
                end[u.micro] = max(end.get(u.micro, -1), u.tick)
        deltas: Dict[int, int] = {}
        for m, tick in start.items():
            deltas[tick] = deltas.get(tick, 0) + 1
        for m, tick in end.items():
            deltas[tick + 1] = deltas.get(tick + 1, 0) - 1
        live = peak = 0
        for tick in sorted(deltas):
            live += deltas[tick]
            peak = max(peak, live)
        return peak

    def peak_stash_steps(self, stage: int) -> int:
        """Max token-steps whose activations are live at table row
        ``stage`` (forward done, last backward-kind unit not done) — the
        stash the executor must hold, in units of one row's per-tick
        activations (1/chunks of a device's layers for interleaved)."""
        fwd: Dict[Tuple[int, int], int] = {}
        free: Dict[Tuple[int, int], int] = {}
        for u in self.table():
            if u.stage != stage:
                continue
            key = (u.micro, u.t)
            if u.kind == FWD:
                fwd[key] = u.tick
            else:  # freed only after the LAST of B/W (zerobubble)
                free[key] = max(free.get(key, -1), u.tick)
        deltas: Dict[int, int] = {}
        for key, tick in fwd.items():
            deltas[tick + 1] = deltas.get(tick + 1, 0) + 1
        for key, tick in free.items():
            deltas[tick + 1] = deltas.get(tick + 1, 0) - 1
        live = peak = 0
        for tick in sorted(deltas):
            live += deltas[tick]
            peak = max(peak, live)
        return peak

    @property
    def max_live_microbatches(self) -> int:
        return max(self.peak_live_microbatches(s) for s in range(self.virtual_stages))

    @property
    def max_stash_steps(self) -> int:
        """Per-DEVICE peak stash in row-units: for interleaved a device
        holds all its chunks' stashes (sum of per-row peaks — an upper
        bound when the chunk peaks don't coincide); identical to the
        per-row peak for every single-chunk kind."""
        return max(
            sum(self.peak_stash_steps(s) for s in range(self.virtual_stages) if self.device_of(s) == d)
            for d in range(self.num_stages)
        )

    def peak_activation_bytes(self, bytes_per_step: float) -> float:
        """Peak stashed-activation bytes per device, given the bytes one
        (row, m, t) unit stashes (see hybrid.pipeline_activation_model
        for the seq2seq LSTM term)."""
        return self.max_stash_steps * bytes_per_step

    # -- executor contract --------------------------------------------------

    @property
    def bwd_group_size(self) -> int:
        """Microbatches the executor's backward processes per recompute
        group: ``gpipe`` (and ``interleaved``, its v-deep generalization)
        rebuilds the whole step's stash at once (k); ``1f1b`` and
        ``zerobubble`` one microbatch at a time (1) — the single-program
        realization of the table's liveness bound."""
        return self.micro_batches if self.kind in ("gpipe", "interleaved") else 1

    @property
    def bwd_group_starts(self) -> Tuple[int, ...]:
        """First microbatch of each backward group, in execution order
        (ascending — the order the table retires microbatches)."""
        g = self.bwd_group_size
        return tuple(range(0, self.micro_batches, g))

    # -- reporting ----------------------------------------------------------

    def summary(self) -> dict:
        """The numbers dryrun prints next to the roofline terms."""
        return {
            "kind": self.kind,
            "seq_len": self.seq_len,
            "num_stages": self.num_stages,
            "micro_batches": self.micro_batches,
            "chunks": self.chunks,
            "virtual_stages": self.virtual_stages,
            "forward_ticks": self.forward_ticks,
            "total_ticks": self.total_ticks,
            "work_units": self.work_units,
            "bubble_fraction": round(self.bubble_fraction, 4),
            "time_stretch": round(self.time_stretch(), 4),
            "peak_live_microbatches": self.max_live_microbatches,
            "peak_stash_steps": self.max_stash_steps,
        }
