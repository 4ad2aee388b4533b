"""Continuous-batching engine for the ``encdec_memory`` cache policy (port of
``repro.serve.engine.ContinuousEngine`` without its paged, speculative and
mesh branches).

* chunked prefill: a source enters ``prefill_chunk`` tokens per step while
  that many remain, then one token per step, interleaved with decode ticks;
* decode tick: ONE batched ``decode_step`` over all K slots (the JAX engine
  ``vmap``s a one-slot step; here the slot dimension is written out:
  memory [K, M_cap, h], src_mask [K, M_cap], length [K]); inactive lanes
  are merged back to their prior state with ``torch.where``;
* admit-on-EOS recycling (``admission="continuous"``): retire + admit apply
  as ONE batched masked update per table leaf.  ``poison_on_recycle``
  first overwrites retired slots with NaN (floats), ``2**30`` (ints) or
  ``True`` (bools), so any state that admission's reset misses shows up in
  the outputs (the recycling canary).
"""
from __future__ import annotations

from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import ServePlan
from repro_torch.models import seq2seq as s2s
from repro_torch.models.common import tree_leaves, tree_map
from repro_torch.serve.sampling import greedy


class RequestError(Exception):
    """Per-request serving failure, returned IN the engine's output list
    (never raised mid-loop): one malformed or over-capacity request must not
    stop the serve loop and every in-flight slot with it."""

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class _Slot:
    __slots__ = ("req", "pos", "phase", "generated")

    def __init__(self):
        self.req = -1  # request index, -1 = free
        self.pos = 0  # prompt tokens consumed
        self.phase = "free"  # free | prefill | decode
        self.generated: list = []


def _poison_value(dtype: torch.dtype):
    if dtype == torch.bool:
        return True
    if not dtype.is_floating_point:
        return 2**30
    return float("nan")


def _lane_mask(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


class ContinuousEngine:
    """Slot-table serving of the seq2seq model under a :class:`ServePlan`.

    The table lives on the parameters' device.  ``check_live_finite`` makes
    every decode tick verify that the state of each decoding slot is finite
    (one host sync per tick) and raise otherwise; ``finite_checks`` counts
    the ticks so checked.  ``prefill_steps`` and ``decode_ticks`` count the
    last run's steps."""

    def __init__(self, cfg: ModelConfig, params: dict, plan: Optional[ServePlan] = None, *, bos: int = 1,
                 eos: Optional[int] = None, poison_on_recycle: bool = False, check_live_finite: bool = False):
        self.plan = plan if plan is not None else ServePlan.for_config(cfg)
        self.plan.validate_for(cfg)
        self.cfg = cfg
        self.device = params["head"]["w_alpha"].device
        self.params = s2s.cast_params(params, cfg)
        self.bos, self.eos = bos, eos
        self.poison_on_recycle = poison_on_recycle
        self.check_live_finite = check_live_finite
        self._K, self._C = self.plan.max_slots, self.plan.prefill_chunk
        self.prefill_steps = 0
        self.decode_ticks = 0
        self.finite_checks = 0

    # -- table operations ---------------------------------------------------

    def _init_table(self) -> s2s.Seq2SeqCache:
        return s2s.init_seq2seq_cache(self.cfg, self._K, self.plan.max_len, device=self.device)

    def _prefill(self, caches, k: int, chunk: np.ndarray):
        one = tree_map(lambda a: a[k : k + 1], caches)
        tokens = torch.as_tensor(chunk[None], dtype=torch.int64, device=self.device)
        new = s2s.encode_extend(self.params, self.cfg, tokens, one)
        tree_map(lambda full, leaf: full[k : k + 1].copy_(leaf), caches, new)

    def _recycle(self, caches, poison: np.ndarray, reset: np.ndarray):
        """Retired slots take the poison, admitted slots the fresh (all-zero)
        state; reset wins where a slot retires and is readmitted at once."""
        poison_idx = torch.as_tensor(np.flatnonzero(poison), device=self.device)
        reset_idx = torch.as_tensor(np.flatnonzero(reset), device=self.device)
        for leaf in tree_leaves(caches):
            if len(poison_idx):
                leaf[poison_idx] = _poison_value(leaf.dtype)
            if len(reset_idx):
                leaf[reset_idx] = 0

    def _tick(self, caches, cur_tok: np.ndarray, active: np.ndarray, sampler, generator):
        act = torch.as_tensor(active, device=self.device)
        tokens = torch.as_tensor(cur_tok, dtype=torch.int64, device=self.device)
        if self.poison_on_recycle:
            # non-decoding lanes compute on fresh state, never on a retired
            # slot's poison; the merge below still writes the table value back
            safe = tree_map(lambda a: torch.where(_lane_mask(act, a), a, torch.zeros((), dtype=a.dtype, device=a.device)),
                            caches)
        else:
            safe = caches
        logits, new = s2s.decode_step(self.params, self.cfg, tokens, safe, stage_kernel=self.plan.stage_kernel)
        merged = tree_map(lambda old, upd: torch.where(_lane_mask(act, upd), upd, old), caches, new)
        if self.check_live_finite:
            live = [torch.isfinite(leaf[act]).all() for leaf in tree_leaves(merged) if leaf.dtype.is_floating_point]
            if not bool(torch.stack(live).all()):
                raise RuntimeError("non-finite state in a decoding slot after a decode tick")
            self.finite_checks += 1
        toks = sampler(logits, generator)
        return toks.cpu().numpy(), merged

    # -- the serve loop -----------------------------------------------------

    def run(self, prompts: Sequence, max_new, *, sampler=greedy,
            generator: Optional[torch.Generator] = None) -> List[Any]:
        """Serve ``prompts`` (ragged list of 1-D token arrays: source
        sentences), generating up to ``max_new`` tokens each (int or
        per-request list); generation stops early at ``eos`` when the engine
        has one.  Returns per request, in request order, its generated
        tokens (int64 array) or a :class:`RequestError`."""
        n = len(prompts)
        prompts = [np.asarray(p, np.int64).reshape(-1) for p in prompts]
        max_news = [int(max_new)] * n if np.ndim(max_new) == 0 else [int(m) for m in max_new]
        self.plan.validate_batch(n)
        outputs: List[Any] = [None] * n
        queue: deque = deque()
        for i, (p, m) in enumerate(zip(prompts, max_news)):
            if len(p) < 1:
                outputs[i] = RequestError("each request needs a non-empty prompt")
            elif m < 0:
                outputs[i] = RequestError(f"max_new must be >= 0, got {m}")
            elif len(p) > self.plan.max_len:
                outputs[i] = RequestError(f"source length {len(p)} exceeds memory capacity {self.plan.max_len}")
            elif m == 0:
                outputs[i] = np.zeros((0,), np.int64)  # nothing asked: no prefill spent
            else:
                queue.append(i)

        self.prefill_steps = 0
        self.decode_ticks = 0
        self.finite_checks = 0
        caches = self._init_table()
        slots = [_Slot() for _ in range(self._K)]
        cur_tok = np.zeros(self._K, np.int64)
        # retire/admit masks accumulate on the host and apply as ONE batched
        # masked update before the next step that consumes the table
        poison_pending = np.zeros(self._K, bool)
        admit_pending = np.zeros(self._K, bool)

        def retire(s: _Slot, k: int):
            outputs[s.req] = np.asarray(s.generated, np.int64)
            s.req, s.phase, s.generated = -1, "free", []
            if self.poison_on_recycle:
                poison_pending[k] = True

        def admit_free_slots():
            for k, s in enumerate(slots):
                if s.phase == "free" and queue:
                    s.req, s.pos, s.phase, s.generated = queue.popleft(), 0, "prefill", []
                    admit_pending[k] = True

        def apply_recycle():
            if poison_pending.any() or admit_pending.any():
                self._recycle(caches, poison_pending, admit_pending)
                poison_pending[:] = False
                admit_pending[:] = False

        while queue or any(s.phase != "free" for s in slots):
            admit_free_slots()
            apply_recycle()
            # ---- chunked prefill: one chunk per prefilling slot per loop --
            for k, s in enumerate(slots):
                if s.phase != "prefill":
                    continue
                prompt = prompts[s.req]
                step = self._C if len(prompt) - s.pos >= self._C else 1
                self._prefill(caches, k, prompt[s.pos : s.pos + step])
                self.prefill_steps += 1
                s.pos += step
                if s.pos == len(prompt):  # source consumed: decoding starts from BOS
                    cur_tok[k] = self.bos
                    s.phase = "decode"
            # ---- decode tick: one batched step over the whole table -------
            active = np.array([s.phase == "decode" for s in slots])
            if active.any():
                toks, caches = self._tick(caches, cur_tok, active, sampler, generator)
                self.decode_ticks += 1
                for k, s in enumerate(slots):
                    if not active[k]:
                        continue
                    tok = int(toks[k])
                    s.generated.append(tok)
                    cur_tok[k] = tok
                    if (self.eos is not None and tok == self.eos) or len(s.generated) >= max_news[s.req]:
                        retire(s, k)
        return outputs
