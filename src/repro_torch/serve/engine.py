"""Serving engines (port of ``repro/serve/engine.py`` without its paged,
speculative and mesh branches).

``ServeEngine`` is the static-batch loop of the dense and MoE LM families:
one prefill over the padded batch (``prefill_fn``; its attention runs on the
``flash_attn`` kernel on the card, and each MoE layer's expert FFN on the
``moe_gemm`` kernel), the caches padded to a capacity bucket
(``pad_cache``), then one decode step per new token (``serve_step_fn``;
the expert FFN on ``moe_gemm`` there too).

``ContinuousEngine`` is the continuous-batching engine of the
``encdec_memory`` cache policy (the seq2seq family; the LM policies of the
JAX package's engine are not ported yet, ROADMAP queue 1 item 5):

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

import time
from collections import deque
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.plan import ServePlan
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device, tree_leaves, tree_map
from repro_torch.serve.sampling import greedy


def serve_step_fn(cfg: ModelConfig, *, window: Optional[int] = None, stage_kernel: str = "cuda"):
    """One decode step: (params, token [B], cache) -> (next logits [B, V],
    cache); the cache's entries are updated in place.  ``stage_kernel``
    picks the MoE expert FFN: ``cuda`` (the moe_gemm kernel) or ``torch``
    (``moe.expert_ffn``)."""
    ctx = tfm.RunCtx(mode="decode", window=window, kernel=stage_kernel)

    def step(params, token, cache):
        return tfm.forward_decode(params, cfg, token, cache, ctx=ctx)

    return step


def prefill_fn(cfg: ModelConfig, *, window: Optional[int] = None, q_chunk: int = 128, stage_kernel: str = "cuda"):
    """The prefill: (params, tokens [B, S]) -> (logits at the last position
    [B, V], cache).  ``stage_kernel`` picks the kernels: ``cuda`` (the
    flash_attn kernel for the attention, the moe_gemm kernel for the MoE
    expert FFN) or ``torch`` (the plain chunked attention, ``moe.expert_ffn``)."""
    ctx = tfm.RunCtx(mode="prefill", window=window, q_chunk=q_chunk, kernel=stage_kernel)

    def prefill(params, tokens):
        return tfm.forward_prefill(params, cfg, tokens, ctx=ctx)

    return prefill


def pad_cache(cfg: ModelConfig, cache: tfm.LMCache, capacity: int) -> tfm.LMCache:
    """Grow the attention entries (prefill emits exactly S slots, or the
    window's W) to ``capacity`` slots so decode can append; never shrinks."""
    entries = []
    for k, v in cache.entries:
        extra = capacity - k.shape[2]
        if extra > 0:
            z = torch.zeros(k.shape[:2] + (extra,) + k.shape[3:], dtype=k.dtype, device=k.device)
            k, v = torch.cat([k, z], dim=2), torch.cat([v, z], dim=2)
        entries.append((k, v))
    return tfm.LMCache(entries=tuple(entries), length=cache.length)


class ServeEngine:
    """Static-batch prefill + decode loop of the dense and MoE LM families.

    A :class:`ServePlan` (``full_kv`` or ``window``) replaces the loose
    keywords: its window, ``max_len``, ``prefill_chunk`` (the capacity
    bucket) and ``stage_kernel`` (the kernels of both the prefill attention
    and the MoE expert FFN).  The fp32
    master weights are moved to ``device`` once and cast to the compute
    dtype once per :meth:`generate` call, not per token.  ``prefill_s`` and
    ``decode_s`` hold the last call's prefill (first token included) and
    decode wall times, each ended by a synchronise on the card.

    Greedy decode of three or more tokens on the card replays one CUDA graph
    per token: the first decode step runs eagerly (it also warms the
    allocator and cuBLAS), the second is captured (:meth:`capture_decode`),
    and it and every later one are replays.  The eager step issues a few
    thousand small launches, which the host cannot feed as fast as the card
    runs them; the graph launches them as one.  ``cuda_graph=False`` runs
    every step eagerly, which is what the CPU and sampled decoding do.

    The decode cache's capacity is ``prompt + steps`` rounded up to a
    ``pad_to`` multiple and capped at ``max_len``, as in the JAX engine, and
    also at the window: a windowed cache then always decodes as the rolling
    buffer (the JAX engine pads past the window when ``max_len`` exceeds it,
    and its decode then drops the window; ROADMAP queue 3).  A request that
    does not fit an unwindowed cache raises.
    """

    def __init__(self, cfg: ModelConfig, params: dict, *, plan: Optional[ServePlan] = None,
                 window: Optional[int] = None, max_len: int = 512, pad_to: int = 32, stage_kernel: str = "cuda",
                 device="cuda"):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"ServeEngine serves the dense LM family and the moe family, not {cfg.family!r}")
        if plan is not None:
            plan.validate_for(cfg)
            window, max_len, pad_to, stage_kernel = plan.window, plan.max_len, plan.prefill_chunk, plan.stage_kernel
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda a: a.to(self.device), params)
        self.window = window
        self.max_len = max_len
        self.pad_to = max(1, pad_to)
        self._prefill = prefill_fn(cfg, window=window, stage_kernel=stage_kernel)
        self._step = serve_step_fn(cfg, window=window, stage_kernel=stage_kernel)
        self.prefill_s = self.decode_s = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _capacity(self, prompt_len: int, steps: int, prefilled: int) -> int:
        need = prompt_len + steps
        cap = min(self.max_len, -(-need // self.pad_to) * self.pad_to)
        if self.window is not None:
            cap = min(cap, self.window)
        cap = max(cap, prefilled)
        if need > cap and cap != self.window:
            raise ValueError(f"prompt {prompt_len} + {steps} steps exceed the cache capacity {cap} "
                             f"(max_len={self.max_len}, window={self.window})")
        return cap

    def capture_decode(self, params, tok: torch.Tensor, cache: tfm.LMCache):
        """One eager greedy decode step from ``tok``, then a CUDA graph of the
        next step captured (not run).  The token, the length and the cache
        live in fixed buffers that the step updates in place: each
        ``graph.replay()`` takes one more greedy step.  Returns (graph, token
        buffer, cache state); the buffer holds the eager step's token.  The
        graph holds raw pointers only: the caller keeps the buffer, the state
        and ``cache`` alive while it replays."""
        tok_buf = tok.clone()
        state = tfm.LMCache(entries=cache.entries, length=cache.length.clone())

        def step():
            logits, _ = self._step(params, tok_buf, state)
            tok_buf.copy_(greedy(logits))
            state.length.add_(1)

        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):  # warm-up off the capture's stream, as torch.cuda.graph asks
            step()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        return graph, tok_buf, state

    def _decode_graphed(self, params, tok: torch.Tensor, cache: tfm.LMCache, n: int) -> list:
        """``n`` greedy decode steps from ``tok``: one eager, then replays of
        the captured graph (:meth:`capture_decode`)."""
        graph, tok_buf, _state = self.capture_decode(params, tok, cache)
        out = [tok_buf.clone()]
        for _ in range(n - 1):
            graph.replay()
            out.append(tok_buf.clone())
        return out

    def generate(self, prompt_tokens, steps: int, *, sampler=greedy,
                 generator: Optional[torch.Generator] = None, cuda_graph: bool = True) -> torch.Tensor:
        """prompt_tokens [B, S] -> generated [B, steps] int64, on the engine's device."""
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        tokens = torch.as_tensor(prompt_tokens, device=self.device).long()
        params = tfm.cast_params(self.params, self.cfg)
        t0 = time.perf_counter()
        logits, cache = self._prefill(params, tokens)
        cache = pad_cache(self.cfg, cache, self._capacity(tokens.shape[1], steps, cache.entries[0][0].shape[2]))
        tok = sampler(logits, generator)
        self._sync()
        t1 = time.perf_counter()
        out = [tok]
        if cuda_graph and sampler is greedy and self.device.type == "cuda" and steps > 2:
            out += self._decode_graphed(params, tok, cache, steps - 1)
        else:
            for _ in range(steps - 1):
                logits, cache = self._step(params, tok, cache)
                tok = sampler(logits, generator)
                out.append(tok)
        self._sync()
        self.prefill_s, self.decode_s = t1 - t0, time.perf_counter() - t1
        return torch.stack(out, dim=1)


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
        if cfg.family != "seq2seq":
            raise NotImplementedError(
                f"the continuous engine serves the seq2seq family; its LM policies ({cfg.family!r}) are not ported "
                "yet (ROADMAP.md queue 1 item 5): use ServeEngine")
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
