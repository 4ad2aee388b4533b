"""Decoder-only transformer of the dense and MoE families (port of the
attention-block path of ``repro/models/transformer.py``): training, prefill
and decode.

Layers are grouped by the architecture's block pattern
(``cfg.layer_group``); each position in the group has its weights stacked
``[G, ...]`` with ``G = num_layers // layer_group``, as in the JAX package,
and the trunk is a Python loop over the groups (the JAX package scans).
Each stacked leaf is split into its G layers once per forward
(:func:`layer_weights`), so under autograd the layers' grads are stacked
once per leaf, not added into a zero stack once per layer.

Modes:
  train    full-sequence forward + CE loss (:func:`forward_train`): each
           layer group under ``torch.utils.checkpoint`` when ``ctx.remat``
           (the JAX package's ``jax.checkpoint`` per group), and the CE over
           sequence chunks, each checkpointed, so no [B, S, V] fp32 logits
           are stored (:func:`chunked_ce`)
  prefill  full-sequence forward; emits each layer's KV cache
  decode   one token (or a chunk) against the carried caches, which it
           updates in place

A block's FFN is the dense MLP or, on the layers ``cfg.is_moe_layer``
names, the mixture of experts (``models/moe.py``), whose load-balance loss
the trunk sums in train mode.

Training on a grid of ranks (``RunCtx.grid``): each rank runs its rows of
the batch.  On the tensor-parallel layouts (``RunCtx.sharding``: MODEL,
HYBRID and HYBRID_OPT, each leaf placed by the JAX rule, :func:`param_specs`)
the residual stream is whole on every ``model`` rank, and so is its grad:
attention runs on the rank's q heads (and the kv heads they read), the MLP
on its block of ``ff``, each entered through ``strategy.copy_to_model`` (the
grad all-reduced over ``model``) and left through
``strategy.sum_from_model`` (the partial outputs summed in fp32); the
FSDP blocks of HYBRID_OPT are gathered over ``data`` a layer at a time.
The MoE is expert-parallel (``RunCtx.ep_axis``) on every layout but DATA:
each ``model`` rank takes its block of the tokens and the outputs are
gathered back; under DATA it keeps the global dispatch.  The SSM/xLSTM
blocks, cross-attention and frontends are not ported yet.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import strategy as stg
from repro_torch.models import attention as attn
from repro_torch.models import common, mlp, moe
from repro_torch.models.common import Initializer, resolve_device, tree_map

MODES = ("train", "prefill", "decode")


class RunCtx(NamedTuple):
    mode: str  # "train" | "prefill" | "decode"
    window: Optional[int] = None  # sliding window
    q_chunk: int = 1024
    kv_chunk: int = 1024
    # "cuda": train/prefill attention on kernels/flash_attn and the MoE
    # blocks' expert FFN on kernels/moe_gemm (each the CUDA kernel on the
    # card, its plain version on the host; both differentiable); "torch":
    # chunked_attention and moe.expert_ffn
    kernel: str = "cuda"
    remat: bool = True  # train: recompute each layer group in the backward
    # train on a grid: the ProcessGrid whose ranks hold blocks of the batch (None: one process)
    grid: Any = None
    # the tensor-parallel layouts: the rank's strategy.Sharding (its blocks' placement and gathers)
    sharding: Any = None
    ep_axis: Optional[str] = None  # the grid axis carrying the experts: the expert-parallel MoE
    # the grid axis over which the ranks' losses are terms of the step's (None: every rank's is whole)
    loss_axis: Optional[str] = None


# ---------------------------------------------------------------------------
# block pattern and init
# ---------------------------------------------------------------------------


def block_pattern(cfg: ModelConfig) -> list:
    """Kinds for each position in a layer group; the dense and MoE families
    have only 'attn' blocks (the SSM and xLSTM kinds come with their
    families)."""
    kinds = []
    for pos in range(cfg.layer_group):
        if not cfg.is_attn_layer(pos):
            raise NotImplementedError(f"{cfg.name}: non-attention blocks are not ported yet "
                                      "(ROADMAP queue 1 item 6(c))")
        kinds.append("attn")
    return kinds


def init_block(ini: Initializer, path: str, cfg: ModelConfig, kind: str, use_moe: bool = False) -> dict:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (ROADMAP queue 1 item 6(c))")
    p = {
        "norm1": common.init_norm(ini, path + ".n1", cfg.d_model, cfg.norm),
        "attn": attn.init_attention(ini, path + ".attn", cfg),
        "norm2": common.init_norm(ini, path + ".n2", cfg.d_model, cfg.norm),
    }
    if use_moe:
        p["moe"] = moe.init_moe(ini, path + ".moe", cfg.d_model, cfg.moe, cfg.gated_mlp)
    elif cfg.d_ff:
        p["mlp"] = mlp.init_mlp(ini, path + ".mlp", cfg.d_model, cfg.d_ff, cfg.gated_mlp)
    return p


def init_lm(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random fp32 parameters with the JAX package's names, layouts and
    scales; blocks stacked [G, ...] per position in the layer group."""
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(f"the {cfg.family!r} family's LM is not ported yet")
    if cfg.learned_pos_emb:
        raise NotImplementedError("learned position embeddings come with the audio family (ROADMAP queue 1 item 6(d))")
    ini = Initializer(seed, device=resolve_device(device))
    G = cfg.num_layers // cfg.layer_group
    params: dict = {"embed": common.init_embedding(ini, "embed", cfg.vocab_size, cfg.emb_size)}
    blocks = []
    for pos, kind in enumerate(block_pattern(cfg)):
        use_moe = cfg.is_moe_layer(pos)
        trees = [init_block(ini, f"blk.g{g}.p{pos}", cfg, kind, use_moe) for g in range(G)]
        blocks.append(tree_map(lambda *xs: torch.stack(xs), *trees))
        del trees
    params["blocks"] = blocks
    params["final_norm"] = common.init_norm(ini, "fn", cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": ini.normal("lm_head", (cfg.d_model, cfg.vocab_size))}
    return params


class _Shapes:
    """An initializer that returns each parameter's shape instead of its
    values (:func:`param_shapes`)."""

    def normal(self, path, shape, scale=None):
        return tuple(shape)

    embedding = zeros = ones = normal


def param_shapes(cfg: ModelConfig) -> dict:
    """The whole shape of every parameter of :func:`init_lm`, in its tree
    (leaves are tuples), without allocating any."""
    ini = _Shapes()
    G = cfg.num_layers // cfg.layer_group
    stack = lambda node: ({k: stack(v) for k, v in node.items()} if isinstance(node, dict)  # noqa: E731
                          else (G,) + node)
    tree: dict = {"embed": common.init_embedding(ini, "embed", cfg.vocab_size, cfg.emb_size)}
    tree["blocks"] = [stack(init_block(ini, f"blk.p{pos}", cfg, kind, cfg.is_moe_layer(pos)))
                      for pos, kind in enumerate(block_pattern(cfg))]
    tree["final_norm"] = common.init_norm(ini, "fn", cfg.d_model, cfg.norm)
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": (cfg.d_model, cfg.vocab_size)}
    return tree


def block_specs(cfg: ModelConfig, kind: str, use_moe: bool = False) -> dict:
    """The logical spec tree of one :func:`init_block`."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (ROADMAP queue 1 item 6(c))")
    s = {"norm1": common.norm_specs(cfg.norm), "attn": attn.attention_specs(cfg), "norm2": common.norm_specs(cfg.norm)}
    if use_moe:
        s["moe"] = moe.moe_specs(cfg.gated_mlp)
    elif cfg.d_ff:
        s["mlp"] = mlp.mlp_specs(cfg.gated_mlp)
    return s


def param_specs(cfg: ModelConfig) -> dict:
    """The logical spec tree of :func:`init_lm`'s parameters (leaves: a
    tuple of logical dim names, None for a dim no rule shards), the stacked
    blocks' with ``"layers"`` first: what ``repro/models/transformer.py::
    init_lm`` returns beside the parameters."""
    stack = lambda node: ({k: stack(v) for k, v in node.items()} if isinstance(node, dict)  # noqa: E731
                          else ("layers",) + node)
    tree: dict = {"embed": dict(common.EMBEDDING_SPECS)}
    tree["blocks"] = [stack(block_specs(cfg, kind, cfg.is_moe_layer(pos))) for pos, kind in enumerate(block_pattern(cfg))]
    tree["final_norm"] = common.norm_specs(cfg.norm)
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"w": ("embed", "vocab")}
    return tree


# the leaves whose grad every ``model`` rank computes whole on the tensor-parallel layouts: each acts on
# activations every rank holds whole (the norms, the MLP's output bias after the sum); every other leaf
# that ``model`` does not shard reads the rank's own heads, tokens or rows
WHOLE_ON_MODEL = ("norm1", "norm2", "final_norm", "bo")


def grad_whole_on_model(path: tuple) -> bool:
    """Whether the leaf at ``path`` (a key path of :func:`init_lm`'s tree)
    has its grad whole on every ``model`` rank of a tensor-parallel step."""
    return any(k in WHOLE_ON_MODEL for k in path)


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    """The activations' dtype: bf16 when the config says so, else fp32 (the
    JAX package's rule in ``forward_prefill``/``forward_decode``)."""
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """The parameters as the forward reads them: the attention, MLP and
    expert weights cast once to the compute dtype; the norm scales (qk-norm
    too), the MoE router, the embedding table and the LM head stay fp32, as
    the model reads them in fp32.  The model code's own casts then become
    no-ops, so the numbers are those of the fp32 masters cast at each use."""
    dt = compute_dtype(cfg)
    keep = ("q_norm", "k_norm", "router")
    out = dict(params)
    out["blocks"] = [
        {name: ({k: (a if k in keep else a.to(dt)) for k, a in sub.items()} if name in ("attn", "mlp", "moe")
                else sub)
         for name, sub in blk.items()}
        for blk in params["blocks"]
    ]
    return out


# ---------------------------------------------------------------------------
# one block
# ---------------------------------------------------------------------------


def _self_attention(p: dict, cfg: ModelConfig, x, ctx: RunCtx, cache, rope, length):
    """cache: None (train, prefill) or (k [B,C,KV,D], v) (decode); ``rope``:
    the positions' (cos, sin) tables; ``length`` is the absolute position of
    the incoming token(s).  Returns (y, cache_kv); train mode keeps no cache
    (None).  With ``ctx.sharding``: this rank's heads, the output summed over
    ``model``."""
    sh, kv = ctx.sharding, None
    if sh is not None:
        x = stg.copy_to_model(x, sh.grid, sh.axis)
        kv = attn.kv_block(p, cfg, sh.grid.index(sh.axis))
    q, k, v = attn.project_qkv(p, cfg, x, kv)
    q = common.apply_rope_tables(q, rope, head_ndims=2)
    k = common.apply_rope_tables(k, rope)
    if ctx.mode == "decode":
        ck, cv = cache
        rolling = ctx.window is not None and ck.shape[1] == ctx.window
        if rolling and x.shape[1] > 1:
            # a chunk on a rolling buffer: attend to the pre-write buffer ++
            # the chunk (its write evicts slots earlier queries still need)
            o = attn.decode_attention_concat(q, ck, cv, k, v, length)
            attn.cache_update(ck, cv, k, v, length, rolling)
        else:
            attn.cache_update(ck, cv, k, v, length, rolling)
            o = attn.decode_attention(q, ck, cv, length, rolling=rolling)
        return attn.output_proj(p, cfg, o), (ck, cv)
    o = attn.attend(q, k, v, causal=True, window=ctx.window, q_chunk=ctx.q_chunk, kv_chunk=ctx.kv_chunk,
                    kernel=ctx.kernel)
    y = attn.output_proj(p, cfg, o)
    if sh is not None:
        y = stg.sum_from_model(y, sh.grid, sh.axis)
    if ctx.mode == "train":
        return y, None
    W = ctx.window
    if W is not None and k.shape[1] > W:  # keep only the rolling window:
        S = k.shape[1]  # slot s holds the position p with p % W == s
        order = torch.argsort(torch.arange(S - W, S, device=k.device) % W)
        k, v = k[:, S - W :][:, order], v[:, S - W :][:, order]
    return y, (k, v)


def _ffn(p_block: dict, cfg: ModelConfig, x, ctx: RunCtx):
    """Dense MLP or MoE.  Returns (y, aux_loss).  With ``ctx.sharding`` the
    MLP runs on this rank's block of ``ff``; with ``ctx.ep_axis`` the MoE is
    expert-parallel on this rank's block of the tokens, the outputs gathered
    back whole."""
    sh = ctx.sharding
    if "mlp" in p_block:
        if sh is None:
            return mlp.apply_mlp(p_block["mlp"], x, cfg.act, cfg.gated_mlp), 0.0
        return mlp.apply_mlp(p_block["mlp"], stg.copy_to_model(x, sh.grid, sh.axis), cfg.act, cfg.gated_mlp,
                             reduce=lambda y: stg.sum_from_model(y, sh.grid, sh.axis)), 0.0
    if "moe" not in p_block:
        return torch.zeros_like(x), 0.0
    B, S, d = x.shape
    x2 = x.reshape(B * S, d)
    if ctx.ep_axis is None:
        y, aux = moe.apply_moe(p_block["moe"], x2, cfg.moe, cfg.act, kernel=ctx.kernel, grid=ctx.grid,
                               loss_axis=ctx.loss_axis)
        return y.reshape(B, S, d), aux
    grid, axis = ctx.grid, ctx.ep_axis
    if (B * S) % grid.size(axis):
        raise ValueError(f"{B * S} tokens of a data shard do not split into {grid.size(axis)} blocks over {axis!r}")
    y, aux = moe.apply_moe_ep(p_block["moe"], stg.split_rows(x2, grid, axis), cfg.moe, cfg.act, grid, axis,
                              loss_axis=ctx.loss_axis, kernel=ctx.kernel)
    return stg.gather_rows(y, grid, axis).reshape(B, S, d), aux


def apply_block(kind: str, p: dict, cfg: ModelConfig, x, ctx: RunCtx, cache, rope, length=None):
    """Returns (x, new_cache, aux): ``aux`` is the MoE load-balance loss of
    this block (0.0 for a dense one); ``rope`` is :func:`common.rope_tables`
    of the tokens' positions."""
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not ported yet (ROADMAP queue 1 item 6(c))")
    h = common.apply_norm(p["norm1"], x, cfg.norm)
    y, new_cache = _self_attention(p["attn"], cfg, h, ctx, cache, rope, length)
    x = x + y
    h2 = common.apply_norm(p["norm2"], x, cfg.norm)
    y2, aux = _ffn(p, cfg, h2, ctx)
    return x + y2, new_cache, aux


# ---------------------------------------------------------------------------
# cache + trunk
# ---------------------------------------------------------------------------


class LMCache(NamedTuple):
    """Stacked per-group caches: one (k [G,B,C,KV,D], v) per position in the
    layer group; ``length`` is the absolute position count, a 0-d int64
    tensor on the cache's device (so a captured decode step reads it there)."""

    entries: tuple
    length: torch.Tensor


def init_cache(cfg: ModelConfig, batch: int, capacity: int, window: Optional[int] = None, *, device="cuda",
               dtype: torch.dtype = torch.bfloat16) -> LMCache:
    G = cfg.num_layers // cfg.layer_group
    C = min(capacity, window) if window else capacity
    dev = resolve_device(device)
    entries = []
    for _ in block_pattern(cfg):
        shape = (G, batch, C, cfg.num_kv_heads, cfg.head_dim)
        entries.append((torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev)))
    return LMCache(entries=tuple(entries), length=torch.zeros((), dtype=torch.int64, device=dev))


def layer_weights(blocks: list, G: int) -> list:
    """The stacked [G, ...] weights of each position in the layer group as
    G per-layer trees ([g][pos] -> weights): one ``torch.unbind`` per leaf,
    whose backward stacks the G layers' grads once (indexing ``a[g]`` per
    layer would add each layer's grad into a zero stack of the whole leaf)."""
    per_pos = [tree_map(lambda a: torch.unbind(a, 0), blk) for blk in blocks]

    def take(node, g):
        if isinstance(node, dict):
            return {k: take(v, g) for k, v in node.items()}
        return node[g]

    return [[take(tree, g) for tree in per_pos] for g in range(G)]


def _gathered(sh, tree: dict, placed: dict, stacked: bool = False) -> dict:
    """``tree`` with each leaf gathered whole over ``data`` (its FSDP
    blocks; ``model`` blocks kept), ``placed`` its placement (``stacked``:
    a layer of the stacked blocks, whose placements lead with the layer
    dim)."""
    return {k: (_gathered(sh, v, placed[k], stacked) if isinstance(v, dict)
                else sh.gather(v, placed[k][1:] if stacked else placed[k], keep=(sh.axis,)))
            for k, v in tree.items()}


def _train_group(kinds: list, cfg: ModelConfig, ctx: RunCtx, rope, x, weights: list):
    """One layer group in train mode: (x, summed aux).  With ``ctx.sharding``
    each layer's FSDP blocks are gathered here, so the recompute gathers
    them again and no whole layer outlives its use."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    sh = ctx.sharding
    if sh is not None:
        weights = [_gathered(sh, w, placed, stacked=True) for w, placed in zip(weights, sh.placement["blocks"])]
    for pos, kind in enumerate(kinds):
        x, _, a = apply_block(kind, weights[pos], cfg, x, ctx, None, rope)
        aux = aux + a
    return x, aux


def run_trunk(params: dict, cfg: ModelConfig, x, ctx: RunCtx, cache: Optional[LMCache], positions):
    """x [B,S,d] -> (x, new_cache, aux).  Train mode sums the blocks' MoE
    load-balance losses into ``aux`` (fp32; 0 for a dense model), each layer
    group checkpointed when ``ctx.remat``; prefill builds the caches
    (``cache`` is an empty LMCache, or None for no caches); decode consumes
    ``cache`` and writes its entries in place."""
    if ctx.mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {ctx.mode!r}")
    kinds = block_pattern(cfg)
    G = cfg.num_layers // cfg.layer_group
    rope = common.rope_tables(positions, cfg.head_dim, cfg.rope_theta, cfg.partial_rotary)
    layers = layer_weights(params["blocks"], G)
    if ctx.mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in range(G):
            if ctx.remat:
                # the forward draws no random numbers: no RNG state to keep for the recompute
                x, a = checkpoint(_train_group, kinds, cfg, ctx, rope, x, layers[g], use_reentrant=False,
                                  preserve_rng_state=False)
            else:
                x, a = _train_group(kinds, cfg, ctx, rope, x, layers[g])
            aux = aux + a
        return x, None, aux
    consume = cache is not None and ctx.mode == "decode"
    length = cache.length if cache is not None else None
    built = [[] for _ in kinds]
    for g in range(G):
        for pos, kind in enumerate(kinds):
            layer_cache = (cache.entries[pos][0][g], cache.entries[pos][1][g]) if consume else None
            x, nc, _ = apply_block(kind, layers[g][pos], cfg, x, ctx, layer_cache, rope, length)
            if not consume:
                built[pos].append(nc)
    if cache is None:
        return x, None, None
    if consume:
        return x, LMCache(entries=cache.entries, length=cache.length), None
    entries = tuple((torch.stack([kv[0] for kv in col]), torch.stack([kv[1] for kv in col])) for col in built)
    return x, LMCache(entries=entries, length=cache.length), None


# ---------------------------------------------------------------------------
# heads and top-level forwards
# ---------------------------------------------------------------------------


def lm_head_weight(params: dict, cfg: ModelConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["table"].T
    return params["lm_head"]["w"]


def _ce_chunk(head_w, xc, lc, mc):
    """Summed masked NLL of one sequence chunk, logits in fp32."""
    logits = common.unembed(head_w, xc)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return ((lse - gold) * mc.float()).sum()


def chunked_ce(x, head_w, labels, mask, chunk: int = 1024, total=None):
    """Masked-mean CE of x [B,S,d] through the head [d,V] -> (loss, denom),
    without storing [B,S,V] fp32 logits for the whole sequence: the sequence
    is cut into the smallest number of equal chunks of at most ``chunk``
    positions (S need not be a multiple of ``chunk``), and each chunk's
    logits are recomputed in the backward (the JAX package's rule).
    ``total`` maps the token count to the one the mean divides by (a sum
    over the ranks that hold the other rows)."""
    B, S, _ = x.shape
    if S <= chunk:
        return common.softmax_cross_entropy(common.unembed(head_w, x), labels, mask, total=total)
    n = -(-S // chunk)
    while S % n:
        n += 1
    c = S // n
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        part = slice(i * c, (i + 1) * c)
        tot = tot + checkpoint(_ce_chunk, head_w, x[:, part], labels[:, part], mask[:, part], use_reentrant=False,
                               preserve_rng_state=False)
        cnt = cnt + mask[:, part].float().sum()
    denom = torch.clamp(cnt if total is None else total(cnt), min=1.0)
    return tot / denom, denom


def _count_total(grid, axis):
    """The token count summed over ``axis`` (no grad), or None for none."""
    if axis is None:
        return None

    def total(count):
        count = count.detach().clone()
        grid.all_reduce(count, axis).wait()
        return count

    return total


def _vocab_parallel_ce(x, head_w, labels, mask, sh, total, chunk: int = 1024):
    """:func:`chunked_ce` with the head's vocab sharded over ``model``
    (``head_w`` [d, V/M], this rank's block): each sequence chunk's logits
    block through ``strategy._VocabParallelCEFn`` (the row max, the sum of
    exponentials and the target's logit all-reduced over ``model``),
    recomputed in the backward.  ``x`` enters the column-parallel head
    through ``strategy.copy_to_model``.  Returns (this rank's share of the
    masked mean, the same on every ``model`` rank; denom)."""
    count = mask.float().sum()
    denom = torch.clamp(count if total is None else total(count), min=1.0)
    x = stg.copy_to_model(x, sh.grid, sh.axis)
    S = x.shape[1]
    n = -(-S // chunk)
    while S % n:
        n += 1
    c = S // n

    def part(xc, lc, mc):
        return stg._VocabParallelCEFn.apply(common.unembed(head_w, xc), lc, mc, denom, sh.grid, sh.axis)

    loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        cut = slice(i * c, (i + 1) * c)
        loss = loss + checkpoint(part, x[:, cut], labels[:, cut], mask[:, cut], use_reentrant=False,
                                 preserve_rng_state=False)
    return loss, denom


def _train_head(params: dict, cfg: ModelConfig, x, labels, mask, ctx: RunCtx, phase_boundary):
    """The normed final hidden states through the phase boundary and the LM
    head: (this rank's share of the masked-mean CE, denom).  Rows left whole
    on every ``model`` rank meet the head's vocab block (MODEL, HYBRID_OPT:
    the vocab-parallel CE); rows spread over the ranks (HYBRID) meet the
    whole head, a tied table gathered (its grad reduce-scattered)."""
    sh = ctx.sharding
    total = _count_total(ctx.grid, ctx.loss_axis)
    if phase_boundary is not None:
        x, labels, mask = phase_boundary(x), phase_boundary.rows(labels), phase_boundary.rows(mask)
    if sh is None:
        return chunked_ce(x, lm_head_weight(params, cfg), labels, mask, total=total)
    tied = cfg.tie_embeddings
    placed = sh.placement["embed"]["table"] if tied else sh.placement["lm_head"]["w"]
    head_w = params["embed"]["table"] if tied else params["lm_head"]["w"]
    if sh.grid.size(sh.axis) > 1 and not (phase_boundary is not None and phase_boundary.splits_rows):
        head_w = sh.gather(head_w, placed, keep=(sh.axis,))
        return _vocab_parallel_ce(x, head_w.T if tied else head_w, labels, mask, sh, total)
    head_w = sh.gather(head_w, placed)
    return chunked_ce(x, head_w.T if tied else head_w, labels, mask, total=total)


def forward_train(params: dict, cfg: ModelConfig, tokens, labels, mask, *, ctx: RunCtx = RunCtx(mode="train"),
                  phase_boundary=None):
    """tokens, labels, mask [B, S] -> (loss, {"denom", "aux", "ce"}): the
    masked-mean next-token CE (fp32 logits), plus, for an MoE model,
    ``router_aux_weight`` times the load-balance loss summed over the layers
    and divided by the number of layer groups.

    On a grid (``ctx.grid``) the batch is this rank's rows and the loss its
    share: the CE over its rows divided by the whole batch's token count
    (summed over ``ctx.loss_axis``), and the load-balance term, whole on
    every rank, divided by the rank count of ``ctx.loss_axis``, so the
    ranks' losses sum to the whole batch's once.  ``phase_boundary``
    (``strategy.lm_phase_boundary``) maps the normed final hidden states,
    and with ``.rows`` the labels and mask, to the rows the head runs on."""
    if ctx.mode != "train":
        raise ValueError(f"forward_train runs in mode 'train', got {ctx.mode!r}")
    sh = ctx.sharding
    if sh is None:
        x = common.embed(params["embed"], tokens, compute_dtype(cfg))
        final_norm = params["final_norm"]
    else:
        x = sh.embed("embed", params["embed"]["table"], tokens, compute_dtype(cfg), reduce_grad=False)
        final_norm = _gathered(sh, params["final_norm"], sh.placement["final_norm"])
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, _, aux = run_trunk(params, cfg, x, ctx, None, positions)
    x = common.apply_norm(final_norm, x, cfg.norm)
    if ctx.grid is None:
        ce, denom = chunked_ce(x, lm_head_weight(params, cfg), labels, mask)
    else:
        ce, denom = _train_head(params, cfg, x, labels, mask, ctx, phase_boundary)
    loss = ce
    if cfg.moe is not None:
        share = 1 if ctx.loss_axis is None else ctx.grid.size(ctx.loss_axis)
        loss = loss + cfg.moe.router_aux_weight * aux / max(cfg.num_layers // cfg.layer_group, 1) / share
    return loss, {"denom": denom, "aux": aux, "ce": ce}


def forward_prefill(params: dict, cfg: ModelConfig, tokens, *, ctx: RunCtx = RunCtx(mode="prefill")):
    """tokens [B, S] -> (logits at the last position [B, V] fp32, cache)."""
    x = common.embed(params["embed"], tokens, compute_dtype(cfg))
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    x, cache, _ = run_trunk(params, cfg, x, ctx, LMCache(entries=(), length=None), positions)
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    logits = common.unembed(lm_head_weight(params, cfg), x[:, -1:])[:, 0]
    return logits, cache._replace(length=torch.tensor(S, device=x.device))


def forward_decode(params: dict, cfg: ModelConfig, token, cache: LMCache, *, ctx: RunCtx = RunCtx(mode="decode"),
                   all_positions: bool = False):
    """One token ([B]) or a chunk ([B, s]) against the cache, whose entries
    are written in place (no host synchronisation: the step can be captured
    in a CUDA graph).  Returns (logits at the last position [B, V], or at
    every position [B, s, V] with ``all_positions``; the cache with length
    advanced by s)."""
    tokens = token if token.dim() == 2 else token[:, None]
    s = tokens.shape[1]
    x = common.embed(params["embed"], tokens, compute_dtype(cfg))
    positions = (cache.length + torch.arange(s, device=x.device))[None, :]
    x, new_cache, _ = run_trunk(params, cfg, x, ctx, cache, positions)
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    head = lm_head_weight(params, cfg)
    logits = common.unembed(head, x) if all_positions else common.unembed(head, x[:, -1:])[:, 0]
    return logits, LMCache(entries=new_cache.entries, length=cache.length + s)
