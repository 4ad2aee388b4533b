"""The paper's model: Luong-attention Seq2Seq stacked-LSTM MT
(Ono et al. 2019, Figures 1 & 3; port of ``repro/models/seq2seq.py``).

The attention-softmax head computes, for decoder states H against the
encoder states S::

    alpha = softmax(H^T W_a S)          (paper eq. 1-2)
    C     = alpha . S                   (eq. 3)
    Hc    = tanh(W_c [H; C])            (eq. 4)
    P     = softmax(F_c Hc)             (eq. 5)

Training has two forwards.  ``forward_no_input_feeding`` (HybridNMT, Fig. 3)
runs the backbone phase (all encoder states S and all decoder states H under
teacher forcing), then the head over all steps at once.  ``forward_input_feeding``
(baseline / HybridNMTIF, Fig. 1) feeds Hc_{t-1} into the first decoder
layer, so the decoder is one serial loop with the head inside it.

Serving keeps the encoder states S of each request as its cached
"memory" (``encdec_memory``): ``encode_extend`` is the chunked prefill,
``decode_step`` one decoder-LSTM step plus the head.  Every leaf of a
:class:`Seq2SeqCache` carries the batch (slot) dimension first, the
per-row ``length`` included, so a batch of independent requests decodes
in one call where the JAX engine ``vmap``s over slots.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lstm
from repro_torch.models.common import (
    Initializer,
    resolve_device,
    resolve_dtype,
    softmax_cross_entropy,
    tree_map,
)

STAGE_KERNELS = ("torch", "cuda")


class Seq2SeqBatch(NamedTuple):
    src: torch.Tensor  # [B, M] int
    tgt_in: torch.Tensor  # [B, N] int (BOS-shifted)
    tgt_out: torch.Tensor  # [B, N] int (labels)
    src_mask: torch.Tensor  # [B, M] bool
    tgt_mask: torch.Tensor  # [B, N] bool


def init_seq2seq(seed: int, cfg: ModelConfig, *, device="cuda") -> dict:
    """Random fp32 parameters with the JAX package's names, layouts and
    scales (values differ from JAX's: see ``Initializer``)."""
    ini = Initializer(seed, device=resolve_device(device))
    h, e, v = cfg.d_model, cfg.emb_size, cfg.vocab_size
    dec_in = e + (h if cfg.input_feeding else 0)
    return {
        "src_emb": {"table": ini.embedding("src_emb", (v, e))},
        "tgt_emb": {"table": ini.embedding("tgt_emb", (v, e))},
        "encoder": lstm.init_stacked_lstm(ini, "enc", cfg.num_layers, e, h),
        "decoder": lstm.init_stacked_lstm(ini, "dec", cfg.num_layers, dec_in, h),
        # attention-softmax head (the paper's data-parallel part)
        "head": {
            "w_alpha": ini.normal("w_alpha", (h, h)),
            "w_c": ini.normal("w_c", (2 * h, h)),
            "f_c": ini.normal("f_c", (h, v)),
        },
    }


def param_specs(num_layers: int) -> dict:
    """The logical spec tree of :func:`init_seq2seq`'s parameters at
    ``num_layers`` layers a side (each leaf a tuple of logical dim names,
    None for a dim no rule shards), as ``repro/models/seq2seq.py:51-66`` and
    ``repro/models/lstm.py:22-32`` return it beside the parameters."""
    cell = {"wx": ("embed", None, "qdim"), "wh": ("embed", None, "qdim"), "b": (None, "qdim")}
    return {
        "src_emb": {"table": ("vocab", "embed")},
        "tgt_emb": {"table": ("vocab", "embed")},
        "encoder": [dict(cell) for _ in range(num_layers)],
        "decoder": [dict(cell) for _ in range(num_layers)],
        "head": {"w_alpha": ("embed", "embed"), "w_c": ("ff", "embed"), "f_c": ("embed", "vocab")},
    }


def param_shapes(cfg: ModelConfig) -> dict:
    """The whole shape of every parameter of :func:`init_seq2seq`, in its tree."""
    h, e, v = cfg.d_model, cfg.emb_size, cfg.vocab_size
    dec_in = e + (h if cfg.input_feeding else 0)

    def cell(in_dim):
        return {"wx": (in_dim, 4, h), "wh": (h, 4, h), "b": (4, h)}

    return {
        "src_emb": {"table": (v, e)},
        "tgt_emb": {"table": (v, e)},
        "encoder": [cell(e if li == 0 else h) for li in range(cfg.num_layers)],
        "decoder": [cell(dec_in if li == 0 else h) for li in range(cfg.num_layers)],
        "head": {"w_alpha": (h, h), "w_c": (2 * h, h), "f_c": (h, v)},
    }


def cast_params(params: dict, cfg: ModelConfig) -> dict:
    """The parameters as the serving path reads them: every weight cast once
    to the compute dtype, except the output projection ``f_c``, which eq. 5
    reads in fp32.  The model code's own casts then become no-ops, so the
    numbers are those of the fp32 masters cast at each use."""
    dt = resolve_dtype(cfg.dtype)
    out = tree_map(lambda a: a.to(dt), params)
    out["head"]["f_c"] = params["head"]["f_c"].float()
    return out


# ---------------------------------------------------------------------------
# attention-softmax phase (paper eq. 1-5)
# ---------------------------------------------------------------------------


def luong_head(head: dict, S, H, src_mask, *, stage_kernel: str = "torch"):
    """Eq. 1-4: S [B,M,h] encoder states, H [B,N,h] decoder states -> Hc
    [B,N,h] in H's dtype.

    ``stage_kernel="torch"`` runs the math below in the compute dtype (the
    JAX ``jnp`` branch); ``"cuda"`` sends it to the fused head
    ``kernels/luong_attn`` (the JAX ``pallas`` branch), which runs its CUDA
    kernel on the card.  The weights are cast to H's dtype here, at each
    call, as the JAX package casts them, so each call's weight grads reach the
    fp32 masters in fp32."""
    dt = H.dtype
    if stage_kernel == "cuda":
        from repro_torch.kernels.luong_attn.ops import luong_attention_fused

        return luong_attention_fused(H, S, src_mask, head["w_alpha"].to(dt), head["w_c"].to(dt))
    if stage_kernel != "torch":
        raise ValueError(f"stage_kernel must be one of {STAGE_KERNELS}, got {stage_kernel!r}")
    scores = torch.matmul(torch.matmul(H, head["w_alpha"].to(dt)), S.transpose(1, 2))
    scores = torch.where(src_mask[:, None, :] != 0, scores.float(), torch.full((), -1e30, device=H.device))
    alpha = torch.softmax(scores, dim=-1).to(dt)  # eq. 1-2
    C = torch.matmul(alpha, S)  # eq. 3
    return torch.tanh(torch.matmul(torch.cat([H, C], dim=-1), head["w_c"].to(dt)))  # eq. 4


def attention_softmax_head(head: dict, S, H, src_mask, *, stage_kernel: str = "torch"):
    """S [B,M,h] encoder states, H [B,N,h] decoder states -> (Hc [B,N,h],
    logits [B,N,V]): eq. 1-4 by :func:`luong_head`, then eq. 5 as a plain
    fp32 matmul on either ``stage_kernel``."""
    Hc = luong_head(head, S, H, src_mask, stage_kernel=stage_kernel)
    logits = torch.matmul(Hc.float(), head["f_c"].float())  # eq. 5
    return Hc, logits


# ---------------------------------------------------------------------------
# training forwards
# ---------------------------------------------------------------------------


def _embed(table: torch.Tensor, tokens: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Rows of the fp32 table in the compute dtype (gathered, then cast:
    the same values as casting the table first)."""
    return table[tokens.long()].to(dt)


def _embeddings(params: dict, batch: Seq2SeqBatch, dt: torch.dtype, sharding) -> tuple:
    """(source, target) embeddings [B, S, e] in the compute dtype: a lookup,
    or with ``sharding`` the lookup in this rank's vocab block."""
    if sharding is None:
        return _embed(params["src_emb"]["table"], batch.src, dt), _embed(params["tgt_emb"]["table"], batch.tgt_in, dt)
    return (sharding.embed("src_emb", params["src_emb"]["table"], batch.src, dt),
            sharding.embed("tgt_emb", params["tgt_emb"]["table"], batch.tgt_in, dt))


def _stacks(params: dict, sharding) -> tuple:
    """The encoder's and the decoder's layers: as stored, or with ``sharding``
    the column shards, gathered over data where FSDP shards them."""
    if sharding is None:
        return params["encoder"], params["decoder"]
    return sharding.layers("encoder", params["encoder"]), sharding.layers("decoder", params["decoder"])


def _phase_two(head: dict, S, H, batch: Seq2SeqBatch, *, stage_kernel: str, phase_boundary, sharding, total):
    """The reshard boundary and the data-parallel attention-softmax phase:
    eq. 1-5 over all steps and the masked cross-entropy -> (mean loss,
    {"logits", "denom"}).  See :func:`forward_no_input_feeding` for the hooks."""
    src_mask, tgt_out, tgt_mask = batch.src_mask, batch.tgt_out, batch.tgt_mask
    if phase_boundary is not None:
        S, H = phase_boundary(S), phase_boundary(H)
        src_mask, tgt_out, tgt_mask = (phase_boundary.rows(t) for t in (src_mask, tgt_out, tgt_mask))
    if S.shape[0] == 0:
        count = torch.zeros((), device=S.device)
        denom = torch.clamp(total(count) if total is not None else count, min=1.0)
        return (S.sum() + H.sum()).float() * 0.0, {"logits": None, "denom": denom}
    _, logits = attention_softmax_head(head, S, H, src_mask, stage_kernel=stage_kernel)
    if sharding is not None and sharding.vocab_parallel:
        loss, denom = sharding.cross_entropy(logits, tgt_out, tgt_mask, total=total)
    else:
        loss, denom = softmax_cross_entropy(logits, tgt_out, tgt_mask, total=total)
    return loss, {"logits": logits, "denom": denom}


def forward_no_input_feeding(
    params: dict,
    cfg: ModelConfig,
    batch: Seq2SeqBatch,
    *,
    generator: Optional[torch.Generator] = None,
    stage_kernel: str = "torch",
    phase_boundary: Optional[Callable] = None,
    backbone: Optional[Callable] = None,
    total: Optional[Callable] = None,
    sharding=None,
):
    """HybridNMT forward -> (mean loss, {"logits", "denom"}).
    ``stage_kernel`` selects both the LSTM cells and the head's eq. 1-4
    (``"cuda"``: the fused kernels).  ``generator`` drives inter-layer
    dropout (none without it).

    The multi-rank hooks (``ExecutionPlan`` supplies them): ``backbone``
    replaces how the stacked LSTMs run, mapping (layer params, embedded
    [B, S, e], generator) to hidden states [B, S, h] (the wavefront pipeline
    substitutes here); ``phase_boundary`` maps the backbone's S and H to this
    rank's head rows, and ``phase_boundary.rows`` the batch's masks and
    labels to the same rows; ``total`` maps this rank's token count to the
    grid's, so the loss is this rank's share of the single-process mean.  A
    rank with no head rows (a MODEL stage below the top) returns a zero loss
    that still reaches its backbone.  ``sharding`` (a
    ``core.strategy.Sharding``: the tensor-parallel layouts) holds the
    parameters as this rank's blocks: the embeddings are looked up in the
    rank's vocab block, the head's weights gathered for eq. 1-4, and with a
    vocab-sharded ``f_c`` eq. 5 and the loss run vocab-parallel."""
    dt = resolve_dtype(cfg.dtype)

    def run(ps, xs, gen):
        return lstm.run_stacked_lstm(ps, xs, dropout_p=cfg.dropout, generator=gen, stage_kernel=stage_kernel)[0]

    run = backbone or run
    src_e, tgt_e = _embeddings(params, batch, dt, sharding)
    enc, dec = _stacks(params, sharding)
    # ---- phase 1: model-parallel backbone (all hidden states) ----------
    S = run(enc, src_e, generator)  # [B, M, h]
    H = run(dec, tgt_e, generator)  # [B, N, h]
    # ---- phase 2: the reshard boundary, then the data-parallel head ----
    head = params["head"] if sharding is None else sharding.head(params["head"])
    return _phase_two(head, S, H, batch, stage_kernel=stage_kernel, phase_boundary=phase_boundary,
                      sharding=sharding, total=total)


def forward_input_feeding(
    params: dict,
    cfg: ModelConfig,
    batch: Seq2SeqBatch,
    *,
    generator: Optional[torch.Generator] = None,
    stage_kernel: str = "torch",
    total: Optional[Callable] = None,
    rows: Optional[tuple] = None,
    phase_boundary: Optional[Callable] = None,
    backbone: Optional[Callable] = None,
    sharding=None,
):
    """Baseline / HybridNMTIF forward: Hc_{t-1} joins the first decoder
    layer's input (Fig. 1), so the decoder runs step-major: every layer of
    step t, then eq. 1-4 of step t, then step t+1; eq. 1-5 then run once over
    all steps.  The last step's eq. 1-4 are not run: nothing reads their Hc
    (the JAX scan computes it and XLA drops it).  ``stage_kernel`` selects
    the cells (``"cuda"``: one ``lstm_cell`` launch per cell, the weights
    cast and packed once per call) and the head.  As in the JAX package,
    dropout applies to the encoder only.  On a batch-sharded grid ``total``
    sums the token count over the ranks and ``rows`` places this rank's rows
    in the batch for the dropout masks.

    On the tensor-parallel layouts the plan supplies the hooks of
    :func:`forward_no_input_feeding` (``backbone`` runs the encoder,
    ``phase_boundary`` and ``sharding`` the final eq. 1-5), and the decoder's
    cells are ``sharding``'s (``sharding.step_cells``: column shards, each
    cell followed by its all-gather of h).  Each step's eq. 1-4 then runs on
    this rank's row block of its data shard (``sharding.step_rows``), and
    one all-gather over ``model`` (``sharding.gather_rows``) gives every
    rank the whole Hc for the next step's input: the paper's head
    data-parallel per step."""
    dt = resolve_dtype(cfg.dtype)
    h = cfg.d_model
    B, N = batch.tgt_in.shape
    src_e, tgt_e = _embeddings(params, batch, dt, sharding)
    enc, dec = _stacks(params, sharding)
    if backbone is None:
        S = lstm.run_stacked_lstm(enc, src_e, dropout_p=cfg.dropout, generator=generator, stage_kernel=stage_kernel,
                                  rows=rows)[0]
    else:
        S = backbone(enc, src_e, generator)
    head = params["head"] if sharding is None else sharding.head(params["head"])  # gathered once per forward
    if sharding is None:
        cells, mine = lstm.StepCells(dec, dt, stage_kernel), (lambda t: t)
    else:
        cells, mine = sharding.step_cells(dec, dt, stage_kernel), sharding.step_rows
    S_rows, mask_rows = mine(S), mine(batch.src_mask)
    states = [cells.init_state(li, B, src_e.device) for li in range(len(dec))]
    hc = torch.zeros((B, h), dtype=dt, device=src_e.device)
    hs = []
    for t in range(N):
        hcur = torch.cat([tgt_e[:, t], hc], dim=-1)
        for li in range(len(dec)):
            states[li], hcur = cells(li, hcur, states[li])
        hs.append(hcur)
        if t == N - 1:
            break
        hc = luong_head(head, S_rows, mine(hcur)[:, None, :], mask_rows, stage_kernel=stage_kernel)[:, 0]
        if sharding is not None:
            hc = sharding.gather_rows(hc)
    H = torch.stack(hs, dim=1)  # [B, N, h]
    return _phase_two(head, S, H, batch, stage_kernel=stage_kernel, phase_boundary=phase_boundary,
                      sharding=sharding, total=total)


def forward(params: dict, cfg: ModelConfig, batch: Seq2SeqBatch, **kw):
    if cfg.input_feeding:
        return forward_input_feeding(params, cfg, batch, **kw)
    return forward_no_input_feeding(params, cfg, batch, **kw)


# ---------------------------------------------------------------------------
# serving path: encdec_memory cache
# ---------------------------------------------------------------------------


class Seq2SeqCache(NamedTuple):
    """Per-request serving state for the ``encdec_memory`` cache policy;
    every leaf's first dimension is the batch (slot) row."""

    memory: torch.Tensor  # [B, M_cap, h] encoder states written so far
    src_mask: torch.Tensor  # [B, M_cap] bool: which memory slots are real
    enc_states: tuple  # per-layer LSTMCellState, carried across encode chunks
    dec_states: tuple  # per-layer LSTMCellState
    hc: torch.Tensor  # [B, h] input-feeding carry (zeros when unused)
    length: torch.Tensor  # [B] int64: source positions encoded so far


def init_seq2seq_cache(cfg: ModelConfig, batch: int, capacity: int, *, device="cuda") -> Seq2SeqCache:
    dev = resolve_device(device)
    dt = resolve_dtype(cfg.dtype)
    h = cfg.d_model

    def states():
        return tuple(lstm.init_lstm_state(batch, h, dev) for _ in range(cfg.num_layers))

    return Seq2SeqCache(
        memory=torch.zeros((batch, capacity, h), dtype=dt, device=dev),
        src_mask=torch.zeros((batch, capacity), dtype=torch.bool, device=dev),
        enc_states=states(),
        dec_states=states(),
        hc=torch.zeros((batch, h), dtype=dt, device=dev),
        length=torch.zeros((batch,), dtype=torch.int64, device=dev),
    )


def encode_extend(params: dict, cfg: ModelConfig, src_chunk, cache: Seq2SeqCache, chunk_mask=None) -> Seq2SeqCache:
    """Chunked prefill: run the encoder over ``src_chunk`` [B, s] from the
    carried LSTM states and write the resulting states into each row's
    memory at its ``length``.  ``chunk_mask`` [B, s] marks real tokens
    (default all-real); padded positions still run through the LSTM but are
    masked out of the attention memory.  Returns a new cache; the input's
    tensors are not written."""
    dt = resolve_dtype(cfg.dtype)
    B, s = src_chunk.shape
    src_e = params["src_emb"]["table"].to(dt)[src_chunk]
    hs, enc_states = lstm.run_stacked_lstm(params["encoder"], src_e, states=list(cache.enc_states))
    if chunk_mask is None:
        chunk_mask = torch.ones((B, s), dtype=torch.bool, device=src_chunk.device)
    pos = cache.length[:, None] + torch.arange(s, device=cache.length.device)  # [B, s]
    memory = cache.memory.clone()
    memory.scatter_(1, pos[:, :, None].expand(B, s, memory.shape[2]), hs.to(memory.dtype))
    src_mask = cache.src_mask.clone()
    src_mask.scatter_(1, pos, chunk_mask.to(torch.bool))
    return cache._replace(memory=memory, src_mask=src_mask, enc_states=tuple(enc_states), length=cache.length + s)


def decode_step(params: dict, cfg: ModelConfig, token, cache: Seq2SeqCache, *, stage_kernel: str = "torch"):
    """One decode step for every row: embed ``token`` [B], advance the
    decoder LSTM cells, run the attention-softmax head against the cached
    memory.  Returns (logits [B, V] fp32, new cache)."""
    dt = resolve_dtype(cfg.dtype)
    emb = params["tgt_emb"]["table"].to(dt)[token]
    x = torch.cat([emb, cache.hc.to(dt)], dim=-1) if cfg.input_feeding else emb
    new_states = []
    hcur = x
    for p, st in zip(params["decoder"], cache.dec_states):
        st2, hcur = lstm.lstm_cell(p, hcur, st)
        new_states.append(st2)
    Hc, logits = attention_softmax_head(
        params["head"], cache.memory, hcur[:, None, :], cache.src_mask, stage_kernel=stage_kernel
    )
    return logits[:, 0], cache._replace(dec_states=tuple(new_states), hc=Hc[:, 0])


def greedy_decode(params: dict, cfg: ModelConfig, src, src_mask, max_len: int, bos: int, eos: int, *,
                  stage_kernel: str = "torch"):
    """Greedy search over the serving path (``encode_extend`` +
    ``decode_step``); returns [B, max_len] int64 tokens, ``eos`` after a
    row's first EOS."""
    B, M = src.shape
    cache = init_seq2seq_cache(cfg, B, M, device=src.device)
    cache = encode_extend(params, cfg, src, cache, chunk_mask=src_mask)
    tok = torch.full((B,), bos, dtype=torch.int64, device=src.device)
    done = torch.zeros((B,), dtype=torch.bool, device=src.device)
    out = []
    for _ in range(max_len):
        logits, cache = decode_step(params, cfg, tok, cache, stage_kernel=stage_kernel)
        nxt = torch.where(done, torch.full_like(tok, eos), torch.argmax(logits, dim=-1))
        done = done | (nxt == eos)
        out.append(nxt)
        tok = nxt
    return torch.stack(out, dim=1)
