"""Serving launcher of the port, on the card: plan-driven continuous
batching of the paper's seq2seq model, and the static-batch prefill +
decode loop of the dense and MoE LM families.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch seq2seq-rnn
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seq2seq-rnn --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --engine static
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --engine static --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --smoke --engine static --device cpu

Weights are random, from the port's initializer and ``--seed``.  The
continuous engine serves random sources of length ``prompt-len/2 ..
prompt-len`` and prints the summary line of ``repro.launch.serve``:
``[<name> | encdec_memory | <admission>] N requests, M tokens in Xs (Y tok/s)``.
The static engine generates ``--steps`` tokens for a batch of ``--batch``
random prompts of ``--prompt-len`` tokens and prints
``[<name> | <cache policy> | static] generated (B, steps) in Xs (Y tok/s); prefill Zs``.
The continuous engine's LM policies are not ported yet (ROADMAP.md queue 1
item 5): ``--engine continuous`` with an LM arch exits with that message.
An arch whose fp32 master weights and bf16 copy do not fit one card (the
full ``qwen3-moe-30b-a3b``: 122 GB + 60 GB) exits before anything is
allocated, with its reckoning: it needs the multi-device layout (ROADMAP.md
queue 4).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import ADMISSIONS, STAGE_KERNELS, ServePlan
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from repro_torch.serve.sampling import make_sampler

ONE_CARD_BYTES = 80 * 10**9  # an H100's device memory: the budget when serving on the host


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seq2seq-rnn")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4, help="number of requests")
    ap.add_argument("--prompt-len", type=int, default=32, help="longest source (requests vary down to half)")
    ap.add_argument("--steps", type=int, default=16, help="max new tokens per request")
    ap.add_argument("--max-slots", type=int, default=None, help="slot table size (default: --batch)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=None, help="per-slot source capacity")
    ap.add_argument("--admission", choices=ADMISSIONS, default="continuous")
    ap.add_argument("--engine", choices=("continuous", "static"), default="continuous")
    ap.add_argument("--window", type=int, default=None, help="rolling KV window (LM archs; default: the config's)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stage-kernel", choices=STAGE_KERNELS, default="cuda")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"--arch {args.arch}: not ported yet (ported: {', '.join(ARCH_IDS)})")
    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
    if cfg.family == "seq2seq" and args.engine == "static":
        raise SystemExit("the seq2seq arch serves through the continuous engine (--engine continuous)")
    if cfg.family != "seq2seq":
        if args.engine == "continuous":
            raise SystemExit(f"--arch {args.arch}: the continuous engine's LM policies are not ported yet "
                             "(ROADMAP.md queue 1 item 5); use --engine static")
        return _serve_static(args, cfg, rng)
    if args.window is not None:
        raise SystemExit("--window applies to LM archs")
    params = s2s.init_seq2seq(args.seed, cfg, device=args.device)
    plan = ServePlan.for_config(
        cfg,
        max_slots=args.max_slots or args.batch,
        max_len=args.max_len or max(64, args.prompt_len + args.steps),
        prefill_chunk=args.prefill_chunk,
        admission=args.admission,
        stage_kernel=args.stage_kernel,
    )
    engine = ContinuousEngine(cfg, params, plan, bos=1, eos=2)
    sampler = make_sampler(args.temperature)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=engine.device)
        generator.manual_seed(args.seed)
    lens = rng.integers(max(1, args.prompt_len // 2), args.prompt_len + 1, size=args.batch)
    prompts = [rng.integers(3, cfg.vocab_size, size=int(L)) for L in lens]
    t0 = time.perf_counter()
    outs = engine.run(prompts, args.steps, sampler=sampler, generator=generator)
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    tok = sum(len(o) for o in outs)
    print(f"[{cfg.name} | {plan.cache_policy} | {plan.admission}] {len(outs)} requests, "
          f"{tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    for o in outs[:2]:
        print(o.tolist())
    return outs


def _cast_count(cfg) -> int:
    """The parameters ``transformer.cast_params`` copies into the compute
    dtype on every generate: the attention, MLP and expert weights (not the
    embeddings, the norms or the router)."""
    d, n = cfg.d_model, cfg.param_count()
    n -= cfg.vocab_size * cfg.emb_size + (0 if cfg.tie_embeddings else cfg.vocab_size * d)
    n -= 2 * d * cfg.num_layers + d  # the norms
    return n - sum(d * cfg.moe.num_experts for i in range(cfg.num_layers) if cfg.is_moe_layer(i))


def _check_weights_fit(cfg, device) -> None:
    """Exit before any allocation when the fp32 master weights and the
    compute-dtype copy that each generate casts do not fit the device: the
    selected card's memory, or on the host one H100's, so that a host run
    fails where the card's would and never tries such an allocation."""
    n = cfg.param_count() + (cfg.num_layers * 2 * cfg.head_dim if cfg.qk_norm else 0)  # + the qk-norm scales
    itemsize = torch.finfo(tfm.compute_dtype(cfg)).bits // 8
    n_copy = _cast_count(cfg) if itemsize != 4 else 0  # cast_params to fp32 makes no copy
    need = 4 * n + itemsize * n_copy
    dev = resolve_device(device)
    cap = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else ONE_CARD_BYTES
    if need > cap:
        raise SystemExit(f"--arch {cfg.name}: its fp32 master weights are {n:,} parameters x 4 B = {4 * n / 1e9:.0f} "
                         f"GB and the {cfg.dtype} copy cast for each generate {n_copy:,} x {itemsize} B = "
                         f"{itemsize * n_copy / 1e9:.0f} GB: {need / 1e9:.0f} GB, more than the "
                         f"{'card' if dev.type == 'cuda' else 'one-card budget'}'s {cap / 1e9:.0f} GB; serving it "
                         "needs the weights spread over several cards (ROADMAP.md queue 4)")


def _serve_static(args, cfg, rng):
    """The dense and MoE LM families through the static-batch ServeEngine."""
    _check_weights_fit(cfg, args.device)
    overrides = dict(
        max_slots=args.max_slots or args.batch,
        max_len=args.max_len or max(64, args.prompt_len + args.steps),
        prefill_chunk=args.prefill_chunk,
        admission="static",
        stage_kernel=args.stage_kernel,
    )
    if args.window is not None:
        overrides.update(cache_policy="window", window=args.window)
    plan = ServePlan.for_config(cfg, **overrides)
    plan.validate_batch(args.batch)
    params = tfm.init_lm(args.seed, cfg, device=args.device)
    engine = ServeEngine(cfg, params, plan=plan, device=args.device)
    generator = None
    if args.temperature > 0:
        generator = torch.Generator(device=engine.device)
        generator.manual_seed(args.seed)
    prompts = rng.integers(3, cfg.vocab_size, size=(args.batch, args.prompt_len))
    t0 = time.perf_counter()
    out = engine.generate(prompts, args.steps, sampler=make_sampler(args.temperature), generator=generator)
    dt = time.perf_counter() - t0
    print(f"[{cfg.name} | {plan.cache_policy} | static] generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.steps / dt:.1f} tok/s); prefill {engine.prefill_s:.3f}s")
    for row in out[:2].tolist():
        print(row)
    return out


if __name__ == "__main__":
    main()
