"""Serving launcher of the port: plan-driven continuous batching of the
paper's seq2seq model on the card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch seq2seq-rnn
    PYTHONPATH=src python -m repro_torch.launch.serve --arch seq2seq-rnn --smoke --device cpu

Weights are random, from the port's initializer and ``--seed``; requests
are random sources of length ``prompt-len/2 .. prompt-len``.  Prints the
summary line of ``repro.launch.serve``:
``[<name> | encdec_memory | <admission>] N requests, M tokens in Xs (Y tok/s)``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import ADMISSIONS, STAGE_KERNELS, ServePlan
from repro_torch.models import seq2seq as s2s
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.sampling import make_sampler


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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stage-kernel", choices=STAGE_KERNELS, default="cuda")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"--arch {args.arch}: not ported yet (ported: {', '.join(ARCH_IDS)})")
    cfg = get_config(args.arch, smoke=args.smoke)
    rng = np.random.default_rng(args.seed)
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


if __name__ == "__main__":
    main()
