"""Training launcher of the port: the paper's seq2seq model on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --steps 200 --batch 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --smoke --device cpu

Weights are random, from the port's initializer and ``--seed``; batches come
from ``SyntheticMTTask`` through ``MTBatchIterator``, as in
``repro.launch.train``; the optimizer is Adam.  Prints the same config line and
``step N  loss ...  tok/s ...`` lines.  The JAX launcher's multi-device flags
(the hybrid layout, ROADMAP queue 4) and ``--ckpt-dir`` are not ported, so
argparse rejects them as unrecognized arguments.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import COMPUTE_DTYPES, STAGE_KERNELS, ExecutionPlan
from repro_torch.data import MTBatchIterator, SyntheticMTTask
from repro_torch.models import seq2seq as s2s
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.optim import adam
from repro_torch.train import Trainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seq2seq-rnn")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--micro-batches", type=int, default=1, help="microbatches per step (grad accumulation)")
    ap.add_argument("--stage-kernel", choices=STAGE_KERNELS, default="cuda",
                    help="LSTM cells and Luong head: the fused CUDA kernels (plain versions on a CPU) or plain torch")
    ap.add_argument("--compute-dtype", choices=COMPUTE_DTYPES, default=None,
                    help="activation compute dtype; params stay fp32 master weights (default: the config's dtype)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"--arch {args.arch}: not ported yet (ported: {', '.join(ARCH_IDS)})")
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    plan = ExecutionPlan(micro_batches=args.micro_batches, stage_kernel=args.stage_kernel,
                         compute_dtype=args.compute_dtype)
    plan.validate_batch(args.batch)

    params = s2s.init_seq2seq(args.seed, cfg, device=device)
    # repro.launch.train's task at its default --seq 64: sentences of 4-16 tokens
    task = SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=16)
    it = MTBatchIterator(task, batch_size=args.batch, seed=args.seed)
    trainer = Trainer(cfg, adam(lr=args.lr), it, plan=plan, params=params, seed=args.seed, device=device)

    n_params = sum(p.numel() for p in tree_leaves(params))
    mp_note = f" loss_scale={plan.loss_scale_init:g}" if plan.fp16(cfg) else ""
    print(
        f"arch={cfg.name} params={n_params/1e6:.1f}M micro_batches={args.micro_batches} "
        f"stage_kernel={plan.stage_kernel} compute_dtype={plan.resolve_compute_dtype(cfg)}{mp_note} device={device}"
    )
    trainer.run(args.steps, log_every=max(args.steps // 4, 1))
    return trainer


if __name__ == "__main__":
    main()
