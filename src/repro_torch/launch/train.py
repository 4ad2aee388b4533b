"""Training launcher of the port: the paper's seq2seq model, on one card or
on a grid of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --steps 200 --batch 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --smoke --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch seq2seq-rnn --smoke \
        --num-layers 4 --device cpu --strategy hybrid --pipeline --mesh test --micro-batches 2 --batch 16

Weights are random, from the port's initializer and ``--seed``; batches come
from ``SyntheticMTTask`` through ``MTBatchIterator``, as in
``repro.launch.train``; the optimizer is Adam.  Prints the same config line
and ``step N  loss ...  tok/s ...`` lines (rank 0 only on a grid).

The JAX launcher's multi-device flags: ``--strategy``, ``--mesh`` (``none``;
``test``, the 2 x 4 grid of ``make_test_mesh``, one process per rank under
``torchrun``; ``pod`` and ``multipod``, the TPU meshes, raise by name),
``--pipeline`` (with ``--mesh none`` on the trivial 1 x 1 grid, as the JAX
launcher does), ``--overlap``, ``--schedule``, ``--virtual-stages`` and
``--bucket-bytes``; the layouts not ported yet raise by name.
``--ckpt-dir`` writes the trained parameters at the end (rank 0, after
gathering each stage's layers).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import COMPUTE_DTYPES, STAGE_KERNELS, ExecutionPlan
from repro_torch.core.schedule import SCHEDULES
from repro_torch.core.strategy import Strategy
from repro_torch.data import MTBatchIterator, SyntheticMTTask
from repro_torch.models import seq2seq as s2s
from repro_torch.models.common import resolve_device, tree_leaves
from repro_torch.optim import adam
from repro_torch.train import Trainer


def make_mesh(name: str, pipeline: bool, device):
    """The grid ``--mesh`` names (None for ``none`` without ``--pipeline``)."""
    from repro_torch.launch import mesh as mesh_lib

    if name in ("pod", "multipod"):
        mesh_lib.make_production_mesh(multi_pod=name == "multipod")
    if name == "test":
        return mesh_lib.make_test_mesh(device=device)
    if pipeline:
        # a trivial (1, 1) grid so --pipeline exercises the real wavefront
        # code path (one stage) in one process
        return mesh_lib.make_grid(1, 1, device=device)
    return None


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seq2seq-rnn")
    ap.add_argument("--strategy", default="single", choices=[s.value for s in Strategy])
    ap.add_argument("--mesh", choices=("none", "pod", "multipod", "test"), default="none")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="override the config's encoder/decoder depth (the pipeline needs it divisible by the "
                         "model axis: the smoke config's 2 layers do not split over --mesh test's 4 stages)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--pipeline", action="store_true", help="wavefront pipeline backbone")
    ap.add_argument("--micro-batches", type=int, default=1,
                    help="microbatches per step (interleaved through the wavefront when --pipeline, "
                         "grad accumulation otherwise)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlap the hybrid head grad sync with the next microbatch's backbone")
    ap.add_argument("--stage-kernel", choices=STAGE_KERNELS, default="cuda",
                    help="LSTM cells and Luong head: the fused CUDA kernels (plain versions on a CPU) or plain torch")
    ap.add_argument("--schedule", choices=SCHEDULES, default="gpipe",
                    help="pipelined backward: gpipe recomputes all microbatches in one group, 1f1b and "
                         "zerobubble one at a time, interleaved runs --virtual-stages layer chunks per stage")
    ap.add_argument("--virtual-stages", type=int, default=1, help="layer chunks per stage for --schedule interleaved")
    ap.add_argument("--compute-dtype", choices=COMPUTE_DTYPES, default=None,
                    help="activation compute dtype; params stay fp32 master weights (default: the config's dtype)")
    ap.add_argument("--bucket-bytes", type=int, default=None,
                    help="bucketed delayed grad all-reduce target bucket size in bytes (requires --overlap)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"--arch {args.arch}: not ported yet (ported: {', '.join(ARCH_IDS)})")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.num_layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.num_layers)
    grid = make_mesh(args.mesh, args.pipeline, args.device)
    try:
        plan = ExecutionPlan(
            strategy=Strategy(args.strategy), mesh=grid, micro_batches=args.micro_batches,
            overlap=args.overlap, use_pipeline=args.pipeline, stage_kernel=args.stage_kernel,
            schedule=args.schedule, virtual_stages=args.virtual_stages, compute_dtype=args.compute_dtype,
            bucket_bytes=args.bucket_bytes,
        )
        plan.validate_batch(args.batch)
        device = grid.device if grid is not None else resolve_device(args.device)
        rank0 = grid is None or grid.rank == 0
        say = print if rank0 else (lambda *a, **k: None)
        if args.pipeline and not plan.pipelined:
            say(f"warning: --pipeline has no effect for strategy={plan.strategy.value} "
                "(wavefront needs model/hybrid); microbatches run as grad accumulation")
        if args.schedule != "gpipe" and not plan.pipelined:
            say(f"warning: --schedule={args.schedule} has no effect without "
                "the wavefront pipeline (needs --pipeline and model/hybrid)")

        params = s2s.init_seq2seq(args.seed, cfg, device=device)
        # repro.launch.train's task at its default --seq 64: sentences of 4-16 tokens
        task = SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=16)
        it = MTBatchIterator(task, batch_size=args.batch, seed=args.seed)
        trainer = Trainer(cfg, adam(lr=args.lr), it, plan=plan, params=params, seed=args.seed, device=device)

        n_params = sum(p.numel() for p in tree_leaves(params))
        mp_note = f" loss_scale={plan.loss_scale_init:g}" if plan.fp16(cfg) else ""
        shape = "x".join(map(str, grid.shape)) if grid is not None else "none"
        say(
            f"arch={cfg.name} params={n_params/1e6:.1f}M strategy={plan.strategy.value} mesh={args.mesh} "
            f"grid={shape} micro_batches={args.micro_batches} pipeline={plan.pipelined} overlap={args.overlap} "
            f"stage_kernel={plan.stage_kernel} schedule={plan.schedule} "
            f"compute_dtype={plan.resolve_compute_dtype(cfg)}{mp_note} device={device}"
        )
        trainer.run(args.steps, log_every=max(args.steps // 4, 1))
        if args.ckpt_dir:
            whole = trainer.params()  # every rank: each stage's layers from their owner
            if rank0:
                say("checkpoint:", save_checkpoint(args.ckpt_dir, args.steps, whole))
        return trainer
    finally:
        if grid is not None:
            grid.close()


if __name__ == "__main__":
    main()
