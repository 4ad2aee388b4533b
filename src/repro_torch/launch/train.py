"""Training launcher of the port: the paper's seq2seq model and the dense
and MoE LMs, on one card or on a grid of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --steps 200 --batch 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch seq2seq-rnn --smoke --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke --device cpu --steps 8
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --batch 4 --seq 2048 --steps 6
    PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.launch.train --arch seq2seq-rnn --smoke \
        --num-layers 4 --device cpu --strategy hybrid --pipeline --mesh test --micro-batches 2 --batch 16
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch seq2seq-rnn --smoke \
        --device cpu --strategy hybrid_opt --mesh test --grid 2x2 --batch 16
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch seq2seq-rnn --smoke \
        --device cpu --input-feeding --strategy hybrid --mesh test --grid 1x2 --batch 16
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-moe-30b-a3b --smoke \
        --device cpu --strategy hybrid --mesh test --grid 1x2 --steps 4

Weights are random, from the port's initializer and ``--seed``; batches come
from ``SyntheticMTTask`` through ``MTBatchIterator`` (seq2seq), or from
``SyntheticLMTask(V, branching=16)`` through ``LMBatchIterator`` at ``--seq``
tokens (the LMs), as in ``repro.launch.train``; the optimizer is Adam.
Prints the same config line and ``step N  loss ...  tok/s ...`` lines (rank
0 only on a grid).  An LM whose training state on one rank (fp32 masters,
grads and Adam's two moments: 16 B a parameter of the rank's share under
the plan's placement, reckoned from the shapes before anything is
allocated) exceeds one card exits, naming the smallest test grid it fits
on (the full ``qwen3-moe-30b-a3b`` on one card: cut its depth with
``--num-layers``, or spread it over a grid).  ``--pipeline`` with an LM arch
warns and runs the step unpipelined (tensor-parallel on a ``model`` axis
above 1): the JAX LM loss has no backbone to pipeline.

The JAX launcher's multi-device flags: ``--strategy``, ``--mesh`` (``none``;
``test``, the 2 x 4 grid of ``make_test_mesh`` or the ``--grid DxM`` one,
one process per rank under ``torchrun``; ``pod`` and ``multipod``, the TPU
meshes, raise by name), ``--pipeline`` (with ``--mesh none`` on the trivial
1 x 1 grid, as the JAX launcher does), ``--overlap``, ``--schedule``,
``--virtual-stages`` and ``--bucket-bytes``.  Every strategy runs: MODEL or
HYBRID without ``--pipeline`` on a grid is the tensor-parallel layout,
``hybrid_opt`` adds the vocab-sharded head and FSDP (``--mesh test --grid
1x1`` runs it on the trivial grid in one process).  ``--input-feeding``
trains the baseline / HybridNMTIF model (Hc fed into the first decoder
layer), as the JAX launcher's flag does, on every strategy: on a model axis
above 1 the decoder runs step-major on the column-shard cells with the head
data-parallel per step, and a pipelined plan runs so too (it has no
backbone to pipeline).  ``--ckpt-dir`` writes the trained parameters at
the end (rank 0, after gathering each stage's layers and each rank's
blocks).
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.plan import COMPUTE_DTYPES, STAGE_KERNELS, ExecutionPlan
from repro_torch.core.schedule import SCHEDULES
from repro_torch.core.strategy import Strategy, map_shapes
from repro_torch.data import LMBatchIterator, MTBatchIterator, SyntheticLMTask, SyntheticMTTask
from repro_torch.launch.serve import ONE_CARD_BYTES
from repro_torch.models import seq2seq as s2s
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device
from repro_torch.optim import adam
from repro_torch.train import Trainer


def make_mesh(name: str, pipeline: bool, device, shape=None):
    """The grid ``--mesh`` names (``test``: ``shape`` or 2 x 4), or None
    for ``none`` without ``--pipeline``."""
    from repro_torch.launch import mesh as mesh_lib

    if name in ("pod", "multipod"):
        mesh_lib.make_production_mesh(multi_pod=name == "multipod")
    if name == "test":
        return mesh_lib.make_test_mesh(*(shape or (2, 4)), device=device)
    if pipeline:
        # a trivial (1, 1) grid so --pipeline exercises the real wavefront
        # code path (one stage) in one process
        return mesh_lib.make_grid(1, 1, device=device)
    return None


def _grid_shape(text: str) -> tuple:
    try:
        d, m = (int(v) for v in text.lower().split("x"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"--grid wants DxM (e.g. 2x2), got {text!r}")
    return d, m


def _n_params(cfg) -> int:
    """The whole model's parameter count, from its shapes."""
    sizes = []
    shapes = s2s.param_shapes(cfg) if cfg.family == "seq2seq" else tfm.param_shapes(cfg)
    map_shapes(lambda shape: sizes.append(math.prod(shape)), shapes)
    return sum(sizes)


class GridShape:
    """The shape of a ``data x model`` grid without its processes: what a
    plan's validators and its placement read."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.data, self.model, self.world = data, model, data * model
        self.shape = (data, model)

    def size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model, "all": self.world}[axis]


def lm_state_bytes(cfg, strategy, shape) -> Optional[int]:
    """The bytes of training state (fp32 masters, grads, Adam's m and v: 16 B
    a parameter) one rank holds when ``cfg`` trains under ``strategy`` on a
    grid of ``shape`` (None: one process): each leaf's share under the plan's
    placement, from the shapes alone.  None when the plan cannot train
    ``cfg`` on that grid (``core/plan.py::check_lm_plan``)."""
    grid = GridShape(*shape) if shape is not None else None
    try:
        placement = ExecutionPlan(strategy=Strategy(strategy), mesh=grid).placement(cfg)
    except NotImplementedError:
        return None
    sizes = {None: 1} if grid is None else {None: 1, "data": grid.data, "model": grid.model}
    shares = []
    map_shapes(lambda shape_, placed: shares.append(math.prod(shape_) // math.prod(sizes[a] for a in placed)),
               tfm.param_shapes(cfg), placement)
    return 16 * sum(shares)


def smallest_grid(cfg, strategy, cap: int, max_world: int = 256) -> Optional[tuple]:
    """The test grid of the fewest ranks (the widest ``model`` axis first)
    on which a rank's training state of ``cfg`` under ``strategy`` fits in
    ``cap`` bytes, or None up to ``max_world`` ranks."""
    for world in range(1, max_world + 1):
        for model in sorted((m for m in range(1, world + 1) if world % m == 0), reverse=True):
            need = lm_state_bytes(cfg, strategy, (world // model, model))
            if need is not None and need <= cap:
                return world // model, model
    return None


def check_lm_state_fits(cfg, device, strategy="single", shape=None) -> None:
    """Exit before any allocation when an LM's training state on one rank of
    the grid (16 B a parameter of the rank's share, :func:`lm_state_bytes`)
    exceeds the card, naming the smallest test grid it fits on."""
    n = _n_params(cfg)
    dev = resolve_device(device)
    cap = torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda" else ONE_CARD_BYTES
    need = lm_state_bytes(cfg, strategy, shape)
    if need is None or need <= cap:
        return
    where = "one rank" if shape is None else f"a rank of the {shape[0]}x{shape[1]} grid under --strategy {strategy}"
    fits = smallest_grid(cfg, strategy, cap)
    hint = (f"the smallest test grid it fits on is --mesh test --grid {fits[0]}x{fits[1]}" if fits is not None else
            f"no test grid of up to 256 ranks fits it under --strategy {strategy}")
    raise SystemExit(f"--arch {cfg.name}: {n:,} parameters x 16 B of training state (fp32 masters, grads, Adam m "
                     f"and v) = {16 * n / 1e9:.0f} GB, {need / 1e9:.1f} GB on {where}, more than the "
                     f"{'card' if dev.type == 'cuda' else 'one-card budget'}'s {cap / 1e9:.0f} GB; {hint}, or cut "
                     "the depth with --num-layers")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="seq2seq-rnn")
    ap.add_argument("--strategy", default="single", choices=[s.value for s in Strategy])
    ap.add_argument("--mesh", choices=("none", "pod", "multipod", "test"), default="none")
    ap.add_argument("--grid", type=_grid_shape, default=None,
                    help="with --mesh test: the data x model shape of the grid, DxM (default 2x4)")
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--input-feeding", action="store_true",
                    help="baseline / HybridNMTIF: feed Hc_{t-1} into the first decoder layer")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="override the config's depth (seq2seq: the pipeline needs it divisible by the model axis: "
                         "the smoke config's 2 layers do not split over --mesh test's 4 stages)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64, help="LM archs: tokens per sequence")
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
    if args.input_feeding:
        cfg = dataclasses.replace(cfg, input_feeding=True)
    if args.grid is not None and args.mesh != "test":
        raise SystemExit("--grid sets the shape of --mesh test")
    lm = cfg.family != "seq2seq"
    if lm:
        if args.input_feeding:
            raise SystemExit("--input-feeding applies to the seq2seq arch")
        if args.mesh in ("none", "test"):  # the TPU meshes raise by name below
            shape = (args.grid or (2, 4)) if args.mesh == "test" else ((1, 1) if args.pipeline else None)
            check_lm_state_fits(cfg, args.device, args.strategy, shape)
    grid = make_mesh(args.mesh, args.pipeline, args.device, args.grid)
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
        if plan.pipelined and not plan.for_config(cfg).pipelined:
            why = ("an LM has no backbone to pipeline" if lm else
                   "the input-feeding decoder's recurrence runs the head inside it")
            how = "tensor-parallel" if plan.for_config(cfg).tensor_parallel else "unpipelined"
            say(f"warning: --pipeline with --arch {args.arch} on a model axis of {grid.size(plan.model_axis)}: {why}, "
                f"so the step runs {how}, in one forward and backward")
        if args.schedule != "gpipe" and not plan.pipelined:
            say(f"warning: --schedule={args.schedule} has no effect without "
                "the wavefront pipeline (needs --pipeline and model/hybrid)")

        if lm:
            task = SyntheticLMTask(vocab_size=cfg.vocab_size, branching=16)
            it = LMBatchIterator(task, batch_size=args.batch, seq_len=args.seq, seed=args.seed)
        else:
            # repro.launch.train's task: sentences of 4 to min(16, --seq) tokens
            task = SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=min(16, args.seq))
            it = MTBatchIterator(task, batch_size=args.batch, seed=args.seed)
        # the trainer initializes the weights from --seed (init_seq2seq or init_lm) on the device
        trainer = Trainer(cfg, adam(lr=args.lr), it, plan=plan, seed=args.seed, device=device)

        n_params = _n_params(cfg)
        mp_note = f" loss_scale={plan.loss_scale_init:g}" if plan.fp16(cfg) else ""
        shape = "x".join(map(str, grid.shape)) if grid is not None else "none"
        say(
            f"arch={cfg.name} params={n_params/1e6:.1f}M strategy={plan.strategy.value} mesh={args.mesh} "
            f"grid={shape} micro_batches={args.micro_batches} pipeline={plan.pipelined} overlap={args.overlap} "
            f"stage_kernel={plan.stage_kernel} schedule={plan.schedule} input_feeding={cfg.input_feeding} "
            f"compute_dtype={plan.resolve_compute_dtype(cfg)}{mp_note} device={device}"
        )
        trainer.run(args.steps, log_every=max(args.steps // 4, 1))
        if args.ckpt_dir:
            whole = trainer.params()  # every rank: each stage's layers from their owner, each leaf's blocks
            if rank0:
                say("checkpoint:", save_checkpoint(args.ckpt_dir, args.steps, whole))
        return trainer
    finally:
        if grid is not None:
            grid.close()


if __name__ == "__main__":
    main()
