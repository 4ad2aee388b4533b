#!/usr/bin/env python3
"""Time the port's full-width seq2seq-rnn training step on one NVIDIA GPU for
one or more checkouts of this repository, one process each, in the order
given.  Run from anywhere:

    python3 tools/train_step_compare.py PARENT CHANGE CHANGE PARENT

Each run builds that checkout's CUDA kernels, then trains as ``chip_smoke.py``'s
training phase does (bf16 over fp32 masters, dropout 0.3, Adam lr 1e-3, clip
5.0, ``MTBatchIterator`` batches of 64 from seed 0, the ``cuda`` stage
kernels) for ``--steps`` steps and prints one JSON line: the median host-clock
step (each step ends in a synchronise) over the steps after the first two,
target tokens per second over the same steps, and, from ``torch.profiler``
over two more steps, the device time a step of every kernel whose name holds
``lstm_cell`` and of all device work, and the device's busy share of the
profiled wall time.  The last line is the card's ``nvidia-smi`` name and power
limit.  Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import dataclasses, json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1] + "/src")
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.plan import ExecutionPlan
from repro_torch.data import MTBatchIterator, SyntheticMTTask
from repro_torch.optim import adam
from repro_torch.train import Trainer
from torch.profiler import ProfilerActivity, profile

steps = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build_all()
cfg = dataclasses.replace(get_config("seq2seq-rnn"), dtype="bfloat16")
plan = ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16")
it = MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), batch_size=64, seed=0)
trainer = Trainer(cfg, adam(lr=1e-3), it, plan=plan, clip_norm=5.0, seed=0, device="cuda")
trainer.run(steps, log_every=1, log=lambda line: None)
steady = trainer.history[2:]
step_ms = float(np.median([h["step_s"] for h in steady])) * 1e3
tok_s = sum(h["tokens"] for h in steady) / sum(h["step_s"] for h in steady)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    trainer.run(2, log_every=1, log=lambda line: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
events = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
device_us = sum(e.self_device_time_total for e in events)
lstm_us = sum(e.self_device_time_total for e in events if "lstm_cell" in e.key)
lstm_calls = sum(e.count for e in events if "lstm_cell" in e.key)
print(json.dumps({"tree": sys.argv[1], "median_step_ms": step_ms, "target_tok_s": tok_s,
                  "losses": [round(h["loss"], 4) for h in trainer.history],
                  "profiled_steps": 2, "lstm_cell_device_ms_per_step": lstm_us / 2e3,
                  "lstm_cell_kernel_runs_per_step": lstm_calls / 2,
                  "device_ms_per_step": device_us / 2e3, "wall_ms_per_step_profiled": wall * 1e3 / 2,
                  "device_busy_share": device_us / 1e3 / (wall * 1e3)}))
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="+", help="checkouts of the repository, run in this order")
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    for tree in args.trees:
        root = os.path.abspath(tree)
        out = subprocess.run([sys.executable, "-c", CHILD, root, str(args.steps)], capture_output=True, text=True,
                             timeout=900)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            sys.exit(f"the run on {root} failed ({out.returncode})")
        print(out.stdout.strip().splitlines()[-1], flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
