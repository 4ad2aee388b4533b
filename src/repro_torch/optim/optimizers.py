"""Adam / SGD with gradient clipping, as functions on trees of tensors (the
port of ``repro/optim/optimizers.py``).

The paper trains with Adam (beta1 .9, beta2 .999, eps 1e-8, lr 1e-3) and
compares against OpenNMT-lua's default SGD; both are here.  The moments are
fp32 and mirror the parameter tree.  Nothing is updated in place: each
update returns new trees, as the JAX package's pure transforms do.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models.common import tree_leaves, tree_map

Params = Any


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Params  # first moment (SGD: momentum buffer)
    v: Params  # second moment (SGD: an unused fp32 scalar)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """Scale every leaf by min(1, max_norm / norm); returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


class Adam(NamedTuple):
    lr: float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0

    def init(self, params) -> OptState:
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return OptState(step=_step0(params), m=z, v=tree_map(torch.zeros_like, z))

    def update(self, grads, state: OptState, params, lr_scale=1.0):
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        m = tree_map(lambda mm, g: b1 * mm + (1 - b1) * g.float(), state.m, grads)
        v = tree_map(lambda vv, g: b2 * vv + (1 - b2) * torch.square(g.float()), state.v, grads)
        t = step.float()
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=t.device), t)
        lr = self.lr * lr_scale

        def upd(mm, vv, p):
            u = (mm / bc1) / (torch.sqrt(vv / bc2) + self.eps)
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, m, v, params), OptState(step=step, m=m, v=v)


class SGD(NamedTuple):
    lr: float = 1.0
    momentum: float = 0.0

    def init(self, params) -> OptState:
        z = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        v = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
        return OptState(step=_step0(params), m=z, v=v)

    def update(self, grads, state: OptState, params, lr_scale=1.0):
        lr = self.lr * lr_scale
        if self.momentum:
            m = tree_map(lambda mm, g: self.momentum * mm + g.float(), state.m, grads)
        else:
            m = tree_map(lambda g: g.float(), grads)
        updates = tree_map(lambda mm, p: (-lr * mm).to(p.dtype), m, params)
        return updates, OptState(step=state.step + 1, m=m if self.momentum else state.m, v=state.v)


def adam(**kw) -> Adam:
    return Adam(**kw)


def sgd(**kw) -> SGD:
    return SGD(**kw)


def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
