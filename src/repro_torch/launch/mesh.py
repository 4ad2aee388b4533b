"""Process grids: the port's counterpart of ``repro/launch/mesh.py``.

Where the JAX package lays devices out on a ``jax.make_mesh`` mesh, the port
runs one process per rank and lays the ranks out on a :class:`ProcessGrid`
over ``torch.distributed``: axes ``("data", "model")``, rank ``r`` at
``(d, m) = divmod(r, model)`` (``data`` major, as ``make_test_mesh`` lays out
its devices), and a sub-group of the default group for each row and column.

* Ranks come from the environment ``torchrun`` sets (``RANK``,
  ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), from a
  ``torch.distributed`` store the caller passes (the tests pass a
  ``FileStore``), or, for a grid of one rank, from an in-process store.
* A rank's device is ``cuda:LOCAL_RANK`` unless the caller names one
  (``"cuda:0"`` for several ranks on one card) or asks for ``"cpu"``;
  ``"cuda"`` without a card raises.
* The backend is NCCL for CUDA ranks and gloo for CPU ranks.  Gloo can also
  carry CUDA ranks (several on one card, where NCCL refuses): every tensor a
  collective or a send carries then goes through host memory.
* Every process group gets ``timeout_s`` (60 s by default), so a rank that
  dies or hangs fails the run instead of stalling it.

:func:`spawn_grid` runs a function on every rank of a grid in fresh
processes (the ``spawn`` start method) and returns what each rank returned;
a rank that raises, exits or outlives its time limit fails the call.

The TPU pod meshes of ``make_production_mesh`` have no counterpart here:
the port runs on the cards of one host, and the function raises by name.
"""
from __future__ import annotations

import datetime
import os
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.models.common import resolve_device

AXES = ("data", "model")
DEFAULT_TIMEOUT_S = 60.0


class _Pending:
    """Handle of a collective in flight: ``wait()`` completes it and copies
    host-staged receive buffers back to their device tensors."""

    def __init__(self, works=(), copies=(), keep=()):
        self.works, self.copies, self.keep = list(works), list(copies), list(keep)  # keep: buffers in flight

    def wait(self):
        for w in self.works:
            w.wait()
        for dst, src in self.copies:
            dst.copy_(src)
        self.works, self.copies, self.keep = [], [], []


class ProcessGrid:
    """This process's place on a ``data x model`` grid of ranks, with the
    groups and the collectives the hybrid step uses.  Axis ``"all"`` is the
    whole grid.  A collective over an axis of size 1 does nothing, so the
    trivial (1, 1) grid makes no collective call at all."""

    axis_names = AXES

    def __init__(self, data: int, model: int, *, device="cuda", store=None, rank: Optional[int] = None,
                 backend: Optional[str] = None, timeout_s: float = DEFAULT_TIMEOUT_S):
        if data < 1 or model < 1:
            raise ValueError(f"grid axes must be >= 1, got data={data} model={model}")
        self.data, self.model = data, model
        world = data * model
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        self.device = resolve_device(dev)
        self.backend = backend or ("nccl" if self.device.type == "cuda" else "gloo")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend must be 'nccl' or 'gloo', got {self.backend!r}")
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.timeout = datetime.timedelta(seconds=timeout_s)
        self._owns_default = not dist.is_initialized()
        if self._owns_default:
            if store is not None:
                if rank is None:
                    raise ValueError("a grid built on a store needs this process's rank")
                dist.init_process_group(self.backend, store=store, rank=rank, world_size=world, timeout=self.timeout)
            elif "RANK" in os.environ and "WORLD_SIZE" in os.environ:
                dist.init_process_group(self.backend, init_method="env://", rank=int(os.environ["RANK"]),
                                        world_size=int(os.environ["WORLD_SIZE"]), timeout=self.timeout)
            elif world == 1:
                dist.init_process_group(self.backend, store=dist.HashStore(), rank=0, world_size=1,
                                        timeout=self.timeout)
            else:
                raise RuntimeError(f"a {data} x {model} grid needs {world} processes: run under torchrun "
                                   "(RANK/WORLD_SIZE in the environment) or pass a store and a rank")
        else:  # a grid over an existing default group carries what that group carries
            self.backend = dist.get_backend()
        if dist.get_world_size() != world:
            raise ValueError(f"a {data} x {model} grid needs a world of {world} ranks, "
                             f"this one has {dist.get_world_size()}")
        self.rank = dist.get_rank()
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        # every rank creates every sub-group, in one order: rows (model), then columns (data)
        self._groups = {"all": dist.group.WORLD if world > 1 else None}
        for axis, parts in (("model", [[d * model + m for m in range(model)] for d in range(data)]),
                            ("data", [[d * model + m for d in range(data)] for m in range(model)])):
            self._groups[axis] = None
            if len(parts[0]) == world:
                self._groups[axis] = self._groups["all"]
            elif len(parts[0]) > 1:
                for ranks in parts:
                    g = dist.new_group(ranks, timeout=self.timeout)
                    if self.rank in ranks:
                        self._groups[axis] = g
        # every rank is there, and each group's communicator exists, before the
        # first step: a group's first NCCL point-to-point call would otherwise
        # need every member of the group to take part in it
        for axis in ("all", "model", "data"):
            self.all_reduce(torch.ones((), device=self.device), axis).wait()

    # -- layout ---------------------------------------------------------------

    @property
    def shape(self) -> tuple:
        return (self.data, self.model)

    @property
    def world(self) -> int:
        return self.data * self.model

    def size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model, "all": self.world}[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis`` (its global rank on ``"all"``)."""
        return {"data": self.rank // self.model, "model": self.rank % self.model, "all": self.rank}[axis]

    def global_rank(self, axis: str, index: int) -> int:
        """The global rank at coordinate ``index`` of ``axis`` in this rank's row or column."""
        d, m = divmod(self.rank, self.model)
        if axis == "model":
            return d * self.model + index
        if axis == "data":
            return index * self.model + m
        return index

    # -- collectives ----------------------------------------------------------

    def _carrier(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def all_reduce(self, t: torch.Tensor, axis: str = "all") -> _Pending:
        """Sum ``t`` in place over ``axis``; returns the pending handle."""
        g = self._groups[axis]
        if g is None:
            return _Pending()
        buf = self._carrier(t)
        work = dist.all_reduce(buf, group=g, async_op=True)
        return _Pending([work], [(t, buf)] if buf is not t else [])

    def exchange(self, send: Optional[torch.Tensor] = None, send_to: Optional[int] = None,
                 recv: Optional[torch.Tensor] = None, recv_from: Optional[int] = None,
                 axis: str = "model") -> _Pending:
        """One point-to-point step on ``axis``: send ``send`` to coordinate
        ``send_to`` and receive into ``recv`` from ``recv_from`` (either may
        be None), posted together."""
        g = self._groups[axis]
        ops, copies, keep = [], [], []
        if send is not None:
            buf = self._carrier(send).contiguous()
            keep.append(buf)
            ops.append(dist.P2POp(dist.isend, buf, self.global_rank(axis, send_to), g))
        if recv is not None:
            buf = torch.empty(recv.shape, dtype=recv.dtype) if self.staged else recv
            ops.append(dist.P2POp(dist.irecv, buf, self.global_rank(axis, recv_from), g))
            if buf is not recv:
                copies.append((recv, buf))
        if not ops:
            return _Pending()
        return _Pending(dist.batch_isend_irecv(ops), copies, keep)

    def scatter(self, out: torch.Tensor, chunks: Optional[list], axis: str, src: int) -> None:
        """``out`` <- chunk ``index(axis)`` of ``chunks`` held by coordinate ``src``."""
        g = self._groups[axis]
        if g is None:
            out.copy_(chunks[0])
            return
        buf = self._carrier(out)
        dist.scatter(buf, [self._carrier(c).contiguous() for c in chunks] if chunks is not None else None,
                     src=self.global_rank(axis, src), group=g)
        if buf is not out:
            out.copy_(buf)

    def gather(self, t: torch.Tensor, outs: Optional[list], axis: str, dst: int) -> None:
        """``outs`` on coordinate ``dst`` <- every coordinate's ``t``, in order."""
        g = self._groups[axis]
        if g is None:
            outs[0].copy_(t)
            return
        bufs = None
        if outs is not None:
            bufs = [torch.empty(o.shape, dtype=o.dtype) for o in outs] if self.staged else outs
        dist.gather(self._carrier(t).contiguous(), bufs, dst=self.global_rank(axis, dst), group=g)
        if outs is not None and bufs is not outs:
            for o, b in zip(outs, bufs):
                o.copy_(b)

    def broadcast(self, t: torch.Tensor, axis: str, src: int) -> None:
        """``t`` <- coordinate ``src``'s ``t``, in place."""
        g = self._groups[axis]
        if g is None:
            return
        buf = self._carrier(t)
        dist.broadcast(buf, src=self.global_rank(axis, src), group=g)
        if buf is not t:
            t.copy_(buf)

    # -- lifetime -------------------------------------------------------------

    def close(self) -> None:
        """Destroy the process group if this grid created it."""
        if self._owns_default and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_default = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"ProcessGrid(data={self.data}, model={self.model}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def make_grid(data: int = 1, model: int = 1, **kw) -> ProcessGrid:
    """A ``data x model`` grid of this process and its peers (see :class:`ProcessGrid`)."""
    return ProcessGrid(data, model, **kw)


def make_test_mesh(data: int = 2, model: int = 4, **kw) -> ProcessGrid:
    """The grid of ``repro.launch.mesh.make_test_mesh``: 2 x 4 ranks."""
    return ProcessGrid(data, model, **kw)


def make_production_mesh(*, multi_pod: bool = False):
    shape = "(2, 16, 16) pod x data x model" if multi_pod else "(16, 16) data x model"
    raise NotImplementedError(
        f"the TPU v5e production mesh {shape} is not ported: the port's grids are the cards of one host "
        "(make_grid / make_test_mesh); multi-host grids are ROADMAP queue 1 item 4")


# ---------------------------------------------------------------------------
# running a function on every rank of a grid
# ---------------------------------------------------------------------------


def _rank_main(fn, rank, data, model, device, backend, store_path, out_dir, args, timeout_s, threads):
    if threads:
        torch.set_num_threads(threads)
    try:
        store = dist.FileStore(store_path, data * model)
        with ProcessGrid(data, model, device=device, store=store, rank=rank, backend=backend,
                         timeout_s=timeout_s) as grid:
            result = fn(grid, *args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _read(path: str) -> str:
    if not os.path.exists(path):
        return "no traceback (the process died)\n"
    with open(path) as f:
        return f.read()


def spawn_grid(fn: Callable, data: int, model: int, *, args: tuple = (), device="cpu", backend: Optional[str] = None,
               timeout_s: float = 300.0, collective_timeout_s: float = DEFAULT_TIMEOUT_S, threads: int = 1) -> list:
    """Run ``fn(grid, *args)`` on each rank of a ``data x model`` grid, one
    fresh process per rank (``spawn``), ranks meeting on a ``FileStore`` in a
    temporary directory.  ``fn`` must be a module-level function; what it
    returns is saved with ``torch.save`` (keep tensors on the CPU).  Returns
    the ranks' results in rank order.  Raises once a rank fails (every
    failed rank's traceback in the message, the first failure first), or
    when ``timeout_s`` passes; every process is stopped before it returns or
    raises."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    world = data * model
    with tempfile.TemporaryDirectory(prefix="grid-") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, data, model, device, backend, os.path.join(tmp, "store"), tmp, args,
                                   collective_timeout_s, threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs) and not any(p.exitcode for p in procs):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks of a {data} x {model} grid still running after {timeout_s}s")
                time.sleep(0.02)
            if any(p.exitcode for p in procs):  # let the others fail on the lost peer before reporting
                for p in procs:
                    p.join(max(0.0, min(5.0, deadline - time.monotonic())))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            errs = {r: os.path.join(tmp, f"rank{r}.err") for r in failed}
            failed.sort(key=lambda r: os.path.getmtime(errs[r]) if os.path.exists(errs[r]) else float("inf"))
            detail = "\n".join(f"rank {r} (exit code {procs[r].exitcode}):\n{_read(errs[r])}" for r in failed)
            raise RuntimeError(f"rank {failed[0]} of a {data} x {model} grid failed first; "
                               f"failed ranks {failed}:\n{detail}")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]
