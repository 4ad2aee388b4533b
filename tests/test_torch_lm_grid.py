"""The port's LM training on a grid of gloo ranks on the CPU: ``qwen3-1.7b``
(dense) and ``qwen3-moe-30b-a3b`` (MoE) on DATA, MODEL, HYBRID and
HYBRID_OPT, with the tensor-parallel blocks and the expert-parallel MoE
(``models/moe.py::apply_moe_ep``).

The references:

* the JAX package's meshless ``forward_train`` under ``jax.value_and_grad``
  at fp32, which every layout equals: DATA keeps the global dispatch (the
  capacity, the slots' positions and the load-balance statistics of the
  whole batch) and is held to it at a capacity that drops slots; the
  expert-parallel layouts drop at two capacities of their own, so they are
  held to it where no slot drops (capacity factor 64).  The JAX package's
  meshed LM step fails on jax 0.9.0 (ROADMAP queue 3);
* JAX's ``apply_moe_ep`` under ``compat.shard_map`` on forced host devices,
  in a subprocess, for the MoE layer alone at a capacity that drops: the
  output, aux and grads; the kept slots against JAX's own ``route`` and
  ``sorted_dispatch`` on each shard;
* JAX's ``init_lm`` specs and ``resolve_specs`` for the logical spec tree
  and the placement;
* the port's own meshless ``Trainer`` for a 3-step trajectory.

The models are the smoke configs with GQA at G = 4 (8 q heads on 2 kv heads:
the kv heads shard at 2 ranks and stay whole at 4), and a dense model at
d = 1024 for HYBRID_OPT's FSDP; the same ``dataclasses.replace`` on both
sides.  The weights come from the port's initializer (CRC-32 of each path:
the same in every process) and go to JAX as numpy arrays.  Tolerances: the
loss within 1e-4, every grad leaf at atol 1e-4 / rtol 1e-3
(``tests/test_torch_lm_train.py``'s).  The ranks run in two spawns (worlds of
2 and 4 processes), each running every case of its world size.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import strategy as stg  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import LMBatchIterator, SyntheticLMTask  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import spawn_grid  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from torch_lm_grid_workers import AMPLE, TIGHT, arch_of, port_config, replaced, replacements, to_tensors  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FP32_TOL = dict(atol=1e-4, rtol=1e-3)
LOSS_TOL = 1e-4
SPAWN_LIMIT_S = 300  # per spawn
B, S = 4, 16  # 64 tokens: 16 a rank at 4 ranks
CONFIGS = ("dense", "wide", "moe-ample", "moe-tight")


def _case(config, grid, strategy, **kw):
    return dict(config=config, grid=grid, strategy=strategy, **kw)


CASES = {
    # world 2
    "dense-data-2x1": _case("dense", (2, 1), "data"),
    "dense-model-1x2": _case("dense", (1, 2), "model"),
    "dense-hybrid-1x2": _case("dense", (1, 2), "hybrid"),
    "dense-hybrid_opt-1x2": _case("dense", (1, 2), "hybrid_opt"),
    "wide-hybrid_opt-2x1": _case("wide", (2, 1), "hybrid_opt"),
    "dense-model-1x2-torch": _case("dense", (1, 2), "model", stage_kernel="torch"),
    "moe-data-2x1-tight": _case("moe-tight", (2, 1), "data"),
    "moe-data-1x2-tight": _case("moe-tight", (1, 2), "data"),
    "moe-model-1x2": _case("moe-ample", (1, 2), "model"),
    "moe-hybrid-1x2": _case("moe-ample", (1, 2), "hybrid"),
    "moe-hybrid_opt-1x2": _case("moe-ample", (1, 2), "hybrid_opt"),
    "moe-model-2x1": _case("moe-ample", (2, 1), "model"),
    "moe-hybrid-1x2-pipeline": _case("moe-ample", (1, 2), "hybrid", use_pipeline=True, micro_batches=2),
    # world 4
    "dense-data-2x2": _case("dense", (2, 2), "data"),
    "dense-model-1x4": _case("dense", (1, 4), "model"),
    "dense-hybrid-2x2": _case("dense", (2, 2), "hybrid"),
    "dense-hybrid_opt-2x2": _case("dense", (2, 2), "hybrid_opt"),
    "wide-hybrid_opt-2x2": _case("wide", (2, 2), "hybrid_opt"),
    "moe-data-2x2-tight": _case("moe-tight", (2, 2), "data"),
    "moe-model-1x4": _case("moe-ample", (1, 4), "model"),
    "moe-hybrid-2x2": _case("moe-ample", (2, 2), "hybrid"),
    "moe-hybrid_opt-2x2": _case("moe-ample", (2, 2), "hybrid_opt"),
}
# planted faults the checks must catch: (case, fault)
FAULT_CASES = {
    "own_capacity": _case("moe-tight", (2, 1), "data", fault="own_capacity"),
    "product_before_mean": _case("moe-ample", (1, 2), "model", fault="product_before_mean"),
    "partial_not_summed": _case("dense", (1, 2), "model", fault="partial_not_summed"),
}
EP_GRIDS = ((1, 2), (2, 2))  # apply_moe_ep alone, at a capacity that drops
EP_MOE = dict(num_experts=8, top_k=2, d_ff_expert=16, capacity_factor=TIGHT)
EP_T, EP_D, EP_AUX = 64, 32, 1.0
TRAIN_STEPS = 3
LAUNCHES = {"moe-hybrid-1x2": ["--arch", "qwen3-moe-30b-a3b", "--strategy", "hybrid", "--grid", "1x2"],
            "dense-data-2x1": ["--arch", "qwen3-1.7b", "--strategy", "data", "--grid", "2x1"]}


# ---------------------------------------------------------------------------
# the shared inputs and the JAX references
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(config: str):
    """The port's fp32 weights of ``config`` as a numpy tree (nested dicts and lists)."""
    params = tfm.init_lm(0, port_config(config), device="cpu")

    def numpy(tree):
        if isinstance(tree, dict):
            return {k: numpy(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [numpy(v) for v in tree]
        return tree.numpy()

    return numpy(params)


@functools.lru_cache(maxsize=None)
def _batch(config: str, seed: int = 0) -> dict:
    b = next(LMBatchIterator(SyntheticLMTask(port_config(config).vocab_size, branching=16), B, S, seed=seed))
    b["mask"][0, -5:] = False  # a ragged row: the mean divides by the unmasked count
    return b


def _jax_config(config: str):
    return replaced(jax_get_config(arch_of(config), smoke=True), replacements(config))


def _flat(tree, like) -> list:
    """Leaves of a JAX tree in the port's traversal order: ``like``'s (dict
    insertion; JAX rebuilds its dicts with sorted keys)."""
    if isinstance(like, dict):
        return [x for k in like for x in _flat(tree[k], like[k])]
    if isinstance(like, (list, tuple)):
        return [x for v, w in zip(tree, like) for x in _flat(v, w)]
    return [np.asarray(tree, np.float32)]


@functools.lru_cache(maxsize=None)
def _jax_meshless(config: str):
    """(loss, aux, denom, grad leaves) of JAX's meshless forward_train on the
    port's weights and batch, fp32."""
    jcfg, b = _jax_config(config), _batch(config)
    params = jax.tree.map(jnp.asarray, _model(config))

    def f(p):
        return jtfm.forward_train(p, jcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]), jnp.asarray(b["mask"]),
                                  ctx=jtfm.RunCtx(mode="train"))

    (loss, extras), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return float(loss), float(extras["aux"]), float(extras["denom"]), _flat(grads, _model(config))


def _jobs(world: int) -> list:
    cases = {n: c for n, c in {**CASES, **{f"fault-{k}": v for k, v in FAULT_CASES.items()}}.items()
             if c["grid"][0] * c["grid"][1] == world}
    models = {c: _model(c) for c in CONFIGS}
    batches = {c: _batch(c) for c in CONFIGS}
    jobs = [("layouts", "layout_cases", (cases, models, batches))]
    x, p, cot = _ep_inputs()
    m = _port_moe_config()
    jobs += [(f"ep-{d}x{mm}", "moe_ep_case", ((d, mm), m, x, p, cot, EP_AUX)) for d, mm in EP_GRIDS if d * mm == world]
    if world == 2:
        jobs.append(("all_to_all", "all_to_all_check", ()))
        steps = [_batch("moe-ample", seed) for seed in range(1, TRAIN_STEPS + 1)]
        jobs.append(("trainer", "trainer_run", ("moe-ample", (1, 2), "hybrid", _model("moe-ample"), steps)))
        for name, argv in LAUNCHES.items():
            jobs.append((f"launch-{name}", "launch_lines", (argv + ["--smoke", "--device", "cpu", "--mesh", "test",
                                                                     "--steps", "4", "--batch", "8", "--seq", "32",
                                                                     "--lr", "3e-3", "--compute-dtype", "float32"],)))
    return jobs


@pytest.fixture(scope="module")
def results():
    """Every job, run on gloo ranks: one spawn of 2 processes, one of 4; each
    rank's results."""
    out = {}
    for world in (2, 4):
        t0 = time.monotonic()
        ranks = spawn_grid(_run_all, 1, world, args=(_jobs(world),), timeout_s=SPAWN_LIMIT_S)
        assert time.monotonic() - t0 < SPAWN_LIMIT_S
        for key in ranks[0]:
            if key != "layouts":
                out[key] = [r[key] for r in ranks]
        out.setdefault("layouts", {}).update(ranks[0].pop("layouts"))
    return out


def _run_all(grid, jobs):
    from torch_lm_grid_workers import run_all

    return run_all(grid, jobs)


def _close(got: list, want: list, what: str, tol=FP32_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


# ---------------------------------------------------------------------------
# every layout against JAX's meshless step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CASES))
def test_layout_step_matches_jax_meshless(results, name):
    """Loss, aux, token count and every grad leaf (gathered whole from the
    ranks' blocks) against JAX's meshless ``forward_train`` at fp32."""
    case = CASES[name]
    got = results["layouts"][name]
    loss, aux, denom, grads = _jax_meshless(case["config"])
    assert abs(got["loss"] - loss) < LOSS_TOL, (got["loss"], loss)
    assert abs(got["aux"] - aux) < LOSS_TOL, (got["aux"], aux)
    assert got["denom"] == denom == float(_batch(case["config"])["mask"].sum())
    _close(got["grads"], grads, name)
    M = case["grid"][1]
    assert got["tensor_parallel"] == (case["strategy"] == "hybrid_opt" or (case["strategy"] != "data" and M > 1))
    if case["config"].startswith("moe"):  # expert-parallel on every strategy but DATA
        L = port_config(case["config"]).num_layers
        # a layer: x and the expert ids there and y back, in the forward and the remat recompute, and the two
        # differentiable exchanges again in the backward; at M = 1 only the ids' exchange reaches the grid
        want = 0 if case["strategy"] == "data" else (8 * L if M > 1 else 2 * L)
        assert len(got["all_to_all"]) == want, got["all_to_all"]


def test_tight_capacity_drops_slots():
    """The DATA cases' capacity drops slots: JAX's meshless loss and aux move
    between the tight and the ample capacity factor."""
    tight, ample = _jax_meshless("moe-tight"), _jax_meshless("moe-ample")
    assert abs(tight[0] - ample[0]) > 10 * LOSS_TOL and abs(tight[1] - ample[1]) > 10 * LOSS_TOL


@pytest.mark.parametrize("fault", list(FAULT_CASES))
def test_planted_faults_are_caught(results, fault):
    """Each planted fault makes its layout miss JAX's meshless step: DATA
    dispatching each rank's rows at its own capacity and positions, the
    load-balance statistics multiplied before their mean over the grid,
    and one row-parallel partial output not summed over ``model``."""
    case = FAULT_CASES[fault]
    got = results["layouts"][f"fault-{fault}"]
    loss, aux, _, grads = _jax_meshless(case["config"])
    bad = [i for i, (g, w) in enumerate(zip(got["grads"], grads)) if not np.allclose(g, w, **FP32_TOL)]
    assert bad or abs(got["loss"] - loss) > LOSS_TOL, fault
    if fault == "product_before_mean":
        assert abs(got["aux"] - aux) > LOSS_TOL


# ---------------------------------------------------------------------------
# apply_moe_ep alone, against JAX's under shard_map
# ---------------------------------------------------------------------------


def _port_moe_config():
    from repro_torch.configs.base import MoEConfig

    return MoEConfig(**EP_MOE)


@functools.lru_cache(maxsize=None)
def _ep_inputs():
    """(x [T, d], the MoE's weights, the output's cotangent), numpy fp32."""
    from repro_torch.models import moe
    from repro_torch.models.common import Initializer

    p = moe.init_moe(Initializer(4), "moe", EP_D, _port_moe_config())
    rng = np.random.default_rng(5)
    x = rng.normal(size=(EP_T, EP_D)).astype(np.float32)
    cot = rng.normal(size=(EP_T, EP_D)).astype(np.float32)
    return x, {k: v.numpy() for k, v in p.items()}, cot


_EP_SCRIPT = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.core import compat
    from repro.configs.base import MoEConfig
    from repro.models import moe
    D, M = int(sys.argv[2]), int(sys.argv[3])
    z = np.load(sys.argv[1])
    m = MoEConfig(**json.loads(sys.argv[4]))
    mesh = jax.make_mesh((D, M), ("data", "model"))
    fn = compat.shard_map(
        lambda xl, router, w1, wg, w2: moe.apply_moe_ep({"router": router, "w1": w1, "wg": wg, "w2": w2}, xl, m,
                                                        "silu", axis="model", stat_axes=("data", "model")),
        mesh=mesh, in_specs=(P(("data", "model"), None), P(None, None), P("model"), P("model"), P("model")),
        out_specs=(P(("data", "model"), None), P()))
    args = [jnp.asarray(z[k]) for k in ("x", "router", "w1", "wg", "w2")]
    cot, wa = jnp.asarray(z["cot"]), float(sys.argv[5])

    def loss(*a):
        y, aux = fn(*a)
        return jnp.sum(y * cot) + wa * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4), has_aux=True))(*args)
    np.savez(sys.argv[6], y=np.asarray(y), aux=np.asarray(aux), *[np.asarray(g) for g in grads])
    """
)


@functools.lru_cache(maxsize=None)
def _jax_moe_ep(D: int, M: int, tmp: str):
    x, p, cot = _ep_inputs()
    inp, out = os.path.join(tmp, f"in{D}x{M}.npz"), os.path.join(tmp, f"out{D}x{M}.npz")
    np.savez(inp, x=x, cot=cot, **p)
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={D * M}", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _EP_SCRIPT, inp, str(D), str(M), json.dumps(EP_MOE), str(EP_AUX),
                          out], env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    z = np.load(out)
    return z["y"], float(z["aux"]), [z[f"arr_{i}"] for i in range(5)]


def _jax_kept(D: int, M: int) -> np.ndarray:
    """Which of each shard's slots JAX's expert-parallel dispatch keeps end to
    end, from JAX's own ``route``, ``sorted_dispatch`` and
    ``gather_to_groups`` on each shard (the exchange done by hand): [T * k]."""
    from repro.configs.base import MoEConfig as JaxMoEConfig

    x, p, _ = _ep_inputs()
    m = _port_moe_config()
    jm = JaxMoEConfig(**EP_MOE)
    N, k, E_loc = D * M, m.top_k, m.num_experts // M
    T = EP_T // N
    Cs = jmoe._capacity(T * k, M, m.capacity_factor)
    Ce = jmoe._capacity(M * Cs, E_loc, m.capacity_factor)
    kept = []
    for d in range(D):
        shards = []
        for mm in range(M):
            lo = (d * M + mm) * T
            _, idx, _ = jmoe.route(jnp.asarray(p["router"]), jnp.asarray(x[lo:lo + T]), jm)
            ids = idx.reshape(-1)
            dev = ids // E_loc
            dest, keep = jmoe.sorted_dispatch(dev, M, Cs)
            send_e = jmoe.gather_to_groups((ids % E_loc + 1).astype(jnp.float32)[:, None], dev, dest, keep, M, Cs)
            shards.append((np.asarray(dev), np.asarray(dest), np.asarray(keep), np.asarray(send_e)[..., 0]))
        for mm in range(M):  # rank mm receives block mm of every shard of its data row
            flat_e = np.concatenate([shards[i][3][mm] for i in range(M)])
            valid = flat_e > 0
            eloc = np.where(valid, flat_e - 1, E_loc).astype(np.int32)
            _, keep2 = jmoe.sorted_dispatch(jnp.asarray(eloc), E_loc + 1, Ce)
            shards[mm] = shards[mm] + (np.asarray(keep2) & valid,)
        for i in range(M):
            dev, dest, keep, _ = shards[i][:4]
            final = keep.copy()
            for s in np.nonzero(keep)[0]:
                final[s] = shards[dev[s]][4][i * Cs + dest[s]]
            kept.append(final)
    return np.concatenate(kept)


@pytest.mark.parametrize("grid", EP_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_moe_ep_matches_jax_shard_map(results, grid, tmp_path_factory):
    """``apply_moe_ep`` on the ranks of the grid against JAX's under
    ``compat.shard_map`` at capacity factor 1.0 (slots dropped at both
    capacities): the output and aux within fp32 tolerance, the same slots
    kept end to end (against JAX's own dispatch on each shard), and the
    grads of x, the router and the experts."""
    D, M = grid
    ranks = results[f"ep-{D}x{M}"]
    y_want, aux_want, grads_want = _jax_moe_ep(D, M, str(tmp_path_factory.mktemp("ep")))
    y = np.concatenate([r["y"] for r in ranks])
    np.testing.assert_allclose(y, y_want, atol=1e-5, rtol=1e-4)
    assert all(abs(r["aux"] - aux_want) < 1e-5 for r in ranks)
    kept = np.concatenate([r["kept"] for r in ranks])
    np.testing.assert_array_equal(kept, _jax_kept(D, M))
    send = np.concatenate([r["send_kept"] for r in ranks])
    assert (~kept).sum() > (~send).sum() > 0  # slots dropped at both capacities
    _close(ranks[0]["grads"], grads_want, f"apply_moe_ep {D}x{M} grads", tol=dict(atol=1e-5, rtol=1e-4))


# ---------------------------------------------------------------------------
# the exchange, the trainer and the launcher on the ranks
# ---------------------------------------------------------------------------


def test_all_to_all_and_its_backward(results):
    """Block j of rank r goes to rank j; the backward sends each block's grad
    back to where it came from."""
    ranks = results["all_to_all"]
    M = len(ranks)
    for r, got in enumerate(ranks):
        want = (np.arange(M) * 100 + r).repeat(2)[:, None] * np.ones((1, 3), np.float32)
        np.testing.assert_array_equal(got["y"], want)
        np.testing.assert_array_equal(got["grad"], got["w_back"])
        assert not np.array_equal(got["grad"], np.arange(2 * M * 3).reshape(2 * M, 3) + 1000 * r)


@functools.lru_cache(maxsize=None)
def _meshless_trainer():
    cfg = port_config("moe-ample")
    steps = [_batch("moe-ample", seed) for seed in range(1, TRAIN_STEPS + 1)]
    trainer = Trainer(cfg, adam(lr=1e-3), iter(steps), params=to_tensors(_model("moe-ample")), device="cpu")
    trainer.run(TRAIN_STEPS, log_every=1, log=lambda line: None)
    return [h["loss"] for h in trainer.history], [h["grad_norm"] for h in trainer.history]


def test_trainer_trajectory_matches_meshless(results):
    """Three Adam steps of the MoE model on HYBRID 1 x 2 through ``Trainer``
    (each rank's blocks and moments, the donated update): the losses and
    grad norms of every step against the meshless trainer's."""
    got = results["trainer"][0]
    losses, norms = _meshless_trainer()
    np.testing.assert_allclose(got["loss"], losses, atol=LOSS_TOL)
    np.testing.assert_allclose(got["grad_norm"], norms, rtol=1e-3)
    assert got["loss"][-1] < got["loss"][0]


@pytest.mark.parametrize("name", list(LAUNCHES))
def test_launcher_trains_an_lm_on_a_grid(results, name):
    """``launch/train.py --mesh test --grid DxM`` with an LM arch, on the
    spawned ranks: the config line with the grid, and falling losses from
    rank 0 only."""
    lines = results[f"launch-{name}"]
    arch, shape = LAUNCHES[name][1], LAUNCHES[name][-1]
    head = lines[0][0]
    assert head.startswith(f"arch={arch}-smoke params=") and f"grid={shape}" in head and "mesh=test" in head
    losses = [float(line.split()[3]) for line in lines[0] if line.startswith("step")]
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    assert not lines[1]


# ---------------------------------------------------------------------------
# specs, placement and the reckoning (no ranks)
# ---------------------------------------------------------------------------


SPEC_ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")


def _dotted(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[1:]: tuple(tree)}
    return {k: v for key, sub in items for k, v in _dotted(sub, f"{prefix}.{key}").items()}


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_param_specs_match_jax_init_lm(arch):
    """``transformer.param_specs`` equals the spec tree JAX's ``init_lm``
    returns, leaf for leaf (the smoke configs: the specs do not depend on
    the widths), and its shapes ``param_shapes``'."""
    cfg = get_config(arch, smoke=True)
    params, specs = jtfm.init_lm(jax.random.key(0), jax_get_config(arch, smoke=True))
    want = jax.tree_util.tree_flatten_with_path(specs, is_leaf=lambda s: isinstance(s, tuple))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(s) for path, s in want}
    assert _dotted(tfm.param_specs(cfg)) == want
    shapes = jax.tree_util.tree_flatten_with_path(params)[0]
    shapes = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(a.shape) for path, a in shapes}
    assert _dotted(tfm.param_shapes(cfg)) == shapes


@functools.lru_cache(maxsize=None)
def _jax_shapes_and_specs(arch: str):
    shapes = jax.eval_shape(lambda key: jtfm.init_lm(key, jax_get_config(arch))[0], jax.random.key(0))
    return shapes, jtfm.init_lm(jax.random.key(0), jax_get_config(arch, smoke=True))[1]


@pytest.mark.parametrize("strategy", ["model", "hybrid", "hybrid_opt"])
@pytest.mark.parametrize("grid", [(1, 2), (2, 2), (1, 8), (2, 4)], ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_lm_placement_matches_jax_resolve_specs(arch, grid, strategy):
    """The plan's placement of the full-width LM equals JAX's
    ``resolve_specs`` on its spec tree, leaf by leaf (the attention's kv
    heads whole where they do not split, the experts on ``model``, FSDP on
    the widest eligible dim over ``data``)."""
    shapes, specs = _jax_shapes_and_specs(arch)
    mesh = SimpleNamespace(axis_names=("data", "model"), devices=np.empty(grid))
    placed = {key: jst.resolve_specs(specs[key], shapes[key], mesh, jst.Strategy(strategy),
                                     is_head=key in jst.HEAD_KEYS) for key in specs}
    flat = jax.tree_util.tree_flatten_with_path(placed, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(p) for path, p in flat}
    got = _dotted(ExecutionPlan(strategy=strategy, mesh=launch_train.GridShape(*grid)).placement(get_config(arch)))
    assert got == want
    if strategy == "hybrid_opt" and arch == "qwen3-moe-30b-a3b":
        if grid == (2, 4):  # experts on model, FSDP on d over data
            assert got["blocks.0.moe.w1"] == (None, "model", "data", None)
        if grid == (1, 8):  # the 4 kv heads stay whole on 8 ranks, the 32 q heads split
            assert got["blocks.0.attn.wk"][2] is None and got["blocks.0.attn.wq"][2] == "model"


def test_moe_235b_config_matches_jax():
    """``qwen3-moe-235b-a22b`` has the JAX package's fields."""
    got, want = get_config("qwen3-moe-235b-a22b"), jax_get_config("qwen3-moe-235b-a22b")
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)) if f.name == "moe" else a == b, f.name
    assert got.param_count() == want.param_count()


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
def test_reckoning_names_a_grid_the_model_fits(arch):
    """The launcher's per-rank reckoning refuses a grid the training state
    does not fit on one card of, naming the smallest test grid that fits,
    on which it passes."""
    cfg = get_config(arch)
    with pytest.raises(SystemExit, match=r"the smallest test grid it fits on is --mesh test --grid (\d+)x(\d+)") as e:
        launch_train.check_lm_state_fits(cfg, "cpu", "hybrid_opt", (1, 2))
    D, M = (int(v) for v in str(e.value).split("--grid ")[1].split(",")[0].split("x"))
    launch_train.check_lm_state_fits(cfg, "cpu", "hybrid_opt", (D, M))
    assert launch_train.lm_state_bytes(cfg, "hybrid_opt", (D, M)) <= launch_train.ONE_CARD_BYTES
    smaller = [(w // m, m) for w in range(1, D * M) for m in range(1, w + 1) if w % m == 0]
    assert all((launch_train.lm_state_bytes(cfg, "hybrid_opt", s) or float("inf")) > launch_train.ONE_CARD_BYTES
               for s in smaller)
