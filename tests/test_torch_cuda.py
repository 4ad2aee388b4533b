"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skip
elsewhere; they import nothing of JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_plain  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL_ATTN = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}  # kernel_harness's
TOL_TIGHT = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}  # kernel_harness's
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernel_harness.py's luong_attn shapes, the serving decode shape, and an all-masked row (row 1)
CASES = [
    (dict(B=2, N=16, M=12, h=64), None),
    (dict(B=4, N=32, M=8, h=32), None),
    (dict(B=1, N=64, M=33, h=128), None),
    (dict(B=3, N=10, M=7, h=48), None),
    (dict(B=2, N=1, M=1, h=16), None),
    (dict(B=4, N=1, M=64, h=1024), None),
    (dict(B=3, N=2, M=5, h=16), 1),
]


# kernel_harness.py's lstm_cell shapes (block sizes dropped) and the model's two full-width shapes
LSTM_SHAPES = [
    dict(B=8, In=16, H=32), dict(B=4, In=64, H=64), dict(B=16, In=24, H=128),
    dict(B=1, In=8, H=16), dict(B=6, In=24, H=40), dict(B=7, In=13, H=24),
    dict(B=64, In=512, H=1024), dict(B=64, In=1024, H=1024),
    dict(B=130, In=40, H=72),  # three row tiles of 64, the last ragged
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _lstm_inputs(s, dts, seed=0):
    """x, h, c, wx, wh, b on the card in the dtypes ``dts``: the harness's
    scales for its shapes, the model's (tanh-bounded states, fan-in
    weights) at H=1024."""
    rng = np.random.default_rng(seed)
    B, In, H = s["B"], s["In"], s["H"]
    model = H >= 1024
    f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    x, h, c = f((B, In)), f((B, H)), f((B, H))
    if model:
        x, h = torch.tanh(x), torch.tanh(h)
        wx, wh, b = f((In, 4, H), In**-0.5), f((H, 4, H), H**-0.5), f((4, H), 0.1)
    else:
        wx, wh, b = f((In, 4, H), 0.1), f((H, 4, H), 0.1), f((4, H), 0.1)
    return tuple(t.to(dt) for t, dt in zip((x, h, c, wx, wh, b), dts))


# the model's feed to the tensor-core kernel: x and the weights bf16, h and c fp32
BF16W_FEED = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16, torch.bfloat16)
LSTM_MMA_TOL = dict(atol=1e-4, rtol=1e-4)  # chip_smoke.py's: exact bf16 products, h kept as h_hi + h_lo
FEEDS = {
    "float32": ((torch.float32,) * 6, TOL_TIGHT["float32"]),
    "bfloat16": ((torch.bfloat16,) * 6, TOL_TIGHT["bfloat16"]),
    "model": ((torch.bfloat16,) + (torch.float32,) * 5, TOL_TIGHT["float32"]),
    "model_bf16w": (BF16W_FEED, LSTM_MMA_TOL),
}


@pytest.mark.parametrize("feed", list(FEEDS))
def test_lstm_kernel_matches_plain(cuda, feed):
    """All six inputs in one dtype at TOL_TIGHT; the old mixed feed (x bf16,
    h/c and fp32 weights) at fp32's: both sides take the same bf16 x into fp32
    products, and the outputs are fp32; and the model's feed (x and weights
    bf16, h/c fp32: the tensor-core kernel where In and H are multiples of 8)
    at LSTM_MMA_TOL."""
    dts, tol = FEEDS[feed]
    for s in LSTM_SHAPES:
        args = _lstm_inputs(s, dts)
        before = lstm_ops.lstm_cell_fused.launches
        got = lstm_ops.lstm_cell_fused(*args)
        torch.cuda.synchronize()
        assert lstm_ops.lstm_cell_fused.launches == before + 1
        want = lstm_cell_ref(*args)
        for g, w, ref_in in zip(got, want, args[1:3]):
            assert g.dtype == ref_in.dtype and g.shape == ref_in.shape
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol,
                                       err_msg=f"{s} {feed}")


def test_lstm_kernel_path_counters(cuda):
    """The per-path counters: the model's feed at In, H multiples of 8 runs the
    tensor-core kernel; the same feed at a ragged width, and the fp32 feed,
    run the FMA kernel; each call counts once in ``launches`` too."""
    fn = lstm_ops.lstm_cell_fused
    cases = [(LSTM_SHAPES[7], BF16W_FEED, "mma"), (LSTM_SHAPES[5], BF16W_FEED, "fma"),
             (LSTM_SHAPES[7], (torch.float32,) * 6, "fma")]
    for s, dts, path in cases:
        args = _lstm_inputs(s, dts)
        before = (fn.launches, fn.mma_launches, fn.fma_launches)
        fn(*args)
        torch.cuda.synchronize()
        after = (fn.launches, fn.mma_launches, fn.fma_launches)
        want = (1, int(path == "mma"), int(path == "fma"))
        assert tuple(a - b for a, b in zip(after, before)) == want, f"{s} {dts[3]}: expected the {path} kernel"


@pytest.mark.parametrize("feed,path", [("model_bf16w", "mma"), ("float32", "fma")])
@pytest.mark.parametrize("parts", [2, 4])
def test_lstm_column_shard_is_the_square_kernels_block(cuda, feed, path, parts):
    """The tensor-parallel backbone's column-shard cell (h [B, H] whole, c
    and the weights of H/parts units) at the model's widths: each shard
    against the plain version at its feed's tolerance, on the feed's kernel,
    and bit for bit the square kernel's column block on the same inputs."""
    dts, tol = FEEDS[feed]
    fn = lstm_ops.lstm_cell_fused
    for s in LSTM_SHAPES[6:8]:
        x, h, c, wx, wh, b = _lstm_inputs(s, dts)
        whole = fn(x, h, c, wx, wh, b)
        Hs = s["H"] // parts
        for r in range(parts):
            cols = slice(r * Hs, (r + 1) * Hs)
            args = (x, h, c[:, cols].contiguous(), wx[..., cols].contiguous(), wh[..., cols].contiguous(),
                    b[:, cols].contiguous())
            before = getattr(fn, f"{path}_launches")
            got = fn(*args)
            torch.cuda.synchronize()
            assert getattr(fn, f"{path}_launches") == before + 1, f"{s} shard {r}: expected the {path} kernel"
            assert torch.equal(got[0], whole[0][:, cols]) and torch.equal(got[1], whole[1][:, cols]), (s, r)
            for g, w in zip(got, lstm_cell_ref(*args)):
                np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol,
                                           err_msg=f"{s} shard {r} {feed}")


def test_lstm_backward_through_kernel_matches_plain(cuda):
    """fp32 grads of all six inputs through the kernel's Function (the
    analytic adjoint) equal autograd through the plain version."""
    for s in (LSTM_SHAPES[5], LSTM_SHAPES[7], LSTM_SHAPES[8]):
        args = _lstm_inputs(s, (torch.float32,) * 6, seed=1)
        rng = np.random.default_rng(2)
        dh = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        dc = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        grads = []
        for fn in (lstm_ops.lstm_cell_fused, lstm_cell_ref):
            ins = [a.clone().requires_grad_() for a in args]
            h_new, c_new = fn(*ins)
            grads.append(torch.autograd.grad((h_new * dh).sum() + (c_new * dc).sum(), ins))
        for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), *grads):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-4, err_msg=f"{s} d{name}")


def test_luong_backward_through_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, N, M, h = 4, 24, 20, 1024
    f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    H, S = torch.tanh(f((B, N, h))), torch.tanh(f((B, M, h)))
    wa, wc = f((h, h), h**-0.5), f((2 * h, h), (2 * h) ** -0.5)
    mask = torch.from_numpy(rng.random((B, M)) > 0.2).cuda()
    mask[:, 0] = True
    dout = f((B, N, h))
    grads = []
    for fused in (True, False):
        ins = [t.clone().requires_grad_() for t in (H, S, wa, wc)]
        if fused:
            out = ops.luong_attention_fused(ins[0], ins[1], mask, ins[2], ins[3])
        else:
            out = luong_attention_ref(ins[0], ins[1], mask, ins[2], ins[3][:h], ins[3][h:])
        grads.append(torch.autograd.grad((out * dout).sum(), ins))
    for name, g, w in zip(("H", "S", "w_alpha", "w_c"), *grads):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_luong_kernel_matches_plain(cuda):
    for s, masked in CASES:
        for dname, dt in TORCH_DT.items():
            rng = np.random.default_rng(0)
            B, N, M, h = s["B"], s["N"], s["M"], s["h"]
            f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
                (rng.normal(size=shape) * scale).astype(np.float32)).to("cuda", dt)
            H, S, wa, wc = f((B, N, h)), f((B, M, h)), f((h, h), 0.1), f((2 * h, h), 0.1)
            mask = rng.random((B, M)) > 0.2
            mask[:, 0] = True
            if masked is not None:
                mask[masked] = False
            mask = torch.from_numpy(mask).cuda()
            before = ops.luong_attention_fused.launches
            got = ops.luong_attention_fused(H, S, mask, wa, wc)
            torch.cuda.synchronize()
            assert ops.luong_attention_fused.launches == before + 1
            want = luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
            np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL_ATTN[dname],
                                       err_msg=f"{s} {dname}")


# (B, N, M, h, all-masked row) for the luong routes that take them: decode ticks (R <= 32), ragged
# rows, one and 129 source positions, the training step's 2048 rows
LUONG_ROUTE_CASES = [
    (4, 1, 64, 1024, None), (8, 1, 129, 1024, None), (32, 1, 64, 1024, None), (4, 1, 1, 1024, None),
    (3, 2, 5, 64, 1), (2, 16, 12, 64, None), (3, 43, 20, 1024, None), (4, 48, 40, 1024, 2), (2, 40, 1, 1024, None),
    (64, 32, 32, 1024, None),
]


def _luong_inputs(B, N, M, h, masked, seed=0):
    """bf16 inputs on the card at chip_smoke.py's model scales (tanh states, W_c at
    its fan-in scale, W_a at an eighth of it); int32 mask, 20% masked."""
    rng = np.random.default_rng(seed)
    f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    H, S = torch.tanh(f((B, N, h))), torch.tanh(f((B, M, h)))
    wa, wc = f((h, h), h**-0.5 / 8), f((2 * h, h), (2 * h) ** -0.5)
    mask = rng.random((B, M)) > 0.2
    mask[:, 0] = True
    if masked is not None:
        mask[masked] = False
    return [t.to(torch.bfloat16) for t in (H, S)] + [torch.from_numpy(mask).cuda()] + [
        t.to(torch.bfloat16) for t in (wa, wc)]


def _luong_bf16_errors(got, want):
    d = got.float() - want
    return (d.norm() / want.norm()).item(), d.abs().max().item()


@pytest.mark.parametrize("route", ["decode", "wgmma"])
def test_luong_route_within_rounding_bound(cuda, route):
    """Each new route on bf16 inputs against the plain version's fp32 output:
    within twice the error of that output's own bf16 rounding (relative L2
    and max abs), bit-identical over two calls, counted on its route; a
    control with each row's last unmasked position dropped misses the bound."""
    for B, N, M, h, masked in LUONG_ROUTE_CASES:
        if not ops.route_fits(route, torch.bfloat16, h, B * N):
            continue
        H, S, mask, wa, wc = _luong_inputs(B, N, M, h, masked)
        want = luong_attention_ref(H.float(), S.float(), mask, wa.float(), wc[:h].float(), wc[h:].float())
        own_rel, own_err = _luong_bf16_errors(want.to(torch.bfloat16), want)
        before = ops.luong_attention_fused.launches_by_route[route]
        got = ops.luong_attention_fused(H, S, mask, wa, wc, route=route)
        again = ops.luong_attention_fused(H, S, mask, wa, wc, route=route)
        torch.cuda.synchronize()
        assert ops.luong_attention_fused.launches_by_route[route] == before + 2
        assert torch.equal(got, again)
        rel, err = _luong_bf16_errors(got, want)
        assert rel <= 2 * own_rel and err <= 2 * own_err, (B, N, M, h, rel, own_rel, err, own_err)
        if M > 1:
            cut = mask.clone()
            last = torch.where(cut, torch.arange(M, device="cuda"), -1).max(dim=1).values
            rows = torch.nonzero(last >= 0).squeeze(1)
            cut[rows, last[rows]] = False
            c_rel, c_err = _luong_bf16_errors(ops.luong_attention_fused(H, S, cut, wa, wc, route=route), want)
            assert c_rel > 2 * own_rel or c_err > 2 * own_err, (B, N, M, h, "control within the bound")


def test_luong_pick_route_on_card(cuda):
    """The wrapper's pick runs: the decode tick on "decode", the training
    step's rows on "wgmma", fp32 on "fma"; each call counts once."""
    for (B, N, M, h), dt, route in (((4, 1, 64, 1024), torch.bfloat16, "decode"),
                                    ((64, 32, 32, 1024), torch.bfloat16, "wgmma"),
                                    ((4, 1, 64, 1024), torch.float32, "fma")):
        H, S, mask, wa, wc = (t.to(dt) if t.is_floating_point() else t for t in _luong_inputs(B, N, M, h, None))
        before = dict(ops.luong_attention_fused.launches_by_route), ops.luong_attention_fused.launches
        ops.luong_attention_fused(H, S, mask, wa, wc)
        torch.cuda.synchronize()
        after = ops.luong_attention_fused.launches_by_route
        assert ops.luong_attention_fused.launches == before[1] + 1
        assert {r: after[r] - before[0][r] for r in after} == {r: int(r == route) for r in after}


# kernel_harness.py's flash_attn shapes (blocks dropped), ragged S != T
# shapes, the serving prefill's full-width per-layer call (qwen3-1.7b:
# B=4, S=2048, 16 q heads on 8 kv heads, D=128, window 4096), then shapes at
# the wgmma kernel's edges: ragged S != T with odd G, D=64 at G=1 without the
# causal mask, one row, G=8 with a window
FLASH_SHAPES = [
    dict(B=2, S=128, T=128, KV=2, G=2, D=32, causal=True, window=None),
    dict(B=1, S=256, T=256, KV=1, G=4, D=64, causal=True, window=64),
    dict(B=2, S=64, T=64, KV=4, G=1, D=16, causal=False, window=None),
    dict(B=1, S=128, T=128, KV=2, G=1, D=128, causal=True, window=32),
    dict(B=1, S=96, T=96, KV=1, G=2, D=32, causal=True, window=None),
    dict(B=1, S=32, T=32, KV=1, G=1, D=8, causal=True, window=1),
    dict(B=2, S=77, T=131, KV=2, G=3, D=40, causal=False, window=50),
    dict(B=2, S=77, T=131, KV=2, G=3, D=48, causal=True, window=50),
    dict(B=4, S=2048, T=2048, KV=8, G=2, D=128, causal=True, window=4096),
    dict(B=2, S=77, T=131, KV=2, G=3, D=128, causal=True, window=50),
    dict(B=2, S=200, T=200, KV=3, G=1, D=64, causal=False, window=None),
    dict(B=2, S=1, T=1, KV=2, G=2, D=128, causal=True, window=None),
    dict(B=1, S=300, T=300, KV=2, G=8, D=128, causal=True, window=100),
]


# bf16 against the plain version's fp32 output on the same bf16 inputs: only
# the kernel's own rounding is left (P in bf16, the output in bf16)
FLASH_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FLASH_BF16_REL_L2 = 1e-2


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain(cuda, dname):
    """fp32 runs the FMA kernel; bf16 the wgmma kernel at D=64 and 128, the
    mma.sync kernel at other multiples of 16 and the FMA kernel at D=8 and
    D=40."""
    for s in FLASH_SHAPES:
        rng = np.random.default_rng(0)
        B, S, T, KV, G, D = s["B"], s["S"], s["T"], s["KV"], s["G"], s["D"]
        f = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", TORCH_DT[dname])  # noqa: E731
        q, k, v = f((B * KV * G, S, D)), f((B * KV, T, D)), f((B * KV, T, D))
        kw = dict(causal=s["causal"], window=s["window"], group=G)
        before = flash_ops.flash_attention_fused.launches
        got = flash_ops.flash_attention_fused(q, k, v, **kw)
        torch.cuda.synchronize()
        assert flash_ops.flash_attention_fused.launches == before + 1
        want = flash_attention_plain(q, k, v, **kw)
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL_ATTN[dname],
                                   err_msg=f"{s} {dname}")
        if dname == "bfloat16":
            want32 = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
            np.testing.assert_allclose(got.float().cpu().numpy(), want32.cpu().numpy(), **FLASH_BF16_TOL,
                                       err_msg=f"{s} bf16 vs the plain version's fp32 output")
            rel = ((got.float() - want32).norm() / want32.norm()).item()
            assert rel <= FLASH_BF16_REL_L2, (s, rel)


def test_flash_routes_and_determinism(cuda):
    """bf16 on every route that takes the inputs: the launch counts on the
    route it names (the pick when none is named), the output matches the
    plain version's fp32 output, and two calls are bit-identical.  The entry
    point itself refuses a route that does not fit (fp32 on the wgmma
    kernel, D=40 on the mma.sync kernel)."""
    import ctypes

    rng = np.random.default_rng(3)
    for B, S, T, KV, G, D, causal, window in [(2, 77, 131, 2, 3, 128, True, 50), (1, 300, 300, 2, 8, 128, True, 100),
                                              (2, 200, 200, 3, 1, 64, False, None), (1, 96, 96, 1, 2, 32, True, None)]:
        f = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", torch.bfloat16)  # noqa: E731
        q, k, v = f((B * KV * G, S, D)), f((B * KV, T, D)), f((B * KV, T, D))
        kw = dict(causal=causal, window=window, group=G)
        want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        for route in [None] + [r for r in flash_ops.ROUTES if flash_ops.route_fits(r, torch.bfloat16, D)]:
            named = route or flash_ops.pick_route(torch.bfloat16, D)
            before = dict(flash_ops.flash_attention_fused.launches_by_route)
            got = flash_ops.flash_attention_fused(q, k, v, route=route, **kw)
            again = flash_ops.flash_attention_fused(q, k, v, route=route, **kw)
            torch.cuda.synchronize()
            after = flash_ops.flash_attention_fused.launches_by_route
            assert {r: after[r] - before[r] for r in after} == {r: 2 * (r == named) for r in after}, (D, route)
            assert torch.equal(got, again), (D, named)
            np.testing.assert_allclose(got.float().cpu().numpy(), want.cpu().numpy(), **FLASH_BF16_TOL,
                                       err_msg=f"D={D} {named}")
            assert ((got.float() - want).norm() / want.norm()).item() <= FLASH_BF16_REL_L2, (D, named)
    lib = flash_ops._library()
    x32, x40 = torch.zeros(2, 8, 128, device="cuda"), torch.zeros(2, 8, 40, device="cuda", dtype=torch.bfloat16)
    stream = torch.cuda.current_stream().cuda_stream
    for x, dtype_code, route in ((x32, 0, flash_ops.ROUTES["wgmma"]), (x40, 1, flash_ops.ROUTES["mma"])):
        ptr = x.data_ptr()
        err = lib.flash_attn_forward(ptr, ptr, ptr, ptr, 2, 8, 8, x.shape[-1], 1, 1, 0, dtype_code, route,
                                     ctypes.c_float(1.0), stream)
        assert err != 0, (x.dtype, route)


def test_flash_flat_layout_matches_grouped(cuda):
    """The flat [B,S,H,1,D] layout regroups to [B,S,KV,H/KV,D] before the
    launch: the same numbers as the grouped call."""
    rng = np.random.default_rng(1)
    B, S, KV, G, D = 2, 300, 4, 2, 64
    f = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", torch.bfloat16)  # noqa: E731
    q, k, v = f((B, S, KV, G, D)), f((B, S, KV, D)), f((B, S, KV, D))
    grouped = flash_ops.flash_attention(q, k, v, causal=True, window=100)
    flat = flash_ops.flash_attention(q.reshape(B, S, KV * G, 1, D), k, v, causal=True, window=100)
    torch.cuda.synchronize()
    assert torch.equal(flat.reshape(grouped.shape), grouped)


def test_graphed_decode_matches_eager(cuda):
    """ServeEngine's greedy decode replays a CUDA graph of the step: the same
    tokens as the eager steps, on both sides of the window, fp32."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ServePlan
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True), num_kv_heads=2, dtype="float32")
    engine = ServeEngine(cfg, tfm.init_lm(0, cfg, device="cuda"), plan=ServePlan.for_config(cfg, max_len=64))
    rng = np.random.default_rng(0)
    for S, steps in ((40, 12), (50, 24), (100, 8)):
        prompts = rng.integers(3, cfg.vocab_size, size=(2, S))
        graphed = engine.generate(prompts, steps)
        eager = engine.generate(prompts, steps, cuda_graph=False)
        assert graphed.tolist() == eager.tolist(), (S, steps)


# kernel_harness.py's moe_gemm shapes (blocks dropped; the last takes only the
# FMA kernel in bf16, as F=36 is not a multiple of 8), a shape whose every tile is
# ragged on the tensor-core path, one with several K tiles around the copy
# ring, and the serving decode step's per-expert call (C=1) on 8 experts
MOE_SHAPES = [
    dict(E=4, C=16, d=32, F=64), dict(E=2, C=8, d=64, F=96), dict(E=8, C=32, d=16, F=16),
    dict(E=1, C=1, d=16, F=16), dict(E=3, C=10, d=24, F=36),
    dict(E=2, C=70, d=40, F=72), dict(E=4, C=130, d=256, F=192), dict(E=8, C=1, d=2048, F=768),
]
# bf16 against the plain version's fp32 output on the same bf16 inputs: only
# the kernel's own rounding is left (h and the output in bf16)
MOE_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
MOE_BF16_REL_L2 = 1e-2


def _moe_inputs(s, dtype, seed=0):
    """x, w1, wg, w2 on the card: the harness's scales (x N(0,1), weights
    0.1 N(0,1)) below d=256, the model's (unit-RMS rows, fan-in weights)
    from there; rows 2-3 of every expert are empty slots (zeros)."""
    rng = np.random.default_rng(seed)
    E, C, d, F = s["E"], s["C"], s["d"], s["F"]
    model = d >= 256
    f = lambda shape, scale: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()  # noqa: E731
    x = f((E, C, d), 1.0)
    x[:, 2:4] = 0
    w1, wg = f((E, d, F), d**-0.5 if model else 0.1), f((E, d, F), d**-0.5 if model else 0.1)
    w2 = f((E, F, d), F**-0.5 if model else 0.1)
    return tuple(t.to(dtype) for t in (x, w1, wg, w2))


# shapes for the "wgmma" and "decode" routes (d and F multiples of 64): a
# row tile with one live half, column tiles past F and d (F=192, d=320),
# several tiles of the prefill's C, C of 2-16 for the decode route
MOE_WIDE_SHAPES = [
    dict(E=2, C=130, d=128, F=128), dict(E=3, C=200, d=320, F=192), dict(E=5, C=641, d=256, F=384),
    dict(E=6, C=16, d=256, F=192), dict(E=5, C=7, d=128, F=64), dict(E=3, C=2, d=64, F=128),
    dict(E=8, C=1, d=2048, F=768),
]


def _moe_rows(s, kind, seed=0):
    """rows int32 [E] on the card: None, or "mixed" (0, C and values between)."""
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    r = rng.integers(0, s["C"] + 1, size=s["E"])
    r[:2] = [0, s["C"]][: s["E"]]
    r[-1] = s["C"]  # at least one expert holds rows
    return torch.from_numpy(r.astype(np.int32)).cuda()


def _moe_check(args, rows, route, dname):
    """One call on ``route`` against the plain version: TOL_TIGHT against its
    output in the inputs' dtype and, in bf16, MOE_BF16_TOL and
    MOE_BF16_REL_L2 against its fp32 output; rows past rows[e] (which hold
    NaN and 1e4) exactly zero; empty slots exactly zero; the launch counted
    on the route."""
    E, C = args[0].shape[:2]
    if rows is not None:
        dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
        args[0][dead] = 1e4
        args[0][:, ::2][dead[:, ::2]] = float("nan")
    before = dict(moe_ops.moe_gemm_fused.launches_by_route)
    got = moe_ops.moe_gemm_fused(*args, rows, route=route)
    torch.cuda.synchronize()
    assert moe_ops.moe_gemm_fused.launches_by_route[route] == before[route] + 1
    assert got.dtype == args[0].dtype and got.shape == args[0].shape
    if rows is not None:
        assert torch.count_nonzero(got[dead]) == 0 and not torch.isnan(got).any(), route
    if C > 3:
        assert torch.count_nonzero(got[:, 2:4]) == 0, route
    want = moe_gemm_plain(*args, rows)
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL_TIGHT[dname],
                               err_msg=f"{route} {tuple(args[0].shape)} {dname}")
    if dname == "bfloat16":
        want32 = moe_gemm_plain(*(t.float() for t in args), rows)
        np.testing.assert_allclose(got.float().cpu().numpy(), want32.cpu().numpy(), **MOE_BF16_TOL,
                                   err_msg=f"{route} {tuple(args[0].shape)} bf16 vs the plain version's fp32 output")
        rel = ((got.float() - want32).norm() / want32.norm()).item()
        assert rel <= MOE_BF16_REL_L2, (route, tuple(args[0].shape), rel)


@pytest.mark.parametrize("rows_kind", [None, "mixed"])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_moe_gemm_kernel_matches_plain(cuda, dname, rows_kind):
    """fp32 runs the FMA kernels (TOL_TIGHT); bf16 every route that takes the
    shape: the mma.sync kernels where d and F are multiples of 8, the FMA
    kernels at any width, and at the wide shapes the wgmma and (C <= 16) the
    decode kernels, held against the plain version's bf16 output (TOL_TIGHT)
    and its fp32 output (MOE_BF16_TOL, relative L2).  With rows, the rows
    past rows[e] come back exactly zero whatever x holds there."""
    dtype = TORCH_DT[dname]
    for s in MOE_SHAPES + MOE_WIDE_SHAPES:
        E, C, d, F = s["E"], s["C"], s["d"], s["F"]
        for route in moe_ops.ROUTES:
            if moe_ops.route_fits(route, dtype, E, C, d, F):
                _moe_check(list(_moe_inputs(s, dtype)), _moe_rows(s, rows_kind), route, dname)


def test_moe_gemm_picks_the_new_routes(cuda):
    """bf16 at the MoE LM's widths: the decode kernels at C <= 16, the wgmma
    kernels above; each call launches once, on its route."""
    for s, want in ((dict(E=8, C=1, d=2048, F=768), "decode"), (dict(E=8, C=16, d=256, F=192), "decode"),
                    (dict(E=4, C=17, d=256, F=192), "wgmma"), (dict(E=4, C=300, d=2048, F=768), "wgmma")):
        args = _moe_inputs(s, torch.bfloat16)
        moe_ops.reset_launches()
        moe_ops.moe_gemm_fused(*args)
        assert moe_ops.moe_gemm_fused.launches == 1 and moe_ops.moe_gemm_fused.launches_by_route[want] == 1, s


def test_graphed_moe_decode_matches_eager(cuda):
    """The MoE decode step captures into ServeEngine's CUDA graph: the same
    tokens as the eager steps, fp32, on both sides of the window; a graphed
    generate launches moe_gemm once per layer in the prefill, the eager step
    and the capture (the replays launch it from the graph)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ServePlan
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    cfg = dataclasses.replace(cfg, num_kv_heads=2, dtype="float32",
                              moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2))
    engine = ServeEngine(cfg, tfm.init_lm(0, cfg, device="cuda"), plan=ServePlan.for_config(cfg, max_len=64))
    rng = np.random.default_rng(0)
    for S, steps in ((40, 12), (50, 24), (100, 8)):
        prompts = rng.integers(3, cfg.vocab_size, size=(2, S))
        moe_ops.moe_gemm_fused.launches = 0
        graphed = engine.generate(prompts, steps)
        assert moe_ops.moe_gemm_fused.launches == 3 * cfg.num_layers
        eager = engine.generate(prompts, steps, cuda_graph=False)
        assert graphed.tolist() == eager.tolist(), (S, steps)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "zerobubble"])
def test_hybrid_pipelined_step_matches_meshless_on_card(cuda, schedule):
    """``chip_smoke.py``'s hybrid phase (a) at the smoke width (four layers):
    the HYBRID pipelined step (micro_batches 2) on the trivial 1 x 1 grid
    over NCCL, fp32 with dropout 0.3, against the meshless step on the same
    batch and generator seed (loss within 1e-4, every grad leaf at atol 1e-4
    / rtol 1e-3); its lstm_cell launches are the meshless micro_batches=2
    step's plus the backward's recompute (k x layers x (M + N)), its
    luong_attn launches one (the head runs once on the whole batch)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.data import MTBatchIterator, SyntheticMTTask
    from repro_torch.launch.mesh import make_grid
    from repro_torch.models import seq2seq as s2s
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.trainer import batch_to_device, make_grad_fn

    cfg = dataclasses.replace(get_config("seq2seq-rnn", smoke=True), num_layers=4, dtype="float32", dropout=0.3)
    params = s2s.init_seq2seq(0, cfg, device="cuda")
    batch = batch_to_device(next(MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), 8, seed=0)), "cuda")
    M, N = batch["src"].shape[1], batch["tgt_in"].shape[1]

    def run(plan):
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        lstm_ops.lstm_cell_fused.launches = 0
        ops.reset_launches()
        out = make_grad_fn(cfg, plan)(params, batch, g)
        return out, lstm_ops.lstm_cell_fused.launches, ops.luong_attention_fused.launches

    (loss, _, grads), _, _ = run(ExecutionPlan(stage_kernel="cuda"))
    _, accum_lstm, accum_luong = run(ExecutionPlan(stage_kernel="cuda", micro_batches=2))
    with make_grid(1, 1, device="cuda") as grid:
        assert grid.backend == "nccl"
        plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=2, schedule=schedule)
        (ploss, _, pgrads), n_lstm, n_luong = run(plan)
    assert abs(float(ploss) - float(loss)) < 1e-4
    for i, (a, b) in enumerate(zip(tree_leaves(pgrads), tree_leaves(grads))):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-3, msg=f"grad leaf {i}")
    assert accum_lstm == 2 * cfg.num_layers * (M + N) and accum_luong == 2
    assert n_lstm == accum_lstm + 2 * cfg.num_layers * (M + N) and n_luong == 1


# ---------------------------------------------------------------------------
# LM training: the recompute backwards of flash_attn and moe_gemm
# ---------------------------------------------------------------------------


def _grads(fn, ins, cot):
    live = [t.detach().clone().requires_grad_() for t in ins]
    return torch.autograd.grad((fn(*live).float() * cot).sum(), live)


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_flash_backward_through_function_matches_plain(cuda, dname):
    """dq, dk, dv through ``flash_attention_fused``'s Function (the kernel
    forward, the plain recompute backward) against autograd through the plain
    version on the same inputs, at G=2 causal and G=4 with a window; the
    grads come back in the inputs' dtype."""
    dt = TORCH_DT[dname]
    rng = np.random.default_rng(4)
    for BKV, G, S, D, window in ((4, 2, 130, 64, None), (2, 4, 96, 128, 40)):
        q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).cuda().to(dt)
                   for shape in ((BKV * G, S, D), (BKV, S, D), (BKV, S, D)))
        cot = torch.from_numpy(rng.normal(size=(BKV * G, S, D)).astype(np.float32)).cuda()
        kw = dict(causal=True, window=window, group=G)
        got = _grads(lambda a, b, c: flash_ops.flash_attention_fused(a, b, c, **kw), (q, k, v), cot)
        block = dict(block_q=flash_ops.BACKWARD_BLOCK, block_kv=flash_ops.BACKWARD_BLOCK)
        want = _grads(lambda a, b, c: flash_attention_plain(a, b, c, **kw, **block), (q, k, v), cot)
        for name, g, w in zip("qkv", got, want):
            assert g.dtype == dt
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4, msg=f"d{name} G={G}")


@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_moe_gemm_backward_through_function_matches_plain(cuda, dname):
    """dx, dw1, dwg, dw2 through ``moe_gemm_fused``'s Function with ``rows``
    (NaN planted past them) against autograd through the plain version; dx
    past rows[e] is exactly zero."""
    dt = TORCH_DT[dname]
    gen = torch.Generator(device="cuda").manual_seed(5)
    E, C, d, F = 4, 40, 128, 192
    x = torch.randn((E, C, d), generator=gen, device="cuda")
    w1, wg = (torch.randn((E, d, F), generator=gen, device="cuda") * d**-0.5 for _ in range(2))
    w2 = torch.randn((E, F, d), generator=gen, device="cuda") * F**-0.5
    rows = torch.tensor([0, 40, 17, 1], dtype=torch.int32, device="cuda")
    dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
    x[dead] = float("nan")
    ins = tuple(t.to(dt) for t in (x, w1, wg, w2))
    cot = torch.randn((E, C, d), generator=gen, device="cuda")
    got = _grads(lambda *a: moe_ops.moe_gemm_fused(*a, rows), ins, cot)
    want = _grads(lambda *a: moe_gemm_plain(*a, rows), ins, cot)
    assert torch.isfinite(got[0]).all() and not got[0][dead].any()
    for name, g, w in zip(("x", "w1", "wg", "w2"), got, want):
        assert g.dtype == dt
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-4, msg=f"d{name}")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-moe-30b-a3b"])
def test_lm_bf16_train_step_kernel_path_vs_plain_path(cuda, arch):
    """One bf16 step of the smoke-width LM (remat on) on the kernel path
    (flash_attn on "wgmma" and, for the MoE model, moe_gemm on "wgmma": each
    twice a layer, the forward and the recompute) against the plain path:
    the loss within 0.03 (the port's bf16 training bound) and, for the dense
    model, every grad leaf within 0.1 of its max magnitude (the MoE model's
    bf16 grads move with the router's top-k picks)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.plan import ExecutionPlan
    from repro_torch.data import LMBatchIterator, SyntheticLMTask
    from repro_torch.models import transformer as tfm
    from repro_torch.models.common import tree_leaves
    from repro_torch.train.trainer import batch_to_device, make_grad_fn

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params = tfm.init_lm(0, cfg, device="cuda")
    batch = batch_to_device(next(LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), 4, 256)), "cuda")
    flash_ops.reset_launches()
    moe_ops.reset_launches()
    loss, _, grads = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda"))(params, batch)
    L = cfg.num_layers
    fused = flash_ops.flash_attention_fused
    assert fused.launches_by_route["wgmma"] == fused.launches == 2 * L
    want_moe = 2 * L if cfg.moe is not None else 0
    assert moe_ops.moe_gemm_fused.launches_by_route["wgmma"] == moe_ops.moe_gemm_fused.launches == want_moe
    ploss, _, pgrads = make_grad_fn(cfg, ExecutionPlan(stage_kernel="torch"))(params, batch)
    assert abs(float(loss) - float(ploss)) < 0.03
    for i, (g, p) in enumerate(zip(tree_leaves(grads), tree_leaves(pgrads))):
        assert g.dtype == torch.float32 and torch.isfinite(g).all(), i
        if cfg.moe is None:
            assert (g - p).abs().max().item() < 0.1 * p.abs().max().item(), i
