"""The training path's CUDA kernels against their plain PyTorch versions on
the card: the flash forward's log-sum-exp output, the hand-written flash
backward (``csrc/flash_attention_bwd.cu``) and the SSD scan's backward
(``csrc/ssd_bwd.cu``).  Every test needs an NVIDIA
GPU and ``nvcc``, carries the ``cuda`` marker and skips without a GPU.
The file imports no JAX, so it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_train.py

Tolerances: the backward rounds p and ds to bf16 at the same points as the
plain version, but its float32 sums run in another order (dq's across key
blocks in an order that changes from run to run) and its exp is
``ex2.approx`` with log2(e) folded into the scale, which can flip one
rounding of p or ds; dq, dk and dv are
each held to two bf16 steps at their own largest magnitude and 1% in
relative Frobenius norm.  The forward's lse is float32 on both sides (the
kernel's exp2 with log2(e) folded in): within 1e-3.

The SSD backward against ``ref.ssd_bwd_ref`` on the same inputs and the
same forward workspaces (float32 both; the kernel's products are 3xTF32,
about 2^-20 of a product dropped, and its sums run in another order):
dxdt, db, dc and dh0 within 1e-4 relative Frobenius norm, dda within 1e-3
(a reverse cumsum over the chunk of row less column sums, which collects
the rounding of every product in it).
"""

import pytest
import torch

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd import ref as SR

BF16_STEPS = 2
FROBENIUS = 1e-2
LSE_ATOL = 1e-3
SSD_BWD_FROBENIUS = {"dxdt": 1e-4, "dda": 1e-3, "db": 1e-4, "dc": 1e-4, "dh0": 1e-4}

# SSD backward shapes (B, L, H, P, N, G, chunk, dh_final): small ones (a
# ragged 64-token tile at chunk 100; N 128 at Mamba2's width, P 32; G = H)
# and Zamba2-7B's training micro-batch
SSD_SHAPES = [
    (2, 300, 4, 32, 16, 2, 100, True),
    (1, 512, 4, 64, 128, 1, 256, False),
    (2, 192, 6, 16, 8, 6, 64, True),
    (1, 4096, 112, 64, 64, 2, 256, False),
]

# (b, sq, skv, hp, hkv, hd, causal, window, kv_valid, q offset)
SHAPES = [
    (2, 256, 256, 9, 3, 64, True, 0, None, 0),      # SmolLM's heads, causal
    (1, 300, 300, 9, 3, 64, True, 64, None, 0),     # a 64-key window, ragged tiles
    (2, 200, 256, 6, 6, 64, False, 0, (230, 256), 0),  # Whisper-like encoder: kv_valid < Skv
    (2, 64, 200, 6, 6, 64, False, 0, (200, 180), 0),   # cross attention, Sq != Skv
    (1, 130, 130, 4, 4, 128, True, 0, None, 0),     # hd 128
    (2, 96, 160, 8, 1, 16, True, 0, (160, 150), 64),  # rep 8, queries at an offset
    (1, 72, 72, 7, 7, 112, True, 0, None, 0),       # hd 112
    (2, 512, 512, 48, 8, 128, True, 0, None, 0),    # Nemotron-4-15B's heads: rep 6, hd 128
    # queries at an offset into their keys: each row sees five 128-key
    # blocks, whose dq parts the float32 workspace sums
    (1, 192, 640, 6, 2, 64, True, 0, None, 448),
]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def _inputs(dev, shape, seed=0):
    b, sq, skv, hp, hkv, hd, causal, window, kv_valid, off = shape
    g = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=g, device=dev).to(torch.bfloat16)

    q, k, v, dout = r(b, sq, hp, hd), r(b, skv, hkv, hd), r(b, skv, hkv, hd), r(b, sq, hp, hd)
    q_pos = (off + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq).contiguous()
    if kv_valid is None:
        kv = torch.full((b,), off + sq if causal else skv, dtype=torch.int32, device=dev)
    else:
        kv = torch.tensor(kv_valid, dtype=torch.int32, device=dev)[:b]
    return q, k, v, dout, q_pos, kv


def _close(name, got, want):
    w = want.float()
    top = float(w.abs().max())
    step = 2.0 ** (torch.floor(torch.log2(torch.tensor(top))).item() - 7)
    err = float((got.float() - w).abs().max())
    assert err <= BF16_STEPS * step, f"{name}: max error {err} against {BF16_STEPS} x {step}"
    frob = float((got.float() - w).norm() / w.norm())
    assert frob <= FROBENIUS, f"{name}: relative Frobenius error {frob}"


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_flash_forward_writes_the_plain_lse(shape):
    dev = _cuda()
    b, sq, skv, hp, hkv, hd, causal, window, _, _ = shape
    q, k, v, _, q_pos, kv = _inputs(dev, shape)
    out, lse = FK.flash_attention(q, k, v, q_pos, kv, causal=causal, window=window, lse=True)
    want_out, want_lse = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv,
                                                causal=causal, window=window, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, FK.flash_attention(q, k, v, q_pos, kv, causal=causal, window=window))
    assert float((lse - want_lse).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
def test_cuda_flash_split_forward_merges_the_lse():
    """A chunk at an offset into a long cache splits its keys: the merge
    kernel writes lse from the max and sum it merges the output with."""
    dev = _cuda()
    q, k, v, _, q_pos, kv = _inputs(dev, (1, 64, 2048, 9, 3, 64, True, 0, (2048,), 1984))
    assert FK.plan(1, 64, 2048, 9, 3, 64, 2048)["splits"] > 1
    _, lse = FK.flash_attention(q, k, v, q_pos, kv, causal=True, window=0, valid=2048, lse=True)
    _, want = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv, return_lse=True)
    torch.cuda.synchronize()
    assert float((lse - want).abs().max()) <= LSE_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_flash_backward_matches_plain(shape):
    dev = _cuda()
    b, sq, skv, hp, hkv, hd, causal, window, _, _ = shape
    q, k, v, dout, q_pos, kv = _inputs(dev, shape)
    out, lse = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv, causal=causal,
                                      window=window, return_lse=True)
    out = out.contiguous()
    FK.reset_launches()
    got = FK.flash_attention_bwd(q, k, v, out, dout, lse, q_pos, kv, causal=causal,
                                 window=window)
    want = FR.flash_attention_bwd_ref(q, k, v, out, dout, lse, q_pos=q_pos, kv_valid=kv,
                                      causal=causal, window=window)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention_bwd"] == 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _close(name, g, w)


@pytest.mark.cuda
def test_cuda_autograd_runs_both_kernels_once():
    """A differentiable call on the card launches the forward once and, at
    backward, the backward kernel once, and its gradients are the plain
    Function's on the same inputs."""
    dev = _cuda()
    shape = SHAPES[0]
    q, k, v, dout, q_pos, kv = _inputs(dev, shape)
    FK.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = FO.flash_attention(*leaves, q_pos=q_pos, kv_valid=kv)
    out.backward(dout)
    torch.cuda.synchronize()
    assert FK.LAUNCHES == {"flash_attention": 1, "flash_attention_bwd": 1}
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ref = FO.flash_attention(*cpu, q_pos=q_pos.cpu(), kv_valid=kv.cpu())
    ref.backward(dout.cpu())
    for name, g, w in zip(("dq", "dk", "dv"), leaves, cpu):
        _close(name, g.grad.cpu(), w.grad)


@pytest.mark.cuda
def test_cuda_backward_refuses_a_row_tile_it_cannot_hold():
    """More than 64 q heads a kv head fill no 64-slot row tile: the library
    sizes no workspace for them, and the wrapper raises before a launch."""
    dev = _cuda()
    shape = (1, 8, 8, 65, 1, 16, True, 0, None, 0)
    q, k, v, dout, q_pos, kv = _inputs(dev, shape)
    out, lse = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv, return_lse=True)
    FK.reset_launches()
    with pytest.raises(ValueError, match="q heads a kv head"):
        FK.flash_attention_bwd(q, k, v, out.contiguous(), dout, lse, q_pos, kv, causal=True,
                               window=0)
    assert FK.LAUNCHES["flash_attention_bwd"] == 0


def _ssd_inputs(dev, shape, seed=0):
    """The forward's inputs at realistic decays (dt in [1e-3, 0.1], A in
    [-16, -1]), b and c bf16-valued as the models' are, padded to the
    chunk; dy and dh_final unit normal."""
    b, l, h, p, n, g, chunk, with_dh = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*s):
        return torch.randn(s, generator=gen, device=dev)

    a = -(torch.rand((h,), generator=gen, device=dev) * 15 + 1)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 1e-3
    xdt, bg, cg = r(b, l, h, p) * dt[..., None], r(b, l, g, n).bfloat16().float(), \
        r(b, l, g, n).bfloat16().float()
    (xdt, da, bg, cg), q = SR.pad_to_chunks(xdt, dt * a, bg, cg, chunk)
    h0, dy = r(b, h, n, p), r(b, xdt.shape[1], h, p)
    return xdt, da, bg, cg, h0, dy, r(b, h, n, p) if with_dh else None, q


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_cuda_ssd_backward_matches_plain(shape):
    dev = _cuda()
    xdt, da, b, c, h0, dy, dhf, q = _ssd_inputs(dev, shape)
    SK.reset_launches()
    _, hf, cum, states = SK.ssd(xdt, da, b, c, h0, chunk=q, workspaces=True)
    got = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
    want = SR.ssd_bwd_ref(xdt, b, c, dy, dhf, cum, states, q)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {"ssd": 1, "ssd_bwd": 1}
    for name, gr, w in zip(SSD_BWD_FROBENIUS, got, want):
        assert gr.shape == w.shape and bool(torch.isfinite(gr).all()), name
        frob = float((gr - w).norm() / w.norm())
        assert frob <= SSD_BWD_FROBENIUS[name], (name, frob)
    again = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
    assert all(torch.equal(u, v) for u, v in zip(got, again))  # sums in a fixed order


@pytest.mark.cuda
@pytest.mark.parametrize("exact", ["neither", "b", "c"])
@pytest.mark.parametrize("shape", [SSD_SHAPES[0], SSD_SHAPES[1], (1, 512, 2, 128, 64, 1, 256, True),
                                   (1, 256, 2, 32, 128, 2, 128, False)])
def test_cuda_ssd_backward_pass_routes_match_plain(shape, exact):
    """b and c drawn in float32 (every product three TF32 passes), or one of
    them bf16-valued (the scores and the products with it two): each route
    within SSD_BWD_FROBENIUS of the plain backward, two calls the same
    bits; also at P 128.  The plain forward gives the workspaces."""
    dev = _cuda()
    xdt, da, b, c, h0, dy, dhf, q = _ssd_inputs(dev, shape, seed=3)
    gen = torch.Generator(device=dev).manual_seed(4)
    if exact != "b":
        b = b + torch.randn(b.shape, generator=gen, device=dev) * 1e-3
    if exact != "c":
        c = c + torch.randn(c.shape, generator=gen, device=dev) * 1e-3
    _, hf, cum, states = (t.contiguous() for t in
                          SR.ssd_chunked(xdt, da, b, c, h0, q, workspaces=True))
    got = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
    want = SR.ssd_bwd_ref(xdt, b, c, dy, dhf, cum, states, q)
    torch.cuda.synchronize()
    for name, gr, w in zip(SSD_BWD_FROBENIUS, got, want):
        assert bool(torch.isfinite(gr).all()), name
        frob = float((gr - w).norm() / w.norm())
        assert frob <= SSD_BWD_FROBENIUS[name], (name, exact, frob)
    again = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
    assert all(torch.equal(u, v) for u, v in zip(got, again))


@pytest.mark.cuda
def test_cuda_ssd_autograd_runs_both_kernels_once():
    """A differentiable scan on the card launches the forward once and, at
    backward, the backward kernel once; its gradients are the CPU
    Function's within the kernel's bounds."""
    dev = _cuda()
    xdt, da, b, c, h0, dy, _, q = _ssd_inputs(dev, SSD_SHAPES[0])
    SK.reset_launches()
    leaves = [t.clone().requires_grad_() for t in (xdt, da, b, c, h0)]
    y, _ = SO.ssd(*leaves, chunk=q)
    y.backward(dy)
    torch.cuda.synchronize()
    assert SK.LAUNCHES == {"ssd": 1, "ssd_bwd": 1}
    cpu = [t.detach().cpu().requires_grad_() for t in (xdt, da, b, c, h0)]
    y_c, _ = SO.ssd(*cpu, chunk=q)
    y_c.backward(dy.cpu())
    for name, gr, w in zip(SSD_BWD_FROBENIUS, leaves, cpu):
        frob = float((gr.grad.cpu() - w.grad).norm() / w.grad.norm())
        assert frob <= SSD_BWD_FROBENIUS[name], (name, frob)
