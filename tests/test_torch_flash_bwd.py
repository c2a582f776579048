"""The port's flash-attention backward (its plain PyTorch version, which CPU
tensors run inside ``ops.FlashAttention``) against the JAX package's custom
VJP (``repro.models.attention._flash_bwd`` through ``jax.vjp`` of its
``flash_attention``), on the CPU.

The same bf16 inputs and output cotangent, made with numpy from a seed, go
through both.  Cases: causal, a window, bidirectional; rep 1, 3, 6 and 8;
per-row kv_valid; Sq != Skv with queries at an offset; a ragged key length
that pads the reference's last 512-key chunk; head dims 16 to 128, 112
included.  The last four are the shape classes the card's tests
(``tests/test_torch_cuda_train.py``) give the backward kernel: Nemotron-4's
rep 6 at hd 128, hd 112, rep 8 at an offset, and rows at an offset that see
several of the kernel's 128-key blocks.

Tolerance: dq, dk and dv each within two bf16 steps at its own largest
magnitude, and within 1% in relative Frobenius norm.  Both sides round at
the same points (p and ds to bf16, float32 sums, delta in float32), but
XLA's and torch's float32 exp differ in the last bit and the sums run in
another order, which can flip one rounding of p or ds; the gradients are
sums over many keys, so one flip moves an element by far less than a step
of the largest.  Against torch autograd of the plain forward, which
differentiates the float32 scores without the reference's bf16 rounding
of p and ds, the bound is 3% of the largest magnitude.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import _flash_attention_body as j_flash_body
from repro.models.attention import flash_attention as j_flash
from repro.models.attention import head_map_static as j_head_map

from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.models.convert import params_from_jax

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

BF16_STEPS = 2
FROBENIUS = 1e-2
AUTOGRAD_OF_MAX = 3e-2

# (name, B, Sq, Skv, Hp, Hkv, hd, causal, window, kv_valid, q offset)
CASES = [
    ("causal-rep1", 2, 96, 96, 4, 4, 32, True, 0, None, 0),
    ("causal-rep3", 2, 80, 80, 9, 3, 64, True, 0, None, 0),
    ("window-rep3", 1, 200, 200, 6, 2, 32, True, 48, None, 0),
    ("bidirectional-rep6", 2, 64, 80, 6, 1, 16, False, 0, (80, 61), 0),
    ("offset-rows-rep3", 2, 32, 96, 6, 2, 32, True, 0, (96, 90), 64),
    ("ragged-chunk-rep1", 1, 40, 600, 2, 2, 16, False, 0, (600,), 0),
    ("causal-rep6-hd128", 1, 40, 40, 12, 2, 128, True, 0, None, 0),
    ("causal-rep1-hd112", 1, 36, 36, 3, 3, 112, True, 0, None, 0),
    ("offset-rows-rep8", 2, 24, 64, 8, 1, 16, True, 0, (64, 50), 40),
    ("offset-blocks-rep3", 1, 24, 300, 6, 2, 64, True, 0, None, 276),
]


def _bf16(rng, shape):
    return jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)).astype(jnp.bfloat16)


def _t(a) -> torch.Tensor:
    return params_from_jax(np.asarray(a), "cpu")


def _inputs(case):
    _, b, sq, skv, hp, hkv, hd, causal, window, kv_valid, off = case
    rng = np.random.default_rng(zlib.crc32(case[0].encode()))
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    dout = _bf16(rng, (b, sq, hp, hd))
    q_pos = np.broadcast_to(off + np.arange(sq, dtype=np.int32), (b, sq)).copy()
    if kv_valid is None:
        kv = np.full((b,), skv if not causal else off + sq, np.int32)
    else:
        kv = np.resize(np.asarray(kv_valid, np.int32), (b,))
    return q, k, v, dout, q_pos, kv


def _reference(case, q, k, v, dout, q_pos, kv):
    _, b, sq, skv, hp, hkv, hd, causal, window, _, _ = case
    hm = j_head_map(hp, hp, hkv)

    def f(q, k, v):
        return j_flash(q, k, v, hm, q_pos=jnp.asarray(q_pos), kv_valid=jnp.asarray(kv),
                       window=window, bidirectional=not causal)

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(dout)


def _port(case, q, k, v, dout, q_pos, kv):
    _, b, sq, skv, hp, hkv, hd, causal, window, _, _ = case
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = FO.flash_attention(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                             kv_valid=torch.from_numpy(kv), causal=causal, window=window)
    out.backward(_t(dout))
    return out.detach(), (tq.grad, tk.grad, tv.grad)


def _close(name, got, want, steps=BF16_STEPS):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    top = float(np.abs(w).max())
    step = 2.0 ** (np.floor(np.log2(top)) - 7)  # one bf16 step at the largest magnitude
    err = float(np.abs(g - w).max())
    assert err <= steps * step, f"{name}: max error {err} against {steps} x {step}"
    frob = float(np.linalg.norm(g - w) / np.linalg.norm(w))
    assert frob <= FROBENIUS, f"{name}: relative Frobenius error {frob}"


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_reference_vjp(case):
    q, k, v, dout, q_pos, kv = _inputs(case)
    want_out, want = _reference(case, q, k, v, dout, q_pos, kv)
    got_out, got = _port(case, q, k, v, dout, q_pos, kv)
    _close("out", got_out, want_out)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == w.shape
        _close(name, g, w)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_matches_autograd_of_the_plain_forward(case):
    """The same gradients as torch autograd of the plain forward in float32
    (its scores differentiated without the bf16 rounding of p and ds), to
    within the rounding those points add."""
    _, b, sq, skv, hp, hkv, hd, causal, window, _, _ = case
    q, k, v, dout, q_pos, kv = _inputs(case)
    _, got = _port(case, q, k, v, dout, q_pos, kv)
    fq, fk, fv = (_t(x).float().requires_grad_() for x in (q, k, v))
    out = FR.flash_attention_ref(fq, fk, fv, q_pos=torch.from_numpy(q_pos),
                                 kv_valid=torch.from_numpy(kv), causal=causal, window=window)
    out.backward(_t(dout).float())
    for name, g, w in zip(("dq", "dk", "dv"), got, (fq.grad, fk.grad, fv.grad)):
        top = float(w.abs().max())
        err = float((g.float() - w).abs().max())
        assert err <= AUTOGRAD_OF_MAX * top, f"{name}: {err} against {top}"


@pytest.mark.parametrize("case", CASES[:4], ids=[c[0] for c in CASES[:4]])
def test_forward_lse_matches_reference(case):
    """The forward's log-sum-exp residual equals the reference's
    ``_flash_attention_body`` lse within float32 rounding."""
    _, b, sq, skv, hp, hkv, hd, causal, window, _, _ = case
    q, k, v, dout, q_pos, kv = _inputs(case)
    _, want = j_flash_body(q, k, v, j_head_map(hp, hp, hkv), q_pos=jnp.asarray(q_pos),
                           kv_valid=jnp.asarray(kv), window=window,
                           bidirectional=not causal, chunk=512, kv_pos=None)
    _, got = FR.flash_attention_ref(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(q_pos),
                                    kv_valid=torch.from_numpy(kv), causal=causal,
                                    window=window, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_serving_calls_take_no_autograd_path():
    """Without grad the call is the forward alone (the serving path); with
    grad it is the Function, whose CPU backward equals the plain backward."""
    case = CASES[1]
    q, k, v, dout, q_pos, kv = _inputs(case)
    tq, tk, tv = _t(q), _t(k), _t(v)
    with torch.no_grad():
        plain = FO.flash_attention(tq.requires_grad_(), tk, tv, q_pos=torch.from_numpy(q_pos),
                                   kv_valid=torch.from_numpy(kv))
    assert plain.grad_fn is None
    out, grads = _port(case, q, k, v, dout, q_pos, kv)
    assert torch.equal(out, plain)
    _, lse = FR.flash_attention_ref(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(q_pos),
                                    kv_valid=torch.from_numpy(kv), return_lse=True)
    want = FR.flash_attention_bwd_ref(_t(q), _t(k), _t(v), out, _t(dout), lse,
                                      q_pos=torch.from_numpy(q_pos),
                                      kv_valid=torch.from_numpy(kv))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_backward_through_key_positions_raises():
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.normal(0, 1, (1, 8, 2, 16)).astype(np.float32)).bfloat16()
    k = torch.from_numpy(rng.normal(0, 1, (1, 16, 2, 16)).astype(np.float32)).bfloat16()
    q.requires_grad_()
    pos = torch.arange(8, 16, dtype=torch.int32)[None]
    kv_pos = torch.arange(16, dtype=torch.int32)[None]
    out = FO.flash_attention(q, k, k, q_pos=pos, kv_valid=16, kv_pos=kv_pos)
    with pytest.raises(ValueError, match="key positions"):
        out.sum().backward()

