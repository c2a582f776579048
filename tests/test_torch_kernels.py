"""Paged-attention decode: the port's plain versions vs the reference's
Pallas kernels (interpret mode on the CPU), plus the CUDA kernels vs the
plain versions on the card.

Tolerance: ``batched_ladder_paged_attention`` returns bf16 on both sides,
so the comparison runs in float32 with atol 2e-2 — bf16 inputs, float32
sums taken in another order, and a bf16 output step of 0.0078 near 1.  The
reference's own fused-vs-rung test uses 0.01.  Rows with nothing valid
must be exactly 0 on both sides.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention.ops import (
    batched_ladder_paged_attention as j_attention,
    pack_kv_planes as j_pack,
)

from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops as O
from repro_torch.kernels.paged_attention import ref as R
from repro_torch.models.convert import params_from_jax

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

ATOL = 2e-2

# (B, S, Hkv, rep, hd): the reference test's shapes, then the full-width
# SmolLM-135M head shape
SHAPES = [(3, 96, 2, 2, 16), (3, 64, 3, 3, 64)]


def _case(shape, seed):
    b, s, hkv, rep, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, hkv * rep, hd)).astype(ml_dtypes.bfloat16)
    k = rng.standard_normal((b, s, hkv, hd)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((b, s, hkv, hd)).astype(ml_dtypes.bfloat16)
    pp = rng.choice([4, 8, 16], (b, s // 16)).astype(np.int32)
    pp[1] = 0  # row 1: every page outside the rung set
    valid = np.array([s, s // 2 + 3, 0], np.int32)  # row 2: nothing valid
    return q, k, v, pp, valid


@pytest.mark.parametrize("kernel", ["fused", "rung"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_reference_pallas(kernel, shape):
    q, k, v, pp, valid = _case(shape, seed=sum(shape))
    want = np.asarray(j_attention(
        jnp.asarray(q), j_pack(jnp.asarray(k)), j_pack(jnp.asarray(v)),
        jnp.asarray(pp), jnp.asarray(valid), keeps=(4, 8, 16), kernel=kernel,
    ), np.float32)
    t = lambda a: params_from_jax(a, "cpu")  # noqa: E731
    got = O.batched_ladder_paged_attention(
        t(q), O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v)), t(pp), t(valid),
        keeps=(4, 8, 16), kernel=kernel,
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert np.all(got[1] == 0) and np.all(got[2] == 0)
    assert np.all(want[1] == 0) and np.all(want[2] == 0)
    assert np.any(got[0] != 0)


def test_fused_and_rung_plain_agree_on_ragged_lengths():
    """The reference's fused-vs-rung differential, on the port's plain
    versions: scattered keeps, ragged valid lengths."""
    rng = np.random.default_rng(7)
    b, s, hkv, rep, hd = 3, 96, 2, 2, 16
    q = torch.randn(b, 1, hkv * rep, hd).to(torch.bfloat16)
    kp = R.pack_kv_ref(torch.randn(b, s, hkv, hd).to(torch.bfloat16))
    vp = R.pack_kv_ref(torch.randn(b, s, hkv, hd).to(torch.bfloat16))
    pp = torch.as_tensor(rng.choice([4, 8, 16], (b, s // 16)), dtype=torch.int32)
    valid = torch.tensor([96, 50, 17], dtype=torch.int32)
    fused = O.batched_ladder_paged_attention(q, kp, vp, pp, valid, (4, 8, 16),
                                             kernel="fused")
    rung = O.batched_ladder_paged_attention(q, kp, vp, pp, valid, (4, 8, 16),
                                            kernel="rung")
    torch.testing.assert_close(fused.float(), rung.float(), atol=1e-2, rtol=0)
    with pytest.raises(ValueError, match="kernel"):
        O.batched_ladder_paged_attention(q, kp, vp, pp, valid, (16,), kernel="warp")


def test_cpu_takes_plain_version_and_launches_nothing():
    K.reset_launches()
    q, k, v, pp, valid = _case(SHAPES[0], seed=3)
    t = lambda a: params_from_jax(a, "cpu")  # noqa: E731
    for kernel in ("fused", "rung"):
        O.batched_ladder_paged_attention(
            t(q), O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v)), t(pp),
            t(valid), keeps=(4, 8, 16), kernel=kernel)
    assert K.LAUNCHES == {"paged_attention_fused": 0, "paged_attention_rung": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    q, k, v, pp, valid = _case(SHAPES[0], seed=4)
    t = lambda a: params_from_jax(a, "cpu")  # noqa: E731
    mask = torch.ones(q.shape[0], k.shape[1], dtype=torch.int8)
    qg = t(q).reshape(3, 2, 2, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.paged_attention_fused(qg, O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v)),
                                t(pp), mask)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.paged_attention_rung(qg, O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v)),
                               mask, keep=8)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_cuda_kernels_match_plain_on_card(shape):
    """Each CUDA kernel against its plain version on the same CUDA inputs
    (float32 outputs; atol/rtol 1e-2 for sums taken page by page)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    q, k, v, pp, valid = _case(shape, seed=11)
    dev = "cuda"
    t = lambda a: params_from_jax(a, dev)  # noqa: E731
    b, s, hkv, rep, hd = shape
    qg = t(q).reshape(b, hkv, rep, hd).contiguous()
    kp, vp = O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v))
    keeps = t(pp)
    mask = (torch.arange(s, device=dev)[None] < t(valid)[:, None]).to(torch.int8)
    mask = (mask * (keeps.repeat_interleave(16, 1) > 0)).to(torch.int8).contiguous()
    got = K.paged_attention_fused(qg, kp, vp, keeps, mask)
    want = R.paged_attention_fused_ref(qg, kp, vp, keeps, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=1e-2, rtol=1e-2)
    assert torch.all(got[1] == 0) and torch.all(got[2] == 0)
    for keep in (4, 8, 16):
        mk = (mask * (keeps.repeat_interleave(16, 1) == keep)).to(torch.int8).contiguous()
        (o, m, l), (o_r, m_r, l_r) = (K.paged_attention_rung(qg, kp, vp, mk, keep=keep),
                                      R.paged_attention_rung_ref(qg, kp, vp, mk, keep))
        torch.testing.assert_close(m, m_r, atol=1e-2, rtol=1e-2)
        torch.testing.assert_close(l, l_r, atol=1e-2, rtol=1e-2)
        # o is unnormalised: compare o / l (bf16(p) is rounded at another
        # running max in the kernel, which a cancelling sum amplifies in o)
        torch.testing.assert_close(o / l.clamp(min=1e-30)[..., None],
                                   o_r / l_r.clamp(min=1e-30)[..., None],
                                   atol=1e-2, rtol=1e-2)
