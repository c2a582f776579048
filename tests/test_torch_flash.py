"""The port's flash-attention prefill (its plain PyTorch version, which CPU
tensors run) against the JAX package, on the CPU.

The same bf16 inputs, made with numpy from a seed, go through the
reference's Pallas kernel in interpret mode
(``repro.kernels.flash_attention.ops.flash_attention``, at the shapes of
its own test in ``tests/test_kernels.py``), through the reference model's
jnp ``flash_attention`` (offset query positions, per-row valid lengths, a
SmolLM-like prefill chunk), and through a naive float32 softmax.

Tolerance: every element within two bf16 steps at the largest magnitude
of its own output row (batch row, query, head; a causal row's output
shrinks with its depth, so the whole output's largest magnitude would be
too coarse a scale for the deep rows).  Both sides take float32 scores and round p to bf16 before p·v,
but they sum in another order (the Pallas kernel in 64-key blocks, with q
padded to 128 lanes and rescaled in float32; the jnp version and the port
in 512-key chunks, XLA's and torch's float32 exp differing in the last
bit), which can flip a rounding of p or of the output.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import flash_attention as j_flash_pallas
from repro.models.attention import flash_attention as j_flash
from repro.models.attention import head_map_static as j_head_map

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.models.convert import params_from_jax

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

BF16_STEPS = 2


def _bf16(rng, shape):
    return jnp.asarray(rng.normal(0, 1, shape).astype(np.float32)).astype(jnp.bfloat16)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array -> a torch tensor of the same bits (bf16 kept)."""
    return params_from_jax(np.asarray(a), "cpu")


def _assert_steps_close(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    want = np.asarray(want).astype(np.float32)
    assert got.shape == want.shape
    rmax = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30)
    step = 2.0 ** (np.floor(np.log2(rmax)) - 7)
    steps = (np.abs(got - want) / step).max()
    assert steps <= BF16_STEPS, steps


def _positions(b, sq, start=0):
    return np.broadcast_to(start + np.arange(sq, dtype=np.int32), (b, sq)).copy()


@pytest.mark.parametrize(
    "b,sq,skv,hp,hkv,hd,causal,window",
    [
        (2, 128, 128, 8, 2, 64, True, 0),
        (1, 256, 256, 4, 4, 128, True, 64),
        (2, 64, 192, 6, 3, 32, False, 0),
        (1, 96, 96, 9, 3, 112, True, 0),
    ],
)
def test_plain_flash_matches_pallas_kernel(b, sq, skv, hp, hkv, hd, causal, window):
    """The reference kernel test's four shapes: GQA causal, sliding window,
    bidirectional over more keys than queries, and hd = 112 (Zamba2)."""
    rng = np.random.default_rng(sq * hp + hd)
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    want = j_flash_pallas(q, k, v, causal=causal, window=window, bq=64, bkv=64)
    got = FO.flash_attention(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(_positions(b, sq)),
                             kv_valid=skv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    _assert_steps_close(got, want)


@pytest.mark.parametrize("b,sq,skv,hp,hkv,hd,start,kv_valid,window,bidirectional", [
    (1, 64, 256, 9, 3, 64, 128, 192, 0, False),         # a SmolLM prefill chunk
    (3, 40, 100, 4, 2, 16, 30, (70, 55, 100), 0, False),  # (B,) valid lengths
    (2, 48, 160, 4, 4, 32, 100, 148, 24, False),        # window at an offset
    (2, 32, 96, 6, 3, 16, 0, (96, 50), 0, True),        # bidirectional, (B,) valid
])
def test_plain_flash_matches_model_flash(b, sq, skv, hp, hkv, hd, start, kv_valid,
                                         window, bidirectional):
    """Against the jnp forward the reference's models run, with query
    positions that start at a chunk's offset and valid lengths below Skv."""
    rng = np.random.default_rng(start + sq)
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    pos = _positions(b, sq, start)
    valid = np.asarray(kv_valid, np.int32)
    want = j_flash(q, k, v, j_head_map(hp, hp, hkv), q_pos=jnp.asarray(pos),
                   kv_valid=jnp.asarray(valid), window=window, bidirectional=bidirectional)
    got = FO.flash_attention(_t(q), _t(k), _t(v), q_pos=torch.from_numpy(pos),
                             kv_valid=torch.from_numpy(valid), causal=not bidirectional,
                             window=window)
    _assert_steps_close(got, want)


@pytest.mark.parametrize("sq,skv,kv_valid,causal,window", [
    (2048, 2048, 2048, True, 0),
    (1000, 1000, 1000, True, 0),
    (1024, 1024, 1024, True, 64),
    (256, 1024, 700, False, 0),
])
def test_plain_flash_chunkings_agree_within_one_step_per_row(sq, skv, kv_valid,
                                                             causal, window):
    """The plain version with 64-key chunks (the kernel's tile, so p rounds
    at the same running max as in the kernel) against its 512-key chunks,
    at hd = 112: the sums run in another order and p rounds at another
    max, which may flip the output's final rounding but moves no element
    by more than one bf16 step at its row's largest magnitude.  This is
    the floor under the kernel's own tolerance on the card."""
    gen = torch.Generator().manual_seed(sq + window)
    q = torch.randn((1, sq, 4, 112), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, skv, 4, 112), generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = torch.from_numpy(_positions(1, sq))
    args = dict(q_pos=pos, kv_valid=kv_valid, causal=causal, window=window)
    want = FR.flash_attention_ref(q, k, v, chunk=512, **args)
    got = FR.flash_attention_ref(q, k, v, chunk=64, **args)
    rmax = want.float().abs().amax(-1, keepdim=True)
    step = torch.exp2(torch.floor(torch.log2(rmax)) - 7)
    assert float(((got.float() - want.float()).abs() / step).max()) <= 1.0


def test_plain_flash_window_wipes_the_masked_chunk():
    """With 16-key chunks and a 20-key window, late rows see nothing in
    the first chunks: their state there is garbage that the finite NEG_INF
    lets the first visible key wipe out.  The output stays finite and
    equals a naive float32 softmax (p rounded to bf16 as the kernel does)."""
    rng = np.random.default_rng(11)
    b, s, h, hd, window = 2, 80, 2, 16, 20
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (b, s, h, hd)).astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    pos = torch.from_numpy(_positions(b, s))
    got = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=s, window=window, chunk=16)
    assert torch.isfinite(got.float()).all()
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / np.sqrt(hd)
    i, j = torch.arange(s)[:, None], torch.arange(s)[None]
    sc = sc.masked_fill(~((j <= i) & (j > i - window)), float("-inf"))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    want = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float()) \
        / p.sum(-1).transpose(1, 2)[..., None]
    _assert_steps_close(got, want.numpy())


def test_flash_wrapper_takes_cuda_tensors_only():
    t = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16)
    pos = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FK.flash_attention(t, t, t, pos, torch.zeros((1,), dtype=torch.int32),
                           causal=True, window=0)
    meta = torch.zeros((1, 4, 1, 16), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        FO.flash_attention(meta, meta, meta, q_pos=pos, kv_valid=4)

