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

The CUDA kernel's launch plan (``kernel.plan``, pure Python from the
shapes) is checked here too, and a plain mirror of its split-and-merge
(per-split partials over the plan's key ranges, merged as the merge
kernel merges) is held to the same references within the same tolerance.
"""

import inspect

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



# ---------------------------------------------------------------- launch plan

PLAN_SHAPES = [
    (2, 4096, 4096, 32, 32, 112, None),  # Zamba2-7B prefill
    (1, 64, 1024, 9, 3, 64, 64),         # SmolLM prefill chunks: the first,
    (1, 64, 1024, 9, 3, 64, 1024),       # ... the last,
    (1, 512, 1024, 9, 3, 64, 512),       # ... a 512-row first chunk,
    (1, 512, 1024, 9, 3, 64, 960),       # ... one at an offset,
    (1, 16, 1024, 9, 3, 64, 599),        # ... a serving run's ragged tail
    (1, 128, 1024, 9, 3, 64, 384),
    (1, 1, 1024, 9, 3, 64, 1001),
    (1, 64, 1024, 9, 3, 64, None),       # the same shape with no bound on kv_valid
    (2, 300, 1000, 32, 4, 128, None),    # Yi-9B heads
    (3, 40, 40, 4, 4, 16, None),
    (1, 200, 333, 4, 1, 80, None),
    (1, 96, 2048, 32, 32, 112, None),
    (1, 64, 4096, 9, 3, 64, 4096),       # a SmolLM-width chunk over a long cache
    (1, 64, 4096, 9, 3, 64, 1024),       # ... with a bound below Skv
]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_key_tile_once(shape):
    """The splits' key ranges cut [0, key_tiles) into consecutive, non-empty
    pieces, key_tiles the tiles below min(Skv, valid) (the last range runs
    on past them); the query tiles cover Sq; a block's rows fit its 128."""
    b, sq, skv, hp, hkv, hd, valid = shape
    p = FK.plan(*shape)
    assert p["key_tiles"] == -(-min(skv, valid or skv) // FK.KEYS)
    seen = []
    for s in range(p["splits"]):
        lo = s * p["tiles_per_split"]
        hi = min(lo + p["tiles_per_split"], p["key_tiles"])
        assert lo < hi
        seen += range(lo, hi)
    assert seen == list(range(p["key_tiles"]))
    assert p["tokens"] * p["rep"] <= FK.ROWS and p["qtiles"] * p["tokens"] >= sq
    assert (p["qtiles"] - 1) * p["tokens"] < sq
    assert p["blocks"] == p["qtiles"] * hkv * b * p["splits"]


@pytest.mark.parametrize("shape", PLAN_SHAPES[:9] + PLAN_SHAPES[-2:])
def test_plan_fills_the_card_at_the_serving_and_zamba2_shapes(shape):
    """From SPLIT_TILES key tiles on, and where the card holds two blocks
    for each unsplit one, the keys are split as finely as one wave of
    blocks allows: no finer range fits in SMS blocks and MAX_SPLITS; below
    that, or where the query tiles alone fill the card, nothing is split."""
    b, sq, skv, hp, hkv, hd, valid = shape
    p = FK.plan(*shape)
    base = p["blocks"] // p["splits"]
    can = p["key_tiles"] >= FK.SPLIT_TILES and FK.SMS // base >= 2
    assert (p["splits"] > 1) == can
    if can:
        per = p["tiles_per_split"]
        assert p["blocks"] <= FK.SMS and p["splits"] <= FK.MAX_SPLITS
        finer = -(-p["key_tiles"] // (per - 1)) if per > 1 else None
        assert finer is None or finer * base > FK.SMS or finer > FK.MAX_SPLITS


def test_plan_reads_no_tensor():
    """The plan takes the shapes (and the caller's host bound on kv_valid)
    as ints, and the wrapper reads no value of a tensor on the host (no
    synchronisation on the prefill path)."""
    assert list(inspect.signature(FK.plan).parameters) == ["b", "sq", "skv", "hp", "hkv", "hd",
                                                           "valid"]
    shape = (1, 64, 1024, 9, 3, 64, 576)
    assert FK.plan(*(np.int64(x) for x in shape)) == FK.plan(*shape)
    src = inspect.getsource(FK)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "synchronize("):
        assert call not in src


def test_plan_refuses_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="head_dim"):
        FK.plan(1, 16, 16, 1, 1, 24)
    with pytest.raises(ValueError, match="kv heads"):
        FK.plan(1, 16, 16, 6, 4, 64)
    with pytest.raises(ValueError, match="at most 128"):
        FK.plan(1, 16, 16, 256, 1, 64)
    with pytest.raises(ValueError, match="empty"):
        FK.plan(1, 16, 0, 4, 4, 64)


# ------------------------------------------------- split-and-merge mirror

LOG2E = 1.4426950408889634


def split_merge_mirror(q, k, v, q_pos, kv_valid, *, causal, window, tiles_per_split=None,
                       valid=None):
    """The kernels' algorithm in plain PyTorch: each block (query tile of
    the plan's tokens x the rep query heads of one kv head, batch row,
    split of the key tiles) walks the KEYS-key tiles of its split that some
    row of the block may see, with an online softmax in log2 units and p
    rounded to bf16 at each tile's running max; one split writes its output
    (0 where it visited no tile), several write partials (acc, m, l) that
    are merged as the merge kernel does: splits with l > 0, weights
    exp2(m - max m), the output acc / max(l, 1e-30).  ``valid`` is the
    plan's host bound on kv_valid (the last split runs on past it);
    ``tiles_per_split`` overrides the plan's split."""
    b, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    p = FK.plan(b, sq, skv, hp, hkv, hd, valid)
    per = tiles_per_split or p["tiles_per_split"]
    splits = -(-p["key_tiles"] // per)
    rep, tokens, keys = p["rep"], p["tokens"], FK.KEYS
    scale2 = LOG2E / np.sqrt(hd)
    out = torch.zeros((b, sq, hp, hd), dtype=torch.float32)
    for bi in range(b):
        kv_end = max(0, min(int(kv_valid[bi]), skv))
        for g in range(hkv):
            for t0 in range(0, sq, tokens):
                t1 = min(sq, t0 + tokens)
                qp = q_pos[bi, t0:t1].long()
                qmin, qmax = int(qp.min()), int(qp.max())
                hi = min(kv_end, qmax + 1) if causal else kv_end
                lo = max(0, qmin - window + 1) if window > 0 else 0
                rows = q[bi, t0:t1, g * rep:(g + 1) * rep].float().reshape(-1, hd)
                rpos = qp.repeat_interleave(rep)
                parts = []
                for s in range(splits):
                    jb = max(lo // keys, s * per)
                    cap = (s + 1) * per if s + 1 < splits else -(-skv // keys)
                    je = min(-(-hi // keys), cap) if hi > lo else 0
                    m = torch.full((rows.shape[0],), -1e30)
                    l = torch.zeros(rows.shape[0])
                    acc = torch.zeros(rows.shape[0], hd)
                    for j in range(jb, je):
                        k0 = j * keys
                        kt = k[bi, k0:k0 + keys, g].float()
                        vt = v[bi, k0:k0 + keys, g].float()
                        kpos = torch.arange(k0, k0 + kt.shape[0])[None]
                        ok = kpos < kv_end
                        if causal:
                            ok = ok & (kpos <= rpos[:, None])
                        if window > 0:
                            ok = ok & (kpos > rpos[:, None] - window)
                        sc = torch.where(ok, rows @ kt.T * scale2, torch.tensor(-1e30))
                        m_new = torch.maximum(m, sc.amax(-1))
                        corr = torch.exp2(m - m_new)
                        pt = torch.exp2(sc - m_new[:, None])
                        l = l * corr + pt.sum(-1)
                        acc = acc * corr[:, None] + pt.to(torch.bfloat16).float() @ vt
                        m = m_new
                    parts.append((acc, m, l, je > jb))
                if splits == 1:
                    acc, _, l, _ = parts[0]
                    res = acc / torch.clamp(l, min=1e-30)[:, None]
                else:
                    seen = [(a, mm, ll) for a, mm, ll, any_tile in parts if any_tile]
                    res = torch.zeros(rows.shape[0], hd)
                    if seen:
                        mmax = torch.stack([mm for _, mm, _ in seen]).amax(0)
                        num = sum(torch.exp2(mm - mmax)[:, None] * a for a, mm, _ in seen)
                        den = sum(torch.exp2(mm - mmax) * ll for _, mm, ll in seen)
                        res = num / torch.clamp(den, min=1e-30)[:, None]
                out[bi, t0:t1, g * rep:(g + 1) * rep] = res.reshape(t1 - t0, rep, hd)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize(
    "b,sq,skv,hp,hkv,hd,causal,window",
    [
        (2, 128, 384, 8, 2, 64, True, 0),     # rep 4, 3 key tiles
        (1, 256, 256, 4, 4, 128, True, 64),   # sliding window
        (2, 64, 192, 6, 3, 32, False, 0),     # bidirectional
        (1, 96, 96, 9, 3, 112, True, 0),      # hd 112, one key tile
    ],
)
def test_split_merge_mirror_matches_pallas_kernel(b, sq, skv, hp, hkv, hd, causal, window):
    """The kernels' split-and-merge in plain PyTorch, one key tile a split
    (at these short caches the plan itself does not split), against the
    reference's Pallas kernel in interpret mode."""
    rng = np.random.default_rng(sq * hp + hd + 1)
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    want = j_flash_pallas(q, k, v, causal=causal, window=window, bq=64, bkv=64)
    got = split_merge_mirror(_t(q), _t(k), _t(v), torch.from_numpy(_positions(b, sq)),
                             np.full(b, skv), causal=causal, window=window, tiles_per_split=1)
    _assert_steps_close(got, want)


@pytest.mark.parametrize("b,sq,skv,hp,hkv,hd,start,kv_valid,window,bidirectional", [
    (1, 64, 2048, 9, 3, 64, 1984, 2048, 0, False),      # a chunk at a long cache's end
    (1, 64, 2048, 9, 3, 64, 0, 64, 0, False),           # the first: all splits but one empty
    (3, 40, 1200, 4, 2, 16, 30, (70, 1155, 1200), 0, False),  # (B,) valid lengths
    (2, 48, 1300, 4, 4, 32, 1200, 1248, 24, False),     # window at an offset
    (2, 32, 1200, 6, 3, 16, 0, (1200, 50), 0, True),    # bidirectional, (B,) valid
])
def test_split_merge_mirror_matches_model_flash(b, sq, skv, hp, hkv, hd, start, kv_valid,
                                                window, bidirectional):
    """The mirror against the jnp forward the reference's models run, at
    offset query positions and valid lengths below Skv, with the keys split
    as the plan splits them when it has no host bound on kv_valid (every
    key tile of Skv)."""
    assert FK.plan(b, sq, skv, hp, hkv, hd)["splits"] > 1
    rng = np.random.default_rng(start + sq + 2)
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    pos = _positions(b, sq, start)
    valid = np.broadcast_to(np.asarray(kv_valid, np.int32), (b,))
    want = j_flash(q, k, v, j_head_map(hp, hp, hkv), q_pos=jnp.asarray(pos),
                   kv_valid=jnp.asarray(valid), window=window, bidirectional=bidirectional)
    got = split_merge_mirror(_t(q), _t(k), _t(v), torch.from_numpy(pos), valid,
                             causal=not bidirectional, window=window)
    _assert_steps_close(got, want)


@pytest.mark.parametrize("b,sq,skv,hp,hkv,hd,start,kv_valid,bound", [
    (1, 16, 1024, 9, 3, 64, 576, 592, 592),     # a serving run's tail chunk: 5 splits
    (1, 64, 1024, 9, 3, 64, 384, 448, 448),     # 4 splits of one tile
    (1, 512, 1024, 9, 3, 64, 448, 960, 960),    # 3 splits at 39 base blocks
    (1, 64, 1024, 9, 3, 64, 0, 64, 64),         # the first chunk: not split
    (1, 64, 4096, 9, 3, 64, 4032, 4096, 1024),  # a bound below kv_valid: the last split runs on
])
def test_split_merge_mirror_matches_model_flash_below_a_host_bound(b, sq, skv, hp, hkv, hd,
                                                                   start, kv_valid, bound):
    """The mirror against the reference's jnp forward with the keys split
    as the plan splits them below the caller's host bound on kv_valid (a
    prefill chunk's end in its slot)."""
    assert (FK.plan(b, sq, skv, hp, hkv, hd, bound)["splits"] > 1) == (start > 0)
    rng = np.random.default_rng(start + sq + bound)
    q, k, v = _bf16(rng, (b, sq, hp, hd)), _bf16(rng, (b, skv, hkv, hd)), _bf16(rng, (b, skv, hkv, hd))
    pos = _positions(b, sq, start)
    valid = np.full((b,), kv_valid, np.int32)
    want = j_flash(q, k, v, j_head_map(hp, hp, hkv), q_pos=jnp.asarray(pos),
                   kv_valid=jnp.asarray(valid), window=0, bidirectional=False)
    got = split_merge_mirror(_t(q), _t(k), _t(v), torch.from_numpy(pos), valid,
                             causal=True, window=0, valid=bound)
    _assert_steps_close(got, want)


@pytest.mark.parametrize("per", [1, 2, 3])
def test_split_merge_mirror_is_the_plain_version_under_any_split(per):
    """The same inputs cut into 1, 2 or 3 key tiles a split agree with the
    plain version within the tolerance: where p rounds moves, the function
    does not."""
    gen = torch.Generator().manual_seed(per)
    q = torch.randn((1, 80, 6, 48), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((1, 700, 2, 48), generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = torch.from_numpy(_positions(1, 80, 600))
    want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=690)
    got = split_merge_mirror(q, k, v, pos, [690], causal=True, window=0, tiles_per_split=per)
    _assert_steps_close(got, want.float().numpy())


def test_split_merge_mirror_returns_zero_for_a_row_that_sees_no_key():
    """kv_valid = 0 leaves every split of that batch row without a tile: its
    output is 0, the other row's is the plain version's."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 16, 3, 16), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((2, 300, 3, 16), generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = torch.from_numpy(_positions(2, 16, 280))
    got = split_merge_mirror(q, k, v, pos, [0, 300], causal=True, window=0, tiles_per_split=1)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = FR.flash_attention_ref(q[1:], k[1:], v[1:], q_pos=pos[1:], kv_valid=300)
    _assert_steps_close(got[1:], want.float().numpy())
