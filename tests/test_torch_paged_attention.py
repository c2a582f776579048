"""The paged-attention kernels' launch plan, split-and-merge and rebuild on
the CPU, and the kernels against their plain versions on the card.

The CUDA kernels (``src/repro_torch/csrc/paged_attention.cu``) split S into
the page ranges of ``kernel.plan``, walk each range page by page with an
online softmax (p rounded to bf16 at the running max), and merge the
ranges' (acc, m, l) in split order.  ``split_merge_mirror`` below is that
algorithm in plain PyTorch.  On inputs whose scores are +-64 (so every p
that is not negligible is exactly 1 wherever it is rounded) it equals the
plain versions within 1e-5; on random inputs within the kernels' card
tolerance 1e-2, since p is rounded at another maximum.
``rebuild_like_kernel`` is the kernel's rebuild of a page's plane run (8 x 8
bit-matrix transposes by row swaps in each byte lane, then byte permutes,
one array lane per word) in NumPy, held bit for bit to ``unpack_kv_ref``.

The card tests carry the ``cuda`` marker and skip without a GPU; the file
imports no JAX, so they run on the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_paged_attention.py
"""

import inspect
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ops as O
from repro_torch.kernels.paged_attention import ref as R

torch.set_num_threads(1)

EXACT_TOL = 1e-5
KERNEL_TOL = 1e-2
M32 = np.uint32(0xFFFFFFFF)

# (B, S, Hkv, rep, hd): the serving shape, the Yi-9B head shape at S 4096,
# and small ones (hd 8, rep 1 and 7, head groups, hd 24)
PLAN_SHAPES = [(8, 1024, 3, 3, 64), (8, 4096, 4, 8, 128), (2, 4096, 4, 8, 128),
               (1, 16, 1, 1, 8), (2, 1024, 8, 7, 128), (4, 256, 16, 1, 8),
               (1, 1024, 1, 64, 64), (3, 96, 2, 2, 16), (2, 128, 6, 2, 24),
               (1, 65536, 2, 4, 64)]


# ---------------------------------------------------------------- the plan

@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_every_page_once(shape):
    b, s, hkv, rep, hd = shape
    p = K.plan(b, s, hkv, rep, hd)
    n_pages = s // 16
    ranges = [range(i * p["pages"], min(n_pages, (i + 1) * p["pages"]))
              for i in range(p["splits"])]
    covered = [page for r in ranges for page in r]
    assert covered == list(range(n_pages))
    assert all(len(r) > 0 for r in ranges)
    assert 1 <= p["splits"] <= K.MAX_SPLITS
    assert hkv % p["heads"] == 0 and p["heads"] * p["qtiles"] <= K.COMPUTE_WARPS
    assert p["qgroups"] * p["qtiles"] * 16 >= rep
    assert p["blocks"] == p["splits"] * b * hkv // p["heads"] * p["qgroups"]
    assert K.smem_bytes(p["heads"], hd, p["qtiles"], p["pages"]) <= K.smem_budget(hd)


def test_plan_fills_the_card_at_the_serving_shape():
    p = K.plan(8, 1024, 3, 3, 64)
    assert p["blocks"] >= K.SMS
    assert p["heads"] == 3  # every kv head: a page's plane is one contiguous run


def test_plan_reads_no_tensor():
    """The plan takes the shapes as ints, and the wrappers read no value of
    a tensor on the host (no synchronisation on the decode path)."""
    assert list(inspect.signature(K.plan).parameters) == ["b", "s", "hkv", "rep", "hd"]
    assert K.plan(*(np.int64(x) for x in (8, 1024, 3, 3, 64))) == K.plan(8, 1024, 3, 3, 64)
    src = inspect.getsource(K)
    for call in (".item(", ".tolist(", ".cpu(", ".numpy(", "synchronize("):
        assert call not in src


def test_plan_refuses_shapes_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 8"):
        K.plan(1, 16, 1, 1, 12)
    with pytest.raises(ValueError, match="up to 256"):
        K.plan(1, 16, 1, 1, 264)
    with pytest.raises(ValueError, match="16-token pages"):
        K.plan(1, 24, 1, 1, 64)


# ------------------------------------------------- split-and-merge mirror

def split_merge_mirror(q, kp, vp, page_keeps, mask, pages=None):
    """The kernels' algorithm in plain PyTorch: per split of ``pages``
    pages (the plan's by default), page by page, an online softmax over the
    live pages (keep > 0 and a valid token) with p rounded to bf16 at the
    running max; a split with no live page leaves m = NEG_INF, l = 0 and an
    acc that is never read (NaN here); then the splits merged in order.
    Returns the unnormalised (acc, m, l)."""
    b, hkv, rep, hd = q.shape
    s = kp.shape[2]
    n_pages = s // 16
    pps = pages or K.plan(b, s, hkv, rep, hd)["pages"]
    tok_keep = page_keeps.repeat_interleave(16, dim=1)
    kk = R.unpack_kv_keeps_ref(kp, tok_keep).float()
    vv = R.unpack_kv_keeps_ref(vp, tok_keep).float()
    scale = torch.tensor(1.0 / math.sqrt(hd), dtype=torch.float32)
    qf = q.float()
    parts = []
    for lo in range(0, n_pages, pps):
        acc = torch.zeros(b, hkv, rep, hd)
        m = torch.full((b, hkv, rep), R.NEG_INF)
        l = torch.zeros(b, hkv, rep)
        for page in range(lo, min(n_pages, lo + pps)):
            toks = slice(16 * page, 16 * page + 16)
            ok = mask[:, toks] > 0
            live = (ok.any(dim=1) & (page_keeps[:, page] > 0))[:, None, None]
            sc = torch.einsum("bkrd,bskd->bkrs", qf, kk[:, toks]) * scale
            sc = torch.where(ok[:, None, None, :], sc, torch.full_like(sc, R.NEG_INF))
            mx = torch.maximum(m, sc.amax(dim=-1))
            c = torch.exp(m - mx)
            p = torch.exp(sc - mx[..., None])
            pv = torch.einsum("bkrs,bskd->bkrd", p.to(torch.bfloat16).float(), vv[:, toks])
            acc = torch.where(live[..., None], acc * c[..., None] + pv, acc)
            l = torch.where(live, l * c + p.sum(dim=-1), l)
            m = torch.where(live, mx, m)
        acc = torch.where((m > R.NEG_INF / 2)[..., None], acc, torch.full_like(acc, math.nan))
        parts.append((acc, m, l))
    big_m = torch.stack([m for _, m, _ in parts]).amax(dim=0)
    o = torch.zeros(b, hkv, rep, hd)
    big_l = torch.zeros(b, hkv, rep)
    for acc, m, l in parts:
        w = torch.where(m > R.NEG_INF / 2, torch.exp(m - big_m), torch.zeros_like(m))
        o = torch.where((w > 0)[..., None], o + w[..., None] * acc, o)
        big_l = big_l + l * w
    return o, big_m, big_l


def mirror_fused(q, kp, vp, page_keeps, mask, pages=None):
    o, m, l = split_merge_mirror(q, kp, vp, page_keeps, mask, pages)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return torch.where((m > R.NEG_INF / 2)[..., None], out, torch.zeros_like(out))


def _bf16(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def mirror_case(shape, seed, controlled=True):
    """Inputs with mixed keeps {0, 4, 8, 16}, ragged lengths, an all-masked
    row (3), a row valid only in its last 24 tokens (6), and keep-0 pages
    that leave whole splits of row 0 with nothing valid.  Controlled: q is
    +-256 on dim 0 and 0 elsewhere, k's dim 0 is +-2 (exact at any keep >=
    2), so every score is +-64 at hd 64 and every p is 1 or below 1e-55."""
    b, s, hkv, rep, hd = shape
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((b, s, hkv, hd))
    v = rng.standard_normal((b, s, hkv, hd))
    q = rng.standard_normal((b, hkv, rep, hd))
    if controlled:
        k[..., 0] = 2.0 * rng.choice([-1.0, 1.0], (b, s, hkv))
        q[:] = 0.0
        q[..., 0] = 256.0 * rng.choice([-1.0, 1.0], (b, hkv, rep))
    n_pages = s // 16
    keeps = rng.choice([0, 4, 8, 16, 16], (b, n_pages)).astype(np.int32)
    keeps[0, 2:6] = 0
    keeps[6, -2:] = 16
    valid = np.array([s, s - 300, s // 3, 0, 17, s - 24, s, 64][:b])
    ok = np.arange(s)[None] < valid[:, None]
    ok[6] = np.arange(s) >= s - 24
    mask = ok & (np.repeat(keeps, 16, axis=1) > 0)
    return (_bf16(q), R.pack_kv_ref(_bf16(k)), R.pack_kv_ref(_bf16(v)),
            torch.from_numpy(keeps), torch.from_numpy(mask.astype(np.int8)))


MIRROR_SHAPES = [(8, 1024, 3, 3, 64), (8, 512, 2, 8, 64)]


@pytest.mark.parametrize("pages", [None, 5])
@pytest.mark.parametrize("shape", MIRROR_SHAPES)
def test_split_merge_mirror_equals_plain_fused(shape, pages):
    q, kp, vp, keeps, mask = mirror_case(shape, seed=sum(shape))
    got = mirror_fused(q, kp, vp, keeps, mask, pages)
    want = R.paged_attention_fused_ref(q, kp, vp, keeps, mask)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=EXACT_TOL, rtol=EXACT_TOL)
    assert torch.all(got[3] == 0) and torch.all(want[3] == 0)
    assert torch.any(got[6] != 0)


@pytest.mark.parametrize("pages", [None, 5])
@pytest.mark.parametrize("shape", MIRROR_SHAPES)
def test_split_merge_mirror_equals_plain_rung(shape, pages):
    q, kp, vp, keeps, mask = mirror_case(shape, seed=sum(shape) + 1)
    tok_keep = keeps.repeat_interleave(16, dim=1)
    got, want = [], []
    for keep in (4, 8, 16):
        mk = (mask * (tok_keep == keep)).to(torch.int8)
        rung_keeps = torch.full_like(keeps, keep)
        o, m, l = split_merge_mirror(q, kp, vp, rung_keeps, mk, pages)
        o_r, m_r, l_r = R.paged_attention_rung_ref(q, kp, vp, mk, keep)
        torch.testing.assert_close(m, m_r, atol=EXACT_TOL, rtol=EXACT_TOL)
        torch.testing.assert_close(l, l_r, atol=EXACT_TOL, rtol=EXACT_TOL)
        torch.testing.assert_close(o / l.clamp(min=1e-30)[..., None],
                                   o_r / l_r.clamp(min=1e-30)[..., None],
                                   atol=EXACT_TOL, rtol=EXACT_TOL)
        assert torch.all(m[3] == R.NEG_INF) and torch.all(l[3] == 0) and torch.all(o[3] == 0)
        got.append((o, m, l))
        want.append((o_r, m_r, l_r))
    merged = O.merge_rung_partials(got)
    torch.testing.assert_close(merged, O.merge_rung_partials(want), atol=EXACT_TOL,
                               rtol=EXACT_TOL)
    assert torch.all(merged[3] == 0) and torch.isfinite(merged).all()


def test_split_merge_mirror_keeps_m_at_neg_inf_for_an_empty_split():
    """Row 0's pages 2-5 keep 0 planes: with one page a split, those splits
    have nothing valid, and the merge takes nothing (no NaN) from them."""
    q, kp, vp, keeps, mask = mirror_case(MIRROR_SHAPES[0], seed=5)
    o, m, l = split_merge_mirror(q[:1], kp[:, :1], vp[:, :1], keeps[:1], mask[:1], pages=1)
    want = R.paged_attention_fused_ref(q[:1], kp[:, :1], vp[:, :1], keeps[:1], mask[:1])
    assert torch.isfinite(o).all() and torch.isfinite(l).all()
    out = o / l.clamp(min=1e-30)[..., None]
    torch.testing.assert_close(out, want, atol=EXACT_TOL, rtol=EXACT_TOL)


def test_split_merge_mirror_on_random_scores_within_the_card_tolerance():
    """Random q and k: p is rounded to bf16 at each page's running max, not
    the row's, so mirror and plain version differ by bf16 steps of p."""
    q, kp, vp, keeps, mask = mirror_case(MIRROR_SHAPES[0], seed=9, controlled=False)
    got = mirror_fused(q, kp, vp, keeps, mask)
    want = R.paged_attention_fused_ref(q, kp, vp, keeps, mask)
    torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)


# -------------------------------------------------------- the rebuild

def prmt(a, b, sel):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    the 8 bytes (a's 0-3, b's 4-7); ``sel`` an int or an array (one a lane)."""
    src = np.stack([(a >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)] +
                   [(b >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)])
    sel = np.broadcast_to(np.asarray(sel, np.uint32), np.shape(a))
    lanes = np.arange(src.shape[1])
    return sum(src[(sel >> np.uint32(4 * n)) & np.uint32(7), lanes] << np.uint32(8 * n)
               for n in range(4)).astype(np.uint32)


def swap_rows(a, b, shift, mask):
    """The kernel's swap_rows: b's bits under mask trade places with the
    bits ``shift`` above them in a."""
    t = ((a >> np.uint32(shift)) ^ b) & np.uint32(mask)
    return a ^ ((t << np.uint32(shift)) & M32), b ^ t


def rebuild_group(words, p0, keep):
    """Planes p0 .. p0 + 7 (zero at or past keep) -> t[c]: byte j of t[c]
    holds value 7 - c of byte column j, MSB first, as the kernel's."""
    zero = np.zeros_like(words[0])
    t = [words[p0 + 7 - r] if p0 + 7 - r < keep else zero for r in range(8)]
    for shift, mask, pairs in ((4, 0x0F0F0F0F, ((0, 4), (1, 5), (2, 6), (3, 7))),
                               (2, 0x33333333, ((0, 2), (1, 3), (4, 6), (5, 7))),
                               (1, 0x55555555, ((0, 1), (2, 3), (4, 5), (6, 7)))):
        for i, j in pairs:
            t[i], t[j] = swap_rows(t[i], t[j], shift, mask)
    return t


def rebuild_like_kernel(run: np.ndarray, keep: int, heads: int, hd8: int) -> np.ndarray:
    """One page's plane runs (16, 16 * heads * hd8) uint8, as the kernel's
    threads take them (one lane per 4-byte word; byte column j of word w is
    run byte 4w + j) -> (heads, 16, hd) uint16 bf16 patterns, each byte
    column's 8 values joined by the kernel's byte permutes and stored at its
    (token, head, byte)."""
    words = [run[i].view("<u4").astype(np.uint32) for i in range(16)]
    hi = rebuild_group(words, 0, keep)
    lo = rebuild_group(words, 8, keep)
    out = np.zeros((heads, 16, hd8 * 8), np.uint16)
    for j in range(4):
        if keep > 8:
            sel = j | j << 4 | (4 + j) << 8 | (4 + j) << 12
            pairs = [prmt(prmt(lo[7 - 2 * e], lo[6 - 2 * e], sel),
                          prmt(hi[7 - 2 * e], hi[6 - 2 * e], sel), 0x6240) for e in range(4)]
        else:
            sel = j | j << 4 | j << 8 | (4 + j) << 12
            pairs = [prmt(hi[7 - 2 * e], hi[6 - 2 * e], sel) & np.uint32(0xFF00FF00)
                     for e in range(4)]
        vals = np.stack(pairs, -1).astype("<u4").view("<u2")  # (words, 8)
        for w, row in enumerate(vals):
            byte = 4 * w + j
            t, rest = divmod(byte, heads * hd8)
            h, jj = divmod(rest, hd8)
            out[h, t, 8 * jj:8 * jj + 8] = row
    return out


@pytest.mark.parametrize("heads,hd", [(3, 64), (1, 8), (4, 128), (2, 24), (3, 8)])
@pytest.mark.parametrize("keep", range(17))
def test_rebuild_bit_algebra_matches_unpack_ref(keep, heads, hd):
    """Every keep; words that straddle heads (hd 24) and tokens (hd 8)."""
    rng = np.random.default_rng(keep * 31 + heads + hd)
    raw = torch.from_numpy(rng.integers(0, 1 << 16, (1, 16, heads, hd)).astype(np.uint16)
                           .view(np.int16)).view(torch.bfloat16)
    planes = R.pack_kv_ref(raw)  # (16, 1, 16, heads, hd/8)
    got = rebuild_like_kernel(planes.reshape(16, -1).numpy(), keep, heads, hd // 8)
    if keep == 0:  # no plane read: every value 0 (unpack_kv_ref takes keep >= 1)
        assert not got.any()
        return
    want = R.unpack_kv_ref(planes, keep)[0].view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want.transpose(1, 0, 2))


# ------------------------------------------------------- on the card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


def card_case(shape, seed, dev):
    """Random bf16 q, K and V; keeps {0, 4, 8, 16}; ragged lengths; row
    b - 1 with nothing valid (B >= 2)."""
    b, s, hkv, rep, hd = shape
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)

    q = randn(b, hkv, rep, hd)
    kp, vp = R.pack_kv_ref(randn(b, s, hkv, hd)), R.pack_kv_ref(randn(b, s, hkv, hd))
    choice = torch.tensor([0, 4, 8, 16], device=dev, dtype=torch.int32)
    keeps = choice[torch.randint(0, 4, (b, s // 16), generator=gen, device=dev)].contiguous()
    valid = torch.randint(1, s + 1, (b,), generator=gen, device=dev)
    valid[0] = s
    if b > 1:
        valid[-1] = 0
    tok_keep = keeps.repeat_interleave(16, dim=1)
    ok = torch.arange(s, device=dev)[None] < valid[:, None]
    mask = (ok & (tok_keep > 0)).to(torch.int8).contiguous()
    return q, kp, vp, keeps, mask, tok_keep


def _check_on_card(shape, seed, dev):
    q, kp, vp, keeps, mask, tok_keep = card_case(shape, seed, dev)
    got = K.paged_attention_fused(q, kp, vp, keeps, mask)
    want = R.paged_attention_fused_ref(q, kp, vp, keeps, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    if shape[0] > 1:
        assert torch.all(got[-1] == 0)
    parts, parts_r = [], []
    for keep in (4, 8, 16):
        mk = (mask * (tok_keep == keep)).to(torch.int8).contiguous()
        (o, m, l), (o_r, m_r, l_r) = (K.paged_attention_rung(q, kp, vp, mk, keep=keep),
                                      R.paged_attention_rung_ref(q, kp, vp, mk, keep))
        torch.cuda.synchronize()
        torch.testing.assert_close(m, m_r, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        torch.testing.assert_close(l, l_r, atol=KERNEL_TOL, rtol=KERNEL_TOL)
        # o is unnormalised: compare o / l (bf16(p) is rounded at another
        # maximum in the kernel, which a cancelling sum amplifies in o)
        torch.testing.assert_close(o / l.clamp(min=1e-30)[..., None],
                                   o_r / l_r.clamp(min=1e-30)[..., None],
                                   atol=KERNEL_TOL, rtol=KERNEL_TOL)
        parts.append((o, m, l))
        parts_r.append((o_r, m_r, l_r))
    torch.testing.assert_close(O.merge_rung_partials(parts), O.merge_rung_partials(parts_r),
                               atol=KERNEL_TOL, rtol=KERNEL_TOL)


# hd 8, 16, 24, 64, 128; rep 1, 3, 7, 8; head groups with 8-, 4- and
# 1-byte loads ((4, 256, 16, 1, 8), (2, 64, 12, 1, 16), (2, 64, 9, 1, 8))
CARD_SHAPES = [(1, 16, 1, 1, 8), (8, 1024, 3, 3, 64), (2, 4096, 4, 8, 128),
               (2, 1024, 8, 7, 128), (3, 256, 2, 1, 64), (2, 128, 6, 2, 24),
               (4, 256, 16, 1, 8), (2, 64, 12, 1, 16), (2, 64, 9, 1, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
def test_cuda_paged_attention_matches_plain_on_card(shape):
    _check_on_card(shape, seed=sum(shape), dev=_cuda())


@pytest.mark.cuda
def test_cuda_paged_attention_repeats_bit_for_bit():
    """The merge adds the splits in a fixed order: two calls agree exactly."""
    dev = _cuda()
    q, kp, vp, keeps, mask, tok_keep = card_case((8, 1024, 3, 3, 64), 7, dev)
    a = K.paged_attention_fused(q, kp, vp, keeps, mask)
    b = K.paged_attention_fused(q, kp, vp, keeps, mask)
    mk = (mask * (tok_keep == 8)).to(torch.int8).contiguous()
    r1 = K.paged_attention_rung(q, kp, vp, mk, keep=8)
    r2 = K.paged_attention_rung(q, kp, vp, mk, keep=8)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert all(torch.equal(x, y) for x, y in zip(r1, r2))


@pytest.mark.cuda
def test_cuda_paged_attention_stays_right_over_shapes_in_a_row():
    """Calls of other shapes (other plans, split counts and workspaces) one
    after the other on one stream, each held to its plain version."""
    dev = _cuda()
    for i, shape in enumerate([(8, 1024, 3, 3, 64), (2, 4096, 4, 8, 128), (1, 16, 1, 1, 8),
                               (8, 1024, 3, 3, 64), (4, 256, 16, 1, 8)]):
        _check_on_card(shape, seed=100 + i, dev=dev)
