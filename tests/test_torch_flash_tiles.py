"""The flash kernel's key tiles with key positions, on the CPU: the plain
mirror of the kernel's sort of tiles (``ref.key_tile_classes``: skip,
whole, partial, from each tile's position bounds and each block's query
range) over sliding-window ring layouts drawn with hypothesis.

A ring of S slots after L tokens holds at slot s the latest position p < L
with p % S == s (the port's ``_ring_chunk_append``), so its positions run
in order but for one wrap point at slot L % S, inside a tile or on a
tile's edge; some slots are left unfilled (-1); a chunk of c tokens follows
at positions L .. L + c - 1, its kv_valid the chunk's end or a ragged
earlier one.  A whole tile must have every key visible to every query of
the block, a skipped one none to any; and attention computed the kernel's
way (skipped tiles dropped from a block's online softmax, whole tiles
unmasked, partial ones tested key by key) equals ``flash_attention_ref``'s
at the same chunk of 128 keys bit for bit, on every row that sees a key.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # bare env: fixed-seed fallback shim
    from _hypothesis_fallback import given, settings, st

from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ref as FR

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402

torch.set_num_threads(1)


def ring_layout(slots: int, length: int, chunk: int, holes: list, valid_cut: int):
    """(q_pos (1, c), kv_pos (1, S + c), kv_valid (1,)) of a ring chunk:
    the ring after ``length`` tokens with the slots in ``holes`` unfilled,
    then the chunk; kv_valid ends ``valid_cut`` tokens before the chunk's
    end (at least one real token)."""
    pos = np.full(slots, -1, np.int64)
    for p in range(max(0, length - slots), length):
        pos[p % slots] = p
    pos[[h % slots for h in holes]] = -1
    q_pos = length + np.arange(chunk)
    kv_pos = np.concatenate([pos, q_pos])
    kv_valid = np.array([length + chunk - min(valid_cut, chunk - 1)])
    return (torch.from_numpy(q_pos[None]).to(torch.int32),
            torch.from_numpy(kv_pos[None]).to(torch.int32),
            torch.from_numpy(kv_valid).to(torch.int32))


@st.composite
def layouts(draw, max_slots=4096, max_chunk=4096):
    """A ring layout: S slots (a multiple of 64, as the models' windows
    are, or any), a length that puts the wrap inside a tile or on its edge,
    a few unfilled slots, a chunk of 1 .. max_chunk tokens, a window at most
    S, a ragged kv_valid, the tokens of a block (128 / rep)."""
    slots = draw(st.sampled_from([64 * draw(st.integers(1, max_slots // 64)),
                                  draw(st.integers(1, max_slots))]))
    wrap = draw(st.sampled_from([0, 128 * draw(st.integers(0, 31)), draw(st.integers(0, 4095))]))
    laps = draw(st.integers(0, 2))
    length = laps * slots + wrap % slots if laps else min(wrap, slots)
    holes = draw(st.lists(st.integers(0, max_slots), min_size=0, max_size=3))
    chunk = draw(st.sampled_from([1, draw(st.integers(2, 300)), draw(st.integers(1, max_chunk))]))
    window = draw(st.sampled_from([slots, draw(st.integers(1, slots))]))
    valid_cut = draw(st.sampled_from([0, 0, draw(st.integers(0, max_chunk))]))
    tokens = draw(st.sampled_from([128, 64, 32, 16]))
    causal = draw(st.sampled_from([True, True, True, False]))
    return slots, length, holes, chunk, window, valid_cut, tokens, causal


def visible(q_pos, kv_pos, kv_valid, causal, window):
    """(B, Sq, Skv) bool: which key each query may see (the kernel's and
    the plain version's per-key test)."""
    qp, kp = q_pos[:, :, None].long(), kv_pos[:, None, :].long()
    ok = (kp >= 0) & (kp < kv_valid.long()[:, None, None])
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return ok


def blocks_of(ok, tokens):
    """(B, Sq, Skv) -> (B, query blocks, tokens, key tiles, 128): the padded
    queries repeat the last real one (the kernel's padded rows take a real
    row's position), the padded keys are never visible."""
    b, sq, skv = ok.shape
    qb, kt = -(-sq // tokens), -(-skv // FR.KEYS)
    ok = torch.cat([ok, ok[:, -1:].expand(b, qb * tokens - sq, skv)], dim=1)
    ok = torch.nn.functional.pad(ok, (0, kt * FR.KEYS - skv))
    return ok.view(b, qb, tokens, kt, FR.KEYS)


def check_classes(layout):
    slots, length, holes, chunk, window, valid_cut, tokens, causal = layout
    q_pos, kv_pos, kv_valid = ring_layout(slots, length, chunk, holes, valid_cut)
    cls = FR.key_tile_classes(q_pos, kv_pos, kv_valid, causal, window, tokens)
    ok = blocks_of(visible(q_pos, kv_pos, kv_valid, causal, window), tokens)
    seen_all = ok.all(-1).all(2)   # (B, blocks, tiles): every query sees every key
    seen_any = ok.any(-1).any(2)
    assert bool(seen_all[cls == FR.WHOLE].all()), layout
    assert not bool(seen_any[cls == FR.SKIP].any()), layout
    return cls, seen_any


@given(layouts())
@settings(max_examples=60, deadline=None)
def test_whole_tiles_are_seen_whole_and_skipped_tiles_not_at_all(layout):
    check_classes(layout)


@pytest.mark.parametrize("slots,length,chunk,window", [
    (4096, 6096, 512, 4096),    # phase 6's ring chunk: a full ring, the wrap inside tile 15
    (4096, 6096, 4096, 4096),
    (4096, 3000, 512, 4096),    # a ring of which 3,000 slots were written
    (4096, 8192, 512, 4096),    # the wrap on a tile's edge
])
def test_ring_chunk_leaves_only_edge_wrap_and_diagonal_tiles_partial(slots, length, chunk, window):
    """At phase 6's ring rows (Mixtral's 32 / 8 heads: 32 tokens a block)
    a block's partial tiles are the ones at the window edge, at the wrap
    and on the causal diagonal: at most four of the ring's and two of the
    chunk's, and every tile some query sees is visited."""
    cls, seen_any = check_classes((slots, length, [], chunk, window, 0, 32, True))
    ring_tiles = slots // FR.KEYS
    assert int((cls[..., :ring_tiles] == FR.PARTIAL).sum(-1).max()) <= 4
    assert int((cls[..., ring_tiles:] == FR.PARTIAL).sum(-1).max()) <= 2
    assert bool(((cls != FR.SKIP) | ~seen_any).all())
    # most of the ring is taken whole where the ring is full
    if length >= slots + chunk:
        assert float((cls[..., :ring_tiles] == FR.WHOLE).float().mean()) > 0.5


@pytest.mark.parametrize("length,chunk", [(1024 + 300, 64), (2048, 64), (1024 + 127, 200),
                                          (700, 64)])
def test_every_window_across_the_tile_edges(length, chunk):
    """Each window from 1 to the ring's 1,024 slots, so that the window's
    edge falls on every key of a tile (its first, its last) for some
    block: an edge one key off in the sort shows here."""
    for window in range(1, 1025):
        check_classes((1024, length, [], chunk, window, 0, 32, True))


def tiled_attention(q, k, v, q_pos, kv_pos, kv_valid, causal, window, tokens):
    """The kernel's walk with key positions, in plain PyTorch: the plain
    version's online softmax over chunks of 128 keys, in which for each
    block of ``tokens`` queries a SKIP tile leaves the block's running
    max, sum and accumulator as they were, a WHOLE tile is not masked and
    a PARTIAL one tests every key."""
    b, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    keys = FR.KEYS
    cls = FR.key_tile_classes(q_pos, kv_pos, kv_valid, causal, window, tokens)
    row_block = torch.arange(sq) // tokens
    hm = torch.arange(hp) // (hp // hkv)
    scale = torch.tensor(1.0 / np.sqrt(hd), dtype=torch.float32)
    qf = q.float()
    m = torch.full((b, hp, sq), FR.NEG_INF, dtype=torch.float32)
    l = torch.zeros((b, hp, sq), dtype=torch.float32)
    acc = torch.zeros((b, hp, sq, hd), dtype=torch.float32)
    ok_all = visible(q_pos, kv_pos, kv_valid, causal, window)[:, None]  # (B, 1, Sq, Skv)
    for t, c0 in enumerate(range(0, skv, keys)):
        kh = k[:, c0:c0 + keys][:, :, hm].float()
        vh = v[:, c0:c0 + keys][:, :, hm].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kh) * scale
        c = cls[:, row_block, t][:, None, :, None]  # (B, 1, Sq, 1)
        ok = torch.where(c == FR.WHOLE, True, ok_all[..., c0:c0 + keys])
        s = torch.where(ok, s, torch.full_like(s, FR.NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = l * corr + p.sum(dim=-1)
        acc_new = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                       p.to(q.dtype).float(), vh)
        keep = c[..., 0] == FR.SKIP  # (B, 1, Sq)
        m = torch.where(keep, m, m_new)
        l = torch.where(keep, l, l_new)
        acc = torch.where(keep[..., None], acc, acc_new)
    return (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(1, 2).to(q.dtype)


@given(layouts(max_slots=512, max_chunk=320))
@settings(max_examples=25, deadline=None)
def test_tiled_attention_equals_the_plain_version_bit_for_bit(layout):
    """Dropping the skipped tiles and unmasking the whole ones changes no
    bit of any row that sees a key (a row that sees none is the plain
    version's finite garbage, and 0 in the kernel)."""
    slots, length, holes, chunk, window, valid_cut, tokens, causal = layout
    q_pos, kv_pos, kv_valid = ring_layout(slots, length, chunk, holes, valid_cut)
    rng = np.random.default_rng(slots * 7919 + length)
    hp, hkv, hd = 128 // tokens, 1, 16
    skv = kv_pos.shape[1]
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((1, chunk, hp, hd), (1, skv, hkv, hd), (1, skv, hkv, hd)))
    want = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid, causal=causal,
                                  window=window, chunk=FR.KEYS, kv_pos=kv_pos)
    got = tiled_attention(q, k, v, q_pos, kv_pos, kv_valid, causal, window, tokens)
    seen = visible(q_pos, kv_pos, kv_valid, causal, window).any(-1)  # (B, Sq)
    assert torch.equal(got[seen], want[seen]), layout


def test_bounds_of_a_wrapped_tile_and_a_ragged_one():
    """The pre-pass's mirror: a tile holding the wrap spans the newest and
    the oldest positions; unfilled slots and columns past Skv are holes; a
    tile with no filled key has least > greatest."""
    kv_pos = torch.tensor([[5, 6, -1, 2, 3] + [-1] * 123 + [7, 8]], dtype=torch.int32)
    bd = FR.key_tile_bounds(kv_pos)
    assert bd.tolist() == [[[2, 6, 1], [7, 8, 1]]]
    empty = FR.key_tile_bounds(torch.full((1, 128), -1, dtype=torch.int32))
    assert int(empty[0, 0, 0]) > int(empty[0, 0, 1])
    assert FK.key_bounds_shape(2, 4096 + 512) == (2, 36, 4)


def test_dominant_key_cases_sit_where_they_say():
    """Phase 6's dominant-key cases in the full ring of its ring rows: the
    key just inside the window's edge is the first query's alone, the key
    just past it no query's, the newest ring key (the last slot before the
    wrap) every query's, and an old position the early queries' only; each
    key's tile is the one the sort must get right for those rows."""
    rows = {case: C.dominant_key_rows(pos) for case, pos in C.RING_DOMINANT}
    assert list(rows.values()) == [1, 0, C.RING_DOMINANT_CHUNK, 100]
    w, start, c = 4096, 4096 + 2000, C.RING_DOMINANT_CHUNK
    ring = C.ring_positions(torch, torch.device("cpu"), 1, w, (start,))
    assert int(ring[0, 1999]) == 6095 and int(ring[0, 2000]) == 2000  # the wrap
    q_pos = (start + torch.arange(c, dtype=torch.int32))[None]
    kv_pos = torch.cat([ring, q_pos], dim=1)
    kv_valid = torch.tensor([start + c], dtype=torch.int32)
    cls = FR.key_tile_classes(q_pos, kv_pos, kv_valid, True, w, 32)
    for case, pos in C.RING_DOMINANT:
        tile = (pos % w) // FR.KEYS
        seeing = {qb for qb in range(cls.shape[1])
                  if any(q - w < pos <= q for q in range(start + 32 * qb, start + 32 * qb + 32))}
        assert seeing == {qb for qb in seeing if int(cls[0, qb, tile]) != FR.SKIP}, case
