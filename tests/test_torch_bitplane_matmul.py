"""The bit-plane matmul kernel's arithmetic that the CPU can reach.

The CUDA kernel (``src/repro_torch/csrc/bitplane_matmul.cu``) rebuilds the
weight from its planes with byte permutes and an 8 x 8 bit-matrix
transpose; ``rebuild_like_kernel`` below writes out the same masks, shifts
and byte selectors in NumPy, one array lane per kernel thread, and is held
bit for bit to the plain ``reconstruct_ref`` at every keep.  The launch plan
(x slabs, K splits) is pure Python in the wrapper and is checked here for
the shapes the chip smoke script times.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitplane_matmul import kernel as MK
from repro_torch.kernels.bitplane_matmul import ref as MR

M32 = np.uint32(0xFFFFFFFF)


def prmt(a, b, sel):
    """CUDA's __byte_perm: byte n of the result is byte (sel >> 4n) & 7 of
    the 8 bytes (a's 0-3, b's 4-7)."""
    src = [(a >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)] + \
          [(b >> np.uint32(8 * i)) & np.uint32(255) for i in range(4)]
    return sum((src[(sel >> (4 * n)) & 7] << np.uint32(8 * n)) for n in range(4)).astype(np.uint32)


def transpose8(hi, lo):
    """The kernel's transpose8, on uint32 arrays."""
    def stage(x, shift, mask):
        t = (x ^ (x >> np.uint32(shift))) & np.uint32(mask)
        return x ^ t ^ ((t << np.uint32(shift)) & M32)
    hi, lo = stage(hi, 7, 0x00AA00AA), stage(lo, 7, 0x00AA00AA)
    hi, lo = stage(hi, 14, 0x0000CCCC), stage(lo, 14, 0x0000CCCC)
    t = (lo ^ ((hi << np.uint32(4)) & M32)) & np.uint32(0xF0F0F0F0)
    return hi ^ (t >> np.uint32(4)), lo ^ t


def bytes4x4(w0, w1, w2, w3):
    u, v = prmt(w1, w0, 0x5140), prmt(w1, w0, 0x7362)
    u2, v2 = prmt(w3, w2, 0x5140), prmt(w3, w2, 0x7362)
    return [prmt(u2, u, 0x5410), prmt(u2, u, 0x7632), prmt(v2, v, 0x5410),
            prmt(v2, v, 0x7632)]


def rebuild_group(words, p0, pad, keep):
    zero = np.zeros_like(words[0])
    w = [words[p0 + p - pad] if 0 <= p0 + p - pad < keep else zero for p in range(8)]
    hi, lo = bytes4x4(*w[:4]), bytes4x4(*w[4:])
    return [list(x) for x in zip(*(transpose8(h, l) for h, l in zip(hi, lo)))]


def rebuild_like_kernel(planes: np.ndarray, keep: int, bits: int) -> np.ndarray:
    """planes (bits, K, N/8) uint8 -> (K, N) uint16 bf16 patterns, as the
    kernel's threads compute them: each lane one K row and 4 plane bytes."""
    _, k, n8 = planes.shape
    q = -(-n8 // 4)
    padded = np.zeros((bits, k, 4 * q), np.uint8)
    padded[:, :, :n8] = planes
    words = [padded[i].reshape(k, q, 4).view("<u4")[..., 0].astype(np.uint32)
             for i in range(bits)]
    pad = 16 - bits
    zero = [np.zeros((k, q), np.uint32)] * 4
    hh, hl = rebuild_group(words, 0, pad, keep) if keep > 0 and pad < 8 else (zero, zero)
    lh, ll = rebuild_group(words, 8, pad, keep) if keep > 0 and keep + pad > 8 else (zero, zero)
    out = np.zeros((k, q, 4, 4), np.uint32)  # (row, quad, byte column, bf16 pair)
    for j in range(4):
        out[:, :, j, 0] = prmt(lh[j], hh[j], 0x6273)
        out[:, :, j, 1] = prmt(lh[j], hh[j], 0x4051)
        out[:, :, j, 2] = prmt(ll[j], hl[j], 0x6273)
        out[:, :, j, 3] = prmt(ll[j], hl[j], 0x4051)
    values = out.astype("<u4").view("<u2").reshape(k, 4 * q * 8)
    return values[:, :n8 * 8]


def _planes(k, n, bits, seed):
    rng = np.random.default_rng(seed)
    raw = torch.from_numpy(rng.integers(0, 1 << bits, (k, n)).astype(np.int16))
    return MR.pack_weights_ref(raw, bits)


@pytest.mark.parametrize("keep,bits", [(keep, bits) for bits in (16, 12, 8, 5)
                                        for keep in range(bits + 1)])
def test_rebuild_bit_algebra_matches_reconstruct_ref(keep, bits):
    """Every keep at bits 16 and at narrower widths; n/8 = 9 leaves a
    partial quad of plane bytes, as a ragged N does in the kernel."""
    planes = _planes(40, 72, bits, seed=keep * 17 + bits)
    got = rebuild_like_kernel(planes.numpy(), keep, bits)
    want = MR.reconstruct_ref(planes, keep, bits).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)


def test_transpose8_is_the_bit_matrix_transpose():
    rng = np.random.default_rng(0)
    rows = rng.integers(0, 256, (64, 8)).astype(np.uint32)
    hi = (rows[:, 0] << 24) | (rows[:, 1] << 16) | (rows[:, 2] << 8) | rows[:, 3]
    lo = (rows[:, 4] << 24) | (rows[:, 5] << 16) | (rows[:, 6] << 8) | rows[:, 7]
    th, tl = transpose8(hi.astype(np.uint32), lo.astype(np.uint32))
    out = [(th >> np.uint32(24 - 8 * r)) & 255 for r in range(4)] + \
          [(tl >> np.uint32(24 - 8 * r)) & 255 for r in range(4)]
    for c in range(8):
        want = sum(((rows[:, r] >> (7 - c)) & 1) << (7 - r) for r in range(8))
        np.testing.assert_array_equal(out[c], want)


# the shapes chip_smoke.py times: the quickstart's, the Zamba2-7B MLP
# up-projection at decode (M 8) and at M 128, and M 64 (the card tests)
TIMED_SHAPES = [(8, 1024, 1024), (8, 3584, 14336), (128, 3584, 14336),
                (64, 3584, 14336), (16, 3584, 14336)]


@pytest.mark.parametrize("keep", [16, 8, 4])
@pytest.mark.parametrize("m,k,n", TIMED_SHAPES)
def test_plan_fills_the_card(m, k, n, keep):
    p = MK.plan(m, k, n, keep)
    assert p["blocks"] >= 132
    assert p["blocks"] == -(-n // p["bn"]) * p["splits"] * p["slabs"]


@pytest.mark.parametrize("m,k,n", TIMED_SHAPES + [
    (5, 100, 24), (8, 576, 192), (128, 1536, 576), (200, 3584, 14336), (1, 7, 8),
    (8, 0, 64), (300, 64, 8)])
@pytest.mark.parametrize("keep", [16, 1, 0])
def test_plan_splits_cover_k_and_slabs_cover_m(m, k, n, keep):
    p = MK.plan(m, k, n, keep)
    assert p["chunk"] % MK.SPLIT_ROWS == 0 and p["chunk"] > 0
    cover = [(s * p["chunk"], min(k, (s + 1) * p["chunk"])) for s in range(p["splits"])]
    assert cover[0][0] == 0 and cover[-1][1] == k
    assert all(a < b for a, b in cover) or k == 0
    assert all(b == c for (_, b), (c, _) in zip(cover, cover[1:]))
    # the smallest slab that holds m rows, else slabs of 128 rows
    assert p["mt"] in (1, 2, 4, 8) and (p["mt"] == 1 or m > 8 * p["mt"])
    # the decode path's conditions (the kernel refuses it otherwise)
    assert p["bn"] == 128 or (p["mt"] <= 2 and n % 128 == 0 and k % 8 == 0 and keep > 0
                              and p["chunk"] % MK.DECODE_SPLIT_ROWS == 0)
    assert p["slabs"] == max(1, -(-m // (16 * p["mt"])))
    assert p["slabs"] == 1 or p["mt"] == 8
