"""The SSD scan's grouped b/c contract and the kernel's launch plan, on the
CPU.

``ops.ssd`` takes b and c per group, (B, L, G, N) with G dividing H, head
h reading group h // (H / G) as the model's groups-to-heads expansion
maps it; G = H is the reference's per-head contract.  Here: the grouped
call equals the call on b/c expanded to heads bit for bit (the plain
version expands before any product) and the reference's Pallas ``ssd``
(interpret mode) and ``ssd_scan`` on the expanded inputs within SSD_ATOL
(float32 on both sides, sums in another order; the reference's own kernel
test holds atol 1e-3); a G that does not divide H raises.  The launch
plan (blocks, workspaces, shared memory) is pure Python from the shapes
alone.  A mirror of the kernel's three steps (chunk states, the pass over
chunks, 64-row output tiles that skip every 8-column block above the
diagonal) in plain PyTorch holds the decomposition to the plain version
within 1e-5 of the largest output (float32, other sum orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ssd.ops import ssd as j_ssd_pallas
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref

from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd import ref as SR

torch.set_num_threads(1)

SSD_ATOL = 1e-3
MIRROR_REL = 1e-5


def _inputs(rng, b, l, h, p, n, g):
    """The reference kernel test's draws (unit-normal xdt, b, c, h0; da =
    -|N(0.05, 0.05)|), b and c per group."""
    xdt = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    da = -np.abs(rng.normal(0.05, 0.05, (b, l, h))).astype(np.float32)
    bg = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    cg = rng.normal(0, 1, (b, l, g, n)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32)
    return xdt, da, bg, cg, h0


def _expand(t, h):
    return np.repeat(t, h // t.shape[-2], axis=-2)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("l,chunk", [(256, 64), (200, 128), (45, 64)])
def test_ssd_grouped_equals_expanded_bit_for_bit(g, l, chunk):
    rng = np.random.default_rng(100 * g + l)
    xdt, da, bg, cg, h0 = _inputs(rng, 2, l, 4, 16, 8, g)
    t = torch.from_numpy
    y, hf = SO.ssd(t(xdt), t(da), t(bg), t(cg), t(h0), chunk=chunk)
    y_e, hf_e = SO.ssd(t(xdt), t(da), t(_expand(bg, 4)), t(_expand(cg, 4)), t(h0), chunk=chunk)
    assert torch.equal(y, y_e) and torch.equal(hf, hf_e)
    # the plain version's own expansion is the model's mapping
    assert torch.equal(SR.groups_to_heads(t(bg), 4), t(_expand(bg, 4)))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("l", [256, 200])
def test_ssd_grouped_matches_reference_kernel_and_scan(g, l):
    """The port's grouped call against the reference's Pallas ``ssd``
    (interpret mode) and ``ssd_scan`` on b/c expanded to heads, at the
    reference test's widths (H 4, P 32, N 16), chunk 64."""
    rng = np.random.default_rng(7 * l + g)
    xdt, da, bg, cg, h0 = _inputs(rng, 2, l, 4, 32, 16, g)
    y, hf = SO.ssd(*map(torch.from_numpy, (xdt, da, bg, cg, h0)), chunk=64)
    ins = (xdt, da, _expand(bg, 4), _expand(cg, 4))
    y_k, h_k = j_ssd_pallas(*map(jnp.asarray, ins), h0=jnp.asarray(h0), chunk=64)
    y_r, h_r = j_ssd_ref(*map(jnp.asarray, ins), h0=jnp.asarray(h0), chunk=64)
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SSD_ATOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), atol=SSD_ATOL)


@pytest.mark.parametrize("g", [3, 5, 8])
def test_ssd_rejects_groups_that_do_not_divide_heads(g):
    rng = np.random.default_rng(g)
    xdt, da, bg, cg, h0 = _inputs(rng, 1, 16, 4, 8, 4, g)
    with pytest.raises(ValueError, match="do not divide"):
        SO.ssd(*map(torch.from_numpy, (xdt, da, bg, cg, h0)), chunk=16)
    with pytest.raises(ValueError, match="do not divide"):
        SK.plan(1, 16, 4, g, 8, 4, 16)


@pytest.mark.parametrize("shape,blocks,states_mb", [
    # Mamba2-1.3B prefill: B 4, L 1024, H 64, G 1, P 64, N 128, Q 256
    ((4, 1024, 64, 1, 64, 128, 256), 4096, 33.554432),
    # Zamba2-7B prefill: B 2, L 4096, H 112, G 2, P 64, N 64, Q 256
    ((2, 4096, 112, 2, 64, 64, 256), 14336, 58.720256),
])
def test_plan_runs_the_chunks_in_parallel(shape, blocks, states_mb):
    bsz, l, h, g, p, n, q = shape
    pl = SK.plan(*shape)
    nc = l // q
    assert pl["chunks"] == nc and pl["row_tiles"] == q // SK.TOKENS
    assert pl["state_blocks"] == bsz * nc * h > bsz * h
    assert pl["output_blocks"] == blocks > bsz * h
    assert pl["states_shape"] == (bsz, nc, h, n, p) and pl["cum_shape"] == (bsz, h, l)
    assert 4 * np.prod(pl["states_shape"]) / 1e6 == pytest.approx(states_mb)
    assert pl["b_tf32_shape"] == (bsz, nc, h)
    assert pl["workspace_bytes"] == 4 * sum(np.prod(pl[k]) for k in (
        "states_shape", "cum_shape", "b_tf32_shape"))
    # the pass covers the whole state
    assert pl["pass_blocks"] * SK.PASS_THREADS * 4 >= bsz * h * n * p


@pytest.mark.parametrize("args,match", [
    ((1, 100, 4, 1, 8, 4, 64), "multiple of chunk"),
    ((1, 64, 4, 1, 6, 4, 64), "multiples of 4"),
    ((1, 64, 4, 1, 8, 6, 64), "multiples of 4"),
    ((1, 64, 4, 1, 132, 4, 64), "above the kernel"),
    ((1, 64, 4, 1, 128, 144, 64), "state pieces"),
])
def test_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        SK.plan(*args)


def _live(r0: int, jw: int) -> int:
    """ssd_output_kernel's count of live 8-column blocks on the diagonal
    tile for the 16-row strip at r0 and the 32-column half at jw."""
    return 0 if r0 + 15 < jw else min(4, (r0 + 15 - jw) // 8 + 1)


def _mirror(xdt, da, b, c, h0, q):
    """The kernel's three steps in plain float32 PyTorch, tile by tile:
    (a) each chunk's cumsum and state, (b) the pass that turns the chunk
    states into the states before each chunk, (c) each 64-row tile's y
    from its state and the column tiles j0 <= i0, skipping on the diagonal
    every 8-column block of a 16-row strip that lies wholly above it."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    nc, t = l // q, SK.TOKENS
    grp = torch.arange(h) // (h // g)
    cum = torch.zeros(bsz, h, l)
    states = torch.zeros(bsz, nc, h, n, p)
    for ci in range(nc):
        sl = slice(ci * q, ci * q + q)
        cc = torch.cumsum(da[:, sl], dim=1).transpose(1, 2)  # (B, H, Q)
        cum[:, :, sl] = cc
        w = torch.exp(cc[:, :, -1:] - cc)  # (B, H, Q)
        bh = b[:, sl][:, :, grp]  # (B, Q, H, N)
        states[:, ci] = torch.einsum("bjhn,bhj,bjhp->bhnp", bh, w, xdt[:, sl])
    state = h0.clone()
    for ci in range(nc):
        s = states[:, ci].clone()
        states[:, ci] = state
        state = state * torch.exp(cum[:, :, ci * q + q - 1])[..., None, None] + s
    y = torch.zeros_like(xdt)
    for ci in range(nc):
        for i0 in range(0, q, t):
            rows = min(t, q - i0)
            ii = ci * q + i0 + torch.arange(rows)
            ch = c[:, ii][:, :, grp]  # (B, rows, H, N)
            ci_cum = cum[:, :, ii]  # (B, H, rows)
            acc = torch.einsum("bihn,bhnp->bihp", ch, states[:, ci])
            acc = acc * torch.exp(ci_cum).transpose(1, 2)[..., None]
            for j0 in range(0, i0 + 1, t):
                jj = ci * q + j0 + torch.arange(min(t, q - j0))
                sc = torch.einsum("bihn,bjhn->bhij", ch, b[:, jj][:, :, grp])
                dec = ci_cum[..., :, None] - cum[:, :, jj][..., None, :]
                keep = torch.ones(rows, len(jj), dtype=torch.bool)
                if j0 == i0:
                    ti, tj = torch.arange(rows)[:, None], torch.arange(len(jj))[None]
                    # the blocks the kernel computes: warp (strip, half) takes
                    # the first `live` of its half's four 8-column blocks
                    live = torch.tensor([[_live(16 * (i // 16), 32 * (j // 32))
                                          for j in range(len(jj))] for i in range(rows)])
                    keep = (tj <= ti) & ((tj % 32) // 8 < live)
                sc = torch.where(keep, sc * torch.exp(torch.where(keep, dec, 0.0)), 0.0)
                acc = acc + torch.einsum("bhij,bjhp->bihp", sc, xdt[:, jj])
            y[:, ii] = acc
    return y, state


@pytest.mark.parametrize("l,q,g", [(512, 256, 1), (300, 100, 3), (37, 37, 1), (192, 64, 2)])
def test_three_step_mirror_equals_plain(l, q, g):
    rng = np.random.default_rng(l + q)
    ins = [torch.from_numpy(a) for a in _inputs(rng, 2, l, 6, 8, 16, g)]
    y, hf = _mirror(*ins, q)
    y_r, hf_r = SR.ssd_chunked(*ins, q)
    assert (y - y_r).abs().max() <= MIRROR_REL * y_r.abs().max()
    assert (hf - hf_r).abs().max() <= MIRROR_REL * hf_r.abs().max()
