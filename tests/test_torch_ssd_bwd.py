"""The SSD scan's backward on the CPU: the closed form
(``ref.ssd_bwd_ref``, the function ``csrc/ssd_bwd.cu`` computes) against
the reference's gradient, ``jax.vjp`` of ``src/repro/models/ssm.py``
``ssd_scan`` (JAX's autodiff of the chunked body), and ``ops.SSDScan``
against torch autograd of the plain forward.

Inputs are drawn with numpy from a seed at realistic decays: dt from the
model's softplus over its ``dt_bias`` draw, A = -exp(a_log) with
exp(a_log) in [1, 16], so dt·A reaches about -4 a token.  Against JAX the
chunk is 32 tokens: at 256 a chunk's cumsum spans hundreds, and the
reference's ``jnp.where(mask, exp(seg), 0)`` then overflows in the masked
half, whose gradient is inf · 0 = NaN in every dda (the closed form, like
the forward, never forms that exponent; ``test_reference_dda_is_nan_at_
realistic_decays_and_q_256`` keeps the finding).  Bounds: every gradient
within 1e-5 relative Frobenius norm of JAX's (measured at most 7e-7; both
float32, sums in other orders) and of autograd's.  dda needs no more room:
the closed form leaves M's diagonal out of both its row and column sums,
where autodiff adds it to both and cancels it in float32.

A mirror of the kernel's decomposition (column tiles: each tile pair's
scores once, dxdt, db, the column terms, and for the row side M's sums
down the columns and the decayed score tiles; row tiles: dc from those
tiles and the row terms; the reverse pass's D_c = <G_{c+1}, h_{c+1}> in
per-warp slices; dda as one reverse cumsum of row less column terms) in
float64 equals the closed form to rounding and takes the TF32 passes the
kernel's bit checks pick, and the backward's launch plan is pure Python
from the shapes alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import ssm as JS

from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd import ref as SR

torch.set_num_threads(1)

JAX_FROBENIUS = 1e-5
AUTOGRAD_FROBENIUS = 1e-5
MIRROR_REL = 1e-12
NAMES = ("dxdt", "dda", "db", "dc", "dh0")


def _draw(b, l, h, p, n, g, seed=0, dtype=np.float32):
    """xdt, da, b, c, h0, dy, dh_final at the model's decays."""
    rng = np.random.default_rng(seed)
    a = -rng.uniform(1.0, 16.0, h)
    dt_bias = np.log(np.expm1(rng.uniform(1e-3, 1e-1, h)))
    dt = np.log1p(np.exp(rng.normal(0.0, 1.0, (b, l, h)) + dt_bias))
    xdt = rng.normal(0, 1, (b, l, h, p)) * dt[..., None]
    out = (xdt, dt * a, rng.normal(0, 1, (b, l, g, n)), rng.normal(0, 1, (b, l, g, n)),
           rng.normal(0, 1, (b, h, n, p)), rng.normal(0, 1, (b, l, h, p)),
           rng.normal(0, 1, (b, h, n, p)))
    return tuple(z.astype(dtype) for z in out)


def _frob(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _closed_form(xdt, da, b, c, h0, dy, dhf, chunk):
    """ssd_bwd_ref on the padded inputs, its gradients cut back to L."""
    t = torch.from_numpy
    l = xdt.shape[1]
    (xp, dap, bp, cp), q = SR.pad_to_chunks(t(xdt), t(da), t(b), t(c), chunk)
    _, _, cum, states = SR.ssd_chunked(xp, dap, bp, cp, t(h0), q, workspaces=True)
    dyp = torch.nn.functional.pad(t(dy), (0, 0, 0, 0, 0, xp.shape[1] - l))
    grads = SR.ssd_bwd_ref(xp, bp, cp, dyp, t(dhf), cum, states, q)
    return [gr[:, :l] for gr in grads[:4]] + [grads[4]]


def _jax_vjp(xdt, da, b, c, h0, dy, dhf, chunk):
    h = xdt.shape[2]

    def scan(xdt, da, b, c, h0):
        return JS.ssd_scan(xdt, da, JS._groups_to_heads(b, h), JS._groups_to_heads(c, h), h0,
                           chunk=chunk)

    _, vjp = jax.vjp(scan, *map(jnp.asarray, (xdt, da, b, c, h0)))
    return vjp((jnp.asarray(dy), jnp.asarray(dhf)))


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("l,chunk", [(100, 32), (20, 32), (96, 32)])
def test_closed_form_matches_jax_vjp(g, l, chunk):
    """G = 1, 2 and H (4 heads); L ragged (100 over chunks of 32), below
    one chunk (20: q = L) and whole; nonzero h0 and dh_final."""
    inputs = _draw(2, l, 4, 8, 16, g, seed=10 * g + l)
    got = _closed_form(*inputs, chunk)
    want = _jax_vjp(*inputs, chunk)
    for name, gr, w in zip(NAMES, got, want):
        assert gr.shape == w.shape, name
        assert _frob(gr, w) <= JAX_FROBENIUS, (name, _frob(gr, w))


def test_reference_dda_is_nan_at_realistic_decays_and_q_256():
    """At a 256-token chunk the reference's autodiff forms exp(cum_i -
    cum_j) for i < j too, which overflows: its dda is NaN; the closed form
    stays finite and its other gradients hold JAX's."""
    inputs = _draw(1, 512, 8, 16, 32, 2, seed=3)
    assert float(np.abs(inputs[1]).max()) * 256 > 88  # exp of it overflows float32
    got = _closed_form(*inputs, 256)
    want = _jax_vjp(*inputs, 256)
    assert np.isnan(np.asarray(want[1])).any()
    assert all(bool(torch.isfinite(gr).all()) for gr in got)
    for name, gr, w in zip(NAMES, got, want):
        if name != "dda":
            assert _frob(gr, w) <= JAX_FROBENIUS, (name, _frob(gr, w))


@pytest.mark.parametrize("with_h0", [True, False])
@pytest.mark.parametrize("chunk", [32, 128])
def test_ssd_scan_function_matches_autograd_of_the_plain_scan(with_h0, chunk):
    """ops.ssd under autograd (``SSDScan``: the plain forward with its
    workspaces, ``ssd_bwd_ref`` backward) against torch autograd of
    ``ssd_chunked`` on the same padded inputs (L 70: chunks of 32, the
    last ragged, or one chunk of 70): y bit for bit, every gradient within
    AUTOGRAD_FROBENIUS; dh0 only where h0 requires a gradient."""
    xdt, da, b, c, h0, dy, dhf = (torch.from_numpy(z) for z in _draw(2, 70, 4, 8, 12, 2, seed=5))
    ours = [t.clone().requires_grad_() for t in (xdt, da, b, c, h0)]
    y, hf = SO.ssd(*ours[:4], ours[4] if with_h0 else None, chunk=chunk)
    assert "SSDScan" in type(hf.grad_fn).__name__
    ((y * dy).sum() + (hf * dhf).sum()).backward()
    plain = [t.clone().requires_grad_() for t in (xdt, da, b, c, h0)]
    (xp, dap, bp, cp), q = SR.pad_to_chunks(*plain[:4], chunk)
    y_p, hf_p = SR.ssd_chunked(xp, dap, bp, cp, plain[4] if with_h0 else torch.zeros_like(h0), q)
    ((y_p[:, :70] * dy).sum() + (hf_p * dhf).sum()).backward()
    assert torch.equal(y, y_p[:, :70]) and torch.equal(hf, hf_p)
    for name, a, p in zip(NAMES, ours, plain):
        if name == "dh0" and not with_h0:
            assert a.grad is None
            continue
        assert _frob(a.grad, p.grad) <= AUTOGRAD_FROBENIUS, (name, _frob(a.grad, p.grad))


def test_serving_calls_keep_the_forward_alone():
    """No grad wanted, no SSDScan: the forward as before."""
    xdt, da, b, c, h0, _, _ = (torch.from_numpy(z) for z in _draw(1, 40, 2, 4, 8, 1))
    y, _ = SO.ssd(xdt, da, b, c, h0, chunk=32)
    assert y.grad_fn is None
    with torch.no_grad():
        y, _ = SO.ssd(xdt.requires_grad_(), da, b, c, h0, chunk=32)
    assert y.grad_fn is None


def _tf32_valued(t) -> bool:
    """What the kernels check of a tile they read: every value a float32
    whose low 13 mantissa bits are zero (a TF32 value, as bf16 values
    are)."""
    t32 = t.float()
    return bool((t32.double() == t.double()).all()) and bool(
        ((t32.view(torch.int32) & 0x1FFF) == 0).all())


#: the backward's products, in the order of chip_smoke's ``ssd_bwd_work``:
#: the Q x Q ones (the scores c.b, dy.xdt, dxdt's, db's and dc's intra
#: parts), then the Q x N x P ones (dxdt's G term, db's G term, dc's h
#: term, the reverse pass's input c (x) dy); with the operand of each that
#: may be exact in TF32 ("b", "c", both or neither)
PRODUCTS = (("scores", "bc"), ("dy.xdt", ""), ("dxdt intra", ""), ("db intra", "c"),
            ("dc intra", "b"), ("dxdt state", "b"), ("db state", ""), ("dc inter", ""),
            ("chunk grad", "c"))


def _passes(b_exact: bool, c_exact: bool) -> tuple:
    """The TF32 passes ``csrc/ssd_bwd.cu`` takes for each of
    :data:`PRODUCTS` when the tiles of b and c it reads are (or are not)
    TF32-valued, as bf16 values are: three for a product of two float32
    operands (hi.hi, hi.lo, lo.hi), one fewer for each exact operand (its
    lo is zero)."""
    exact = {"b": b_exact, "c": c_exact}
    return tuple(3 - sum(exact[o] for o in ops) for _, ops in PRODUCTS)


def _kernel_mirror(xdt, b, c, dy, dhf, hfin, cum, states, q, tile=64):
    """csrc/ssd_bwd.cu's decomposition in plain PyTorch (float64): (a) the
    chunks' sums c_i (x) exp(cum_i) dy_i, (b) the reverse pass (G_{c+1},
    dh0, D_c = <G_{c+1}, h_{c+1}> summed over per-warp slices), (c) column
    tiles j over row tiles i >= j: each tile pair's two score tiles once,
    dxdt_j, per-head db_j and colterm_j from them, and for the row side M's
    sums down the pair's columns (rowpart) and the decayed dy.xdt tile
    (escore), (d) row tiles i: per-head dc_i from the inter part and
    escore's tiles times b_j over j <= i, rowterm_i from the inter part and
    rowpart in column-tile order, (e) dda as the reverse cumsum of rowterm
    - colterm plus D_c, and the group sums in head order.  Each product
    records the TF32 passes the kernel takes for it, from the tiles' bits
    (a TF32-valued operand drops its lo pass): returns (gradients, {product:
    set of passes})."""
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    nc, nt = l // q, -(-q // tile)
    bh, ch = SR.groups_to_heads(b, h), SR.groups_to_heads(c, h)
    dx = torch.zeros_like(xdt)
    db_h, dc_h = torch.zeros_like(bh), torch.zeros_like(ch)
    rowterm, colterm = torch.zeros_like(cum), torch.zeros_like(cum)
    gst = torch.empty_like(states)
    np4 = n * p // 4
    slices = -(-np4 // 128) * 4
    dpart = torch.zeros((bsz, nc, h, slices), dtype=xdt.dtype)
    dh0 = torch.empty_like(states[:, 0])
    routes = {name: set() for name, _ in PRODUCTS}

    def prod(name, a, m, a_exact, m_exact):
        routes[name].add(3 - int(a_exact) - int(m_exact))
        return a @ m

    for bi in range(bsz):
        for hi in range(h):
            crow = cum[bi, hi]
            for ci in range(nc):  # (a), a token tile at a time
                gsum = torch.zeros((n, p), dtype=xdt.dtype)
                for k in range(nt):
                    s = slice(ci * q + k * tile, ci * q + min(q, (k + 1) * tile))
                    ct = ch[bi, s, hi]
                    gsum = gsum + prod("chunk grad", ct.T, torch.exp(crow[s])[:, None]
                                       * dy[bi, s, hi], _tf32_valued(ct), False)
                gst[bi, ci, hi] = gsum
            gv = torch.zeros((n, p), dtype=xdt.dtype) if dhf is None else dhf[bi, hi]
            hn = torch.zeros((n, p), dtype=xdt.dtype) if dhf is None else hfin[bi, hi]
            for ci in reversed(range(nc)):  # (b)
                t_c = gst[bi, ci, hi].clone()
                gst[bi, ci, hi] = gv
                prod_ = (gv * hn).reshape(-1)
                for w in range(slices):  # a warp's 32 threads x 4 elements
                    dpart[bi, ci, hi, w] = prod_[w * 128:(w + 1) * 128].sum()
                gv = gv * torch.exp(crow[ci * q + q - 1]) + t_c
                hn = states[bi, ci, hi]
            dh0[bi, hi] = gv
            for ci in range(nc):
                t0 = ci * q
                cq = crow[t0 + q - 1]
                gn, hc = gst[bi, ci, hi], states[bi, ci, hi]

                def rows_of(k):
                    return slice(t0 + k * tile, t0 + min(q, (k + 1) * tile))

                def decay(ri, rj):  # L over rows ri, columns rj (i >= j kept)
                    ii = torch.arange(ri.start, ri.stop)[:, None]
                    jj = torch.arange(rj.start, rj.stop)[None, :]
                    e = (crow[ri][:, None] - crow[rj][None, :]).masked_fill(jj > ii, 0.0)
                    return torch.exp(e).masked_fill(jj > ii, 0.0), ii == jj

                escore, rowpart = {}, {}
                for jt in range(nt):  # (c)
                    rj = rows_of(jt)
                    bj, xj = bh[bi, rj, hi], xdt[bi, rj, hi]
                    b_ex = _tf32_valued(bj)
                    w = torch.exp(cq - crow[rj])[:, None]
                    ax = w * prod("dxdt state", bj, gn, b_ex, False)
                    ab = w * prod("db state", xj, gn.T, False, False)
                    col = (xj * ax).sum(-1)
                    for it in range(jt, nt):
                        ri = rows_of(it)
                        ci_, yi = ch[bi, ri, hi], dy[bi, ri, hi]
                        c_ex = _tf32_valued(ci_)
                        lm, eye = decay(ri, rj)
                        s_ij = prod("scores", ci_, bj.T, c_ex, b_ex) * lm
                        dp = prod("dy.xdt", yi, xj.T, False, False)
                        e_ij = dp * lm
                        ax = ax + prod("dxdt intra", s_ij.T, yi, False, False)
                        ab = ab + prod("db intra", e_ij.T, ci_, False, c_ex)
                        m = (s_ij * dp).masked_fill(eye, 0.0)
                        col = col + m.sum(0)
                        rowpart[it, jt], escore[it, jt] = m.sum(1), e_ij
                    dx[bi, rj, hi], db_h[bi, rj, hi], colterm[bi, hi, rj] = ax, ab, col
                for it in range(nt):  # (d)
                    ri = rows_of(it)
                    ci_, yi = ch[bi, ri, hi], dy[bi, ri, hi]
                    acc = torch.exp(crow[ri])[:, None] * prod("dc inter", yi, hc.T, False, False)
                    row = (ci_ * acc).sum(-1)
                    for jt in range(it + 1):
                        bj = bh[bi, rows_of(jt), hi]
                        acc = acc + prod("dc intra", escore[it, jt], bj, False, _tf32_valued(bj))
                    for jt in range(it + 1):
                        row = row + rowpart[it, jt]
                    dc_h[bi, ri, hi], rowterm[bi, hi, ri] = acc, row
    dda = torch.empty((bsz, l, h), dtype=xdt.dtype)
    for bi in range(bsz):  # (e)
        for hi in range(h):
            for ci in range(nc):
                s = slice(ci * q, (ci + 1) * q)
                d = rowterm[bi, hi, s] - colterm[bi, hi, s]
                run = torch.flip(torch.cumsum(torch.flip(d, (0,)), 0), (0,))
                dda[bi, s, hi] = run + dpart[bi, ci, hi].sum()
    rep = h // g
    db = db_h.reshape(bsz, l, g, rep, n).sum(3)
    dc = dc_h.reshape(bsz, l, g, rep, n).sum(3)
    return (dx, dda, db, dc, dh0), routes


@pytest.mark.parametrize("l,q,g,with_dh,bc", [(256, 128, 1, True, "f32"),
                                              (200, 100, 2, True, "f32"),
                                              (96, 96, 4, False, "f32"),
                                              (256, 128, 2, True, "bf16"),
                                              (200, 100, 1, False, "b bf16")])
def test_kernel_decomposition_mirror_equals_closed_form(l, q, g, with_dh, bc):
    """Tiles of 64 over chunks of 128, 100 (a ragged last tile) and 96;
    D_c from the pass's slices, where the closed form sums exp(cum_Q)
    <G_{c+1}, h_c> and the w terms; float64.  b and c drawn (every product
    three TF32 passes), both bf16-valued (the models' case: the scores one
    pass, the products with b or c two) or b alone: the passes each
    product took are :func:`_passes`'s for those bits."""
    xdt, da, b, c, h0, dy, dhf = (torch.from_numpy(z) for z in
                                  _draw(1, l, 4, 8, 12, g, seed=l, dtype=np.float64))
    if bc != "f32":
        b = b.bfloat16().double()
    if bc == "bf16":
        c = c.bfloat16().double()
    dhf = dhf if with_dh else None
    _, hfin, cum, states = SR.ssd_chunked(xdt, da, b, c, h0, q, workspaces=True)
    want = SR.ssd_bwd_ref(xdt, b, c, dy, dhf, cum, states, q)
    got, routes = _kernel_mirror(xdt, b, c, dy, dhf, hfin, cum, states, q)
    for name, gr, w in zip(NAMES, got, want):
        assert _frob(gr, w) <= MIRROR_REL, (name, _frob(gr, w))
    passes = _passes(bc != "f32", bc == "bf16")
    assert [routes[name] for name, _ in PRODUCTS] == [{k} for k in passes]


@pytest.mark.parametrize("shape", [
    (1, 4096, 64, 1, 64, 128, 256),   # Mamba2-1.3B's training micro-batch
    (1, 4096, 112, 2, 64, 64, 256),   # Zamba2-7B's
    (2, 100, 4, 2, 8, 12, 100),
])
def test_backward_plan_from_the_shapes(shape):
    """The workspaces the wrapper allocates from the shapes: G_{c+1} a
    chunk, db and dc a head, the row and column sums of dcum, the tile
    pairs' decayed score tiles (ten pairs of 64 x 64 at a 256-token chunk)
    and the column tiles' parts of M's row sums."""
    pl = SK.plan_bwd(*shape)
    bsz, l, h, g, p, n, q = shape
    nt = -(-q // 64)
    assert pl == {"gst_shape": (bsz, l // q, h, n, p), "per_head_shape": (bsz, l, h, n),
                  "term_shape": (bsz, h, l),
                  "score_tiles_shape": (bsz, l // q, h, nt * (nt + 1) // 2, 64, 64),
                  "row_part_shape": (bsz, l // q, h, nt, q)}
    if q == 256:
        assert pl["score_tiles_shape"][3] == 10


@pytest.mark.parametrize("args,match", [
    ((1, 100, 4, 1, 8, 8, 64), "multiple of chunk"),
    ((1, 128, 4, 3, 8, 8, 64), "do not divide"),
    ((1, 128, 4, 1, 6, 8, 64), "multiples of 4"),
    ((1, 128, 4, 1, 8, 256, 64), "at most 128"),
    ((1, 128, 4, 1, 128, 128, 64), "state pieces"),
])
def test_backward_plan_refuses_what_the_kernel_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        SK.plan_bwd(*args)


def test_backward_wrapper_refuses_cpu_tensors():
    t = torch.zeros((1, 64, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.ssd_bwd(t, t, t, t, t, t, t, None, chunk=64)
