"""The fused cluster-and-encode of a token-major KV view, on the CPU.

The port's encode entry point reads a (..., tokens, channels) view in
place and writes channel-major groups, the tail group padded by repeating
the last token.  Here its plain version (which a CPU tensor takes) is held
bit for bit against the JAX package (its NumPy clustering and its Pallas
encode in interpret mode, after the store's tail pad), and a NumPy mirror
of the CUDA kernel's addressing (``csrc/exp_delta.cu``: layout, tile plan,
staged rows, the clamp, the byte path) is held against the plain version.
The memory tier's ``encode_kv`` and ``encode_pages`` give the same bytes
on a strided view as on its contiguous copy.

    PYTHONPATH=src python -m pytest -q tests/test_torch_exp_delta_grouped.py
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import kv_clustering as JC
from repro.core.bitplane import SPECS as J_SPECS
from repro.kernels.exp_delta import ops as j_ops

from repro_torch.core import compressed_store as TS
from repro_torch.core import kv_clustering as TC
from repro_torch.core.bitplane import SPECS as T_SPECS
from repro_torch.kernels.exp_delta import kernel as K
from repro_torch.kernels.exp_delta import ops as t_ops
from repro_torch.kernels.exp_delta import ref as t_ref

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

HOST = {8: np.uint8, 16: np.uint16, 32: np.uint32}
SIGNED = {8: np.uint8, 16: np.int16, 32: np.int32}


def _bits(rng, bits, shape) -> torch.Tensor:
    u = rng.integers(0, 2**bits, shape, dtype=np.uint64).astype(HOST[bits])
    return torch.from_numpy(u.view(SIGNED[bits]))


def _host(t: torch.Tensor, bits: int) -> np.ndarray:
    return t.contiguous().numpy().view(HOST[bits])


def _view(kind: str, rng, bits: int, t: int, c: int, layers: int = 2) -> torch.Tensor:
    """A raw-bit view of the kind the memory tier holds, or one that takes
    the kernel's byte path."""
    if kind == "tokens":  # put_sequence's and compress_kv's (t, C)
        return _bits(rng, bits, (t, c))
    if kind == "span":  # slot_kv_bits: (layers, 2, t, C) of a (2, layers, t, C) tensor
        return _bits(rng, bits, (2, layers, t, c)).transpose(0, 1)
    if kind == "pages":  # (pages, page_tokens, C)
        return _bits(rng, bits, (3, t, c))
    if kind == "wide":  # channels of a wider row: token stride C + 8, start at 3
        return _bits(rng, bits, (t, c + 8))[:, 3 : 3 + c]
    if kind == "offset":  # a view one value past an aligned start
        return _bits(rng, bits, (t * c + 1,))[1:].view(t, c)
    if kind == "reactivated":  # one stream of one layer of a span view
        return _view("span", rng, bits, t, c, layers=1)[0, 1]
    if kind == "rows":  # the flat entry point's (R, G) rows as (R, G, 1): R = t, G = c
        return _bits(rng, bits, (t, c))[:, :, None]
    if kind == "rows_offset":  # the same one value past an aligned start
        return _bits(rng, bits, (t * c + 1,))[1:].view(t, c, 1)
    raise ValueError(kind)


def _slices(view: torch.Tensor) -> list:
    """The (t, C) slices of a view in row-major order of its leading dims."""
    return list(view.reshape(-1, *view.shape[-2:]).unbind(0)) if view.dim() > 2 else [view]


def _jax_pad(u: np.ndarray, group: int) -> np.ndarray:
    pad = (-u.shape[0]) % group
    return np.concatenate([u, np.repeat(u[-1:], pad, axis=0)]) if pad else u


@pytest.mark.parametrize("kind,t", [("tokens", 37), ("span", 70), ("tokens", 1),
                                    ("span", 32)])
@pytest.mark.parametrize("group", [16, 12, 8])
@pytest.mark.parametrize("spec_name", ["bf16", "fp8_e4m3", "fp32"])
def test_plain_cluster_encode_matches_reference(spec_name, group, kind, t):
    """The plain version (a CPU tensor's route) against the reference's
    NumPy ``cluster_and_encode_np`` and against its ``cluster`` followed by
    the Pallas encode in interpret mode, each slice padded as the store
    pads it, bit for bit."""
    js, ts = J_SPECS[spec_name], T_SPECS[spec_name]
    rng = np.random.default_rng(group * 100 + t + ts.bits)
    view = _view(kind, rng, ts.bits, t, 24)
    enc, base = t_ops.cluster_encode(view, ts, group)
    n_pages = -(-t // group)
    assert enc.shape == (*view.shape[:-2], n_pages, 24, group) and enc.is_contiguous()
    assert base.shape == enc.shape[:-1] and base.dtype == torch.uint8
    want_np, want_b, grouped = [], [], []
    for s in _slices(view):
        u = _jax_pad(_host(s, ts.bits), group)
        e, b = JC.cluster_and_encode_np(u, js, group)
        want_np.append(e)
        want_b.append(b)
        grouped.append(np.asarray(JC.cluster(jnp.asarray(u), group)))
    got_e = _host(enc, ts.bits).reshape(-1, 24, group)
    got_b = base.numpy().reshape(-1, 24)
    np.testing.assert_array_equal(got_e, np.concatenate(want_np))
    np.testing.assert_array_equal(got_b, np.concatenate(want_b))
    rows = np.concatenate(grouped).reshape(-1, group)
    enc_j, base_j = j_ops.encode(jnp.asarray(rows.astype(np.uint32)), js)
    np.testing.assert_array_equal(got_e.reshape(-1, group),
                                  np.asarray(enc_j).astype(HOST[ts.bits]))
    np.testing.assert_array_equal(got_b.reshape(-1), np.asarray(base_j))


def test_integer_spec_groups_with_zero_bases():
    """An integer spec has no exponent: the store's delta mode groups it
    with zero bases; the encode's entry point refuses it."""
    rng = np.random.default_rng(3)
    view = _view("span", rng, 8, 21, 16)
    enc, base = TC.cluster_and_encode(view, T_SPECS["int8"], 16)
    assert torch.equal(enc, TC.cluster(view, 16)) and not base.any()
    assert enc.shape == (2, 2, 2, 16, 16)
    with pytest.raises(ValueError, match="no exponent"):
        t_ops.cluster_encode(view, T_SPECS["int8"], 16)


# ---------------------------------------------------------------------------
# A NumPy mirror of csrc/exp_delta.cu's encode
# ---------------------------------------------------------------------------


def _page_origin(lay: dict, p: int) -> tuple:
    """The kernel's page_origin: (offset of page p's first token, index in
    the page of its last real token)."""
    g = lay["g"]
    off, pp = 0, p
    if lay["n_pages"] != lay["pages"]:
        lead, pp = divmod(p, lay["n_pages"])
        rest, i2 = divmod(lead, lay["n"][2])
        i0, i1 = divmod(rest, lay["n"][1])
        off = i0 * lay["s"][0] + i1 * lay["s"][1] + i2 * lay["s"][2]
    first = pp * g
    return off + first * lay["st"], min(g - 1, lay["t"] - 1 - first)


def mirror_encode(view: torch.Tensor, group: int, man_bits: int, exp_mask: int) -> tuple:
    """What the kernel writes for ``view``, computed with the kernel's own
    addressing: its storage read as the kernel reads memory (16-byte
    vectors only at aligned addresses, asserted), the tile staged in a
    byte array at the plan's row stride, each unit's column read back and
    encoded (on the direct path each unit's row read straight from
    memory), every output written exactly once."""
    bits = 8 * view.element_size()
    w = view.element_size()
    lay = K.layout(view, group)
    plan = K.plan(lay, w, view.data_ptr())
    mem = torch.empty(0, dtype=torch.uint8).set_(view.untyped_storage()).numpy()
    origin0 = view.storage_offset() * w  # the view's first value, bytes into mem
    address0 = view.data_ptr()
    g, c = lay["g"], lay["c"]
    units = lay["pages"] * c
    out = np.zeros(units * g, HOST[bits])
    base = np.zeros(units, np.uint8)
    written = np.zeros(units, np.int64)

    def value(off):  # the value at ``off`` values past the view's start
        b = origin0 + off * w
        return int(mem[b : b + w].view(HOST[bits])[0])

    def vector(off):  # 16 bytes at ``off`` values past the start, aligned
        assert (address0 + off * w) % 16 == 0
        b = origin0 + off * w
        return mem[b : b + 16]

    def encode_unit(v, unit):
        exps = [(x >> man_bits) & exp_mask for x in v]
        lo = min(exps)
        field = exp_mask << man_bits
        out[unit * g : (unit + 1) * g] = [(x & ~field) | ((e - lo) << man_bits)
                                          for x, e in zip(v, exps)]
        base[unit] = lo
        written[unit] += 1

    tp, chunk, rb = plan["tile_pages"], plan["chunk"], plan["row_bytes"]
    assert plan["threads"] <= K.THREADS and plan["threads"] % 32 == 0
    if plan["path"] == "direct":
        assert c == 1 and lay["st"] == 1 and lay["t"] % g == 0 and plan["smem"] == 0
        for b in range(plan["blocks"]):
            for i in range(min(tp, lay["pages"] - b * tp)):
                p = b * tp + i
                off, last = _page_origin(lay, p)
                assert last == g - 1
                if g == 16:  # the row as 16-byte vectors
                    raw = np.concatenate([vector(off + k * 16 // w) for k in range(g * w // 16)])
                    v = [int(x) for x in raw.view(HOST[bits])]
                else:
                    v = [value(off + k) for k in range(g)]
                encode_unit(v, p)
        assert (written == 1).all(), "a unit was written twice or never"
        shape = (*view.shape[:-2], -(-view.shape[-2] // g), c)
        return out.reshape(*shape, g), base.reshape(shape), plan
    assert tp * chunk <= plan["threads"] and plan["smem"] <= K.MAX_TILE_BYTES
    assert rb % 16 == 0 and rb >= chunk * w
    for b in range(plan["blocks"]):
        ci = b % plan["chunks"]
        p0 = b // plan["chunks"] * tp
        npg = min(tp, lay["pages"] - p0)
        c0 = ci * chunk
        cw = min(chunk, c - c0)
        origins = [_page_origin(lay, p0 + i) for i in range(npg)]
        tile = np.zeros(tp * g * rb, np.uint8)
        rows = npg * g
        if plan["path"] == "vec":
            vr = cw * w // 16
            for i in range(rows * vr):
                r, x = divmod(i, vr)
                pl, j = divmod(r, g)
                src = origins[pl][0] + c0 + min(j, origins[pl][1]) * lay["st"]
                tile[r * rb + x * 16 : r * rb + x * 16 + 16] = vector(src + x * 16 // w)
        else:
            for i in range(rows * cw):
                r, x = divmod(i, cw)
                pl, j = divmod(r, g)
                src = origins[pl][0] + c0 + min(j, origins[pl][1]) * lay["st"] + x
                tile[r * rb + x * w : r * rb + x * w + w] = \
                    np.array([value(src)], HOST[bits]).view(np.uint8)
        for i in range(npg * cw):
            pl, x = divmod(i, cw)
            col = [tile[(pl * g + k) * rb + x * w : (pl * g + k) * rb + x * w + w]
                   for k in range(g)]
            v = [int(np.asarray(e).view(HOST[bits])[0]) for e in col]
            encode_unit(v, (p0 + pl) * c + c0 + x)
    assert (written == 1).all(), "a unit was written twice or never"
    shape = (*view.shape[:-2], -(-view.shape[-2] // g), c)
    return out.reshape(*shape, g), base.reshape(shape), plan


MIRROR_CASES = [
    # (kind, t, C, group, bits, path): the path the plan must take
    ("span", 40, 24, 16, 16, "vec"),
    ("span", 16, 192, 16, 16, "vec"),  # a decode page fill's pages
    ("reactivated", 9, 24, 16, 16, "vec"),
    ("tokens", 37, 32, 16, 8, "vec"),
    ("tokens", 21, 12, 16, 32, "vec"),
    ("pages", 32, 16, 8, 16, "vec"),
    ("tokens", 70, 24, 12, 16, "vec"),
    ("tokens", 1, 24, 16, 16, "vec"),
    ("tokens", 20, 20, 16, 16, "bytes"),  # 40-byte rows
    ("wide", 19, 16, 16, 16, "bytes"),  # start 6 bytes in
    ("offset", 18, 24, 16, 32, "bytes"),  # start 4 bytes in
    ("tokens", 17, 300, 16, 16, "bytes"),  # two channel chunks, 600-byte rows
    ("tokens", 18, 512, 16, 16, "vec"),  # two channel chunks
    ("tokens", 35, 1, 16, 16, "bytes"),  # pages of one channel: 2-byte rows
    ("tokens", 48, 1, 16, 16, "direct"),  # one channel, whole groups
    ("rows", 40, 16, 16, 16, "direct"),  # the flat (R, G) rows
    ("rows", 9, 16, 16, 8, "direct"),
    ("rows", 11, 12, 12, 32, "direct"),  # G 12: value by value, any alignment
    ("rows_offset", 10, 12, 12, 16, "direct"),
    ("rows_offset", 10, 16, 16, 16, "bytes"),  # G 16 unaligned: staged
]


@pytest.mark.parametrize("kind,t,c,group,bits,path", MIRROR_CASES)
def test_kernel_mirror_matches_plain(kind, t, c, group, bits, path):
    """The kernel's addressing, mirrored in NumPy, writes what the plain
    version computes: every page and channel, the ragged tail's repeated
    token, pages in row-major order of the leading dims, on the vector
    path and the byte path."""
    rng = np.random.default_rng(t * c + group + bits)
    view = _view(kind, rng, bits, t, c)
    man, mask = {8: (3, 0xF), 16: (7, 0xFF), 32: (23, 0xFF)}[bits]
    enc, base, plan = mirror_encode(view, group, man, mask)
    assert plan["path"] == path
    want_e, want_b = t_ref.cluster_encode_ref(view, group, man, mask)
    np.testing.assert_array_equal(enc, _host(want_e, bits))
    np.testing.assert_array_equal(base, want_b.numpy())


def test_layout_merges_and_refuses():
    """Leading dims: size-1 dims dropped, a dim that steps over the next
    merged with it, at most three kept; channels must be dense."""
    span = torch.zeros((2, 4, 48, 24), dtype=torch.int16).transpose(0, 1)
    lay = K.layout(span, 16)
    assert lay["n"] == (1, 4, 2) and lay["s"] == (0, 48 * 24, 4 * 48 * 24)
    assert (lay["t"], lay["st"], lay["c"], lay["n_pages"], lay["pages"]) == (48, 24, 24, 3, 24)
    pages = torch.zeros((3, 5, 32, 8), dtype=torch.int16)
    lay = K.layout(pages, 16)  # whole groups of dense tokens: one run of tokens
    assert (lay["n"], lay["t"], lay["st"], lay["pages"]) == ((1, 1, 1), 480, 8, 30)
    assert K.layout(pages[:, :, None], 16)["t"] == 480
    assert K.layout(pages, 12)["n"] == (1, 1, 15)  # ragged pages: none folded
    assert K.layout(pages[:, ::2], 16)["n"] == (1, 3, 3)  # a stride that skips
    rows = K.layout(torch.zeros((50, 16), dtype=torch.int16)[:, :, None], 16)
    assert (rows["n"], rows["t"], rows["st"], rows["c"], rows["pages"]) == \
        ((1, 1, 1), 800, 1, 1, 50)
    assert K.layout(torch.zeros((0, 4, 8), dtype=torch.int16), 16)["pages"] == 0
    with pytest.raises(ValueError, match="dense"):
        K.layout(torch.zeros((16, 8), dtype=torch.int16).t(), 4)
    with pytest.raises(ValueError, match="leading dims"):
        K.layout(torch.zeros((4, 4, 4, 4, 16, 8), dtype=torch.int16)[::2, ::2, ::2, ::2], 16)


def test_plan_tiles_by_channels():
    """Whole pages a tile up to 256 units; wider pages cut into chunks of
    256 channels, one page a tile; rows padded to whole vectors."""
    lay = K.layout(torch.zeros((2, 4, 512, 192), dtype=torch.int16).transpose(0, 1), 16)
    p = K.plan(lay, 2, 0)
    assert (p["tile_pages"], p["chunk"], p["blocks"], p["threads"], p["row_bytes"],
            p["smem"], p["path"]) == (1, 192, 256, 192, 384, 16 * 384, "vec")
    p = K.plan(K.layout(torch.zeros((70, 24), dtype=torch.int16), 12), 2, 0)
    assert (p["tile_pages"], p["blocks"], p["threads"], p["row_bytes"]) == (10, 1, 256, 48)
    p = K.plan(K.layout(torch.zeros((16, 1000), dtype=torch.int32), 32), 4, 0)
    assert (p["tile_pages"], p["chunks"], p["blocks"], p["smem"]) == (1, 4, 4, 32 * 1024)
    assert K.plan(lay, 2, 8)["path"] == "bytes"
    p = K.plan(K.layout(torch.zeros((1000, 16), dtype=torch.int16)[:, :, None], 16), 2, 0)
    assert (p["path"], p["tile_pages"], p["blocks"], p["threads"], p["smem"]) == \
        ("direct", 256, 4, 256, 0)
    assert K.plan(lay, 2, 0)["path"] == "vec"


@pytest.mark.parametrize("kind,t", [("span", 37), ("span", 48), ("tokens", 70),
                                    ("pages", 32), ("wide", 21)])
def test_encode_kv_on_a_view_equals_its_contiguous_copy(kind, t):
    """``encode_kv`` and ``encode_pages`` read a strided view to the same
    ``EncodedKV`` bytes (planes, bases, shape) as its contiguous copy;
    ``encode_kv`` refuses a view of 3 or more dims whose tokens are no
    whole groups (only ``encode_pages`` pads those, per leading index)."""
    rng = np.random.default_rng(t)
    view = _view(kind, rng, 16, t, 24)
    spec, cfg = T_SPECS["bf16"], TS.StoreConfig(codec="lz4")
    if view.dim() > 2 and t % 16:
        with pytest.raises(ValueError, match="no whole groups"):
            TS.encode_kv(view, spec, cfg)
    else:
        a, b = TS.encode_kv(view, spec, cfg), TS.encode_kv(view.contiguous(), spec, cfg)
        assert torch.equal(a.planes, b.planes) and torch.equal(a.bases, b.bases)
        assert a.shape == b.shape == (math.prod(view.shape[:-1]), 24)
        assert a.group == b.group == 16
    n = math.prod(view.shape[:-2]) * -(-t // 16)
    pa = TS.encode_pages(view, spec, cfg, 16)
    pb = TS.encode_pages(view.contiguous(), spec, cfg, 16)
    assert len(pa) == len(pb) == n
    for x, y in zip(pa, pb):
        assert np.array_equal(x.planes, y.planes) and np.array_equal(x.bases, y.bases)
        assert x.shape == y.shape == (16, 24)
