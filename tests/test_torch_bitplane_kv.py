"""The KV cache's bit-plane entry points (``pack_kv_into``,
``unpack_kv_pair``) and the rewritten pack/unpack kernels, on the CPU.

* The plain versions against the reference: ``pack_kv_planes`` written
  with ``.at[:, rows, clip(len)].set`` (decode) or ``dynamic_update_slice``
  (a prefill chunk), and ``unpack_kv_ref``, as
  ``src/repro/models/attention.py`` composes them; bit for bit.
* A NumPy mirror of ``csrc/bitplane.cu``: its units, addresses and register
  bit algebra (the 8 x 8 bit transpose, ``__byte_perm``'s selectors) step
  for step, against the plain versions at every container width, at ragged
  rows and on the cache views the serving path passes.  The kernel itself
  runs only on the card (``tests/test_torch_cuda.py``).
* The CPU route launches nothing, and the model calls each KV entry point
  once a layer.

Everything here moves bits: every comparison is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

from repro.kernels.paged_attention.ops import pack_kv_planes as j_pack_kv
from repro.kernels.paged_attention.ref import unpack_kv_ref as j_unpack_kv

from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ops as O
from repro_torch.kernels.bitplane import ref as R

torch.set_num_threads(1)

HEAD_DIMS = (8, 64, 112, 128)


def _bf16_bits(rng, shape):
    """Random bf16 values as (uint16 NumPy, torch bf16), NaNs included: the
    pack moves bits, not numbers."""
    u = rng.integers(0, 1 << 16, shape, dtype=np.uint32).astype(np.uint16)
    return u, torch.from_numpy(u.view(np.int16).copy()).view(torch.bfloat16)


def _j_bf16(u):
    return lax.bitcast_convert_type(jnp.asarray(u), jnp.bfloat16)


def _cache(rng, bits, b, s, hkv, hd):
    """Planes of random bits, (bits, B, S, Hkv, hd/8), as NumPy and torch."""
    p = rng.integers(0, 256, (bits, b, s, hkv, hd // 8), dtype=np.uint8)
    return p, torch.from_numpy(p.copy())


# ------------------------------------------- the plain versions vs the reference
DECODE = [(b, s, hkv, hd) for hd in HEAD_DIMS for b, s, hkv in ((1, 16, 1), (8, 48, 3))]


@pytest.mark.parametrize("b,s,hkv,hd", DECODE)
def test_decode_pack_matches_reference_scatter(b, s, hkv, hd):
    """One token a row at its own position: 0, mid, S - 1, past S (clamped
    to S - 1, as the reference clips) and negative (clamped to 0), each
    row of K and V; an idle row writes at its own position too."""
    rng = np.random.default_rng(b * 1000 + s + hkv * 10 + hd)
    kp_np, kp = _cache(rng, 16, b, s, hkv, hd)
    vp_np, vp = _cache(rng, 16, b, s, hkv, hd)
    k_np, k = _bf16_bits(rng, (b, 1, hkv, hd))
    v_np, v = _bf16_bits(rng, (b, 1, hkv, hd))
    pos = np.array([0, s // 2, s - 1, s + 5, -3, 7, s, 1][:b], np.int32)
    O.pack_kv_into(k, v, kp, vp, torch.from_numpy(pos))
    rows, slot = jnp.arange(b), jnp.clip(jnp.asarray(pos), 0, s - 1)
    for got, planes, x in ((kp, kp_np, k_np), (vp, vp_np, v_np)):
        want = jnp.asarray(planes).at[:, rows, slot].set(j_pack_kv(_j_bf16(x), 16)[:, :, 0])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


PREFILL = [(b, s, hkv, hd, start, c) for hd in HEAD_DIMS for b, s, hkv in ((1, 64, 3), (2, 32, 1))
           for start, c in ((0, 16), (16, 8), (s - 16, 16))]


@pytest.mark.parametrize("b,s,hkv,hd,start,c", PREFILL)
def test_chunk_pack_matches_reference_update_slice(b, s, hkv, hd, start, c):
    """A prefill chunk of c rows at offset 0, mid and the cache's end."""
    rng = np.random.default_rng(start * 31 + c + hd + s)
    kp_np, kp = _cache(rng, 16, b, s, hkv, hd)
    vp_np, vp = _cache(rng, 16, b, s, hkv, hd)
    k_np, k = _bf16_bits(rng, (b, c, hkv, hd))
    v_np, v = _bf16_bits(rng, (b, c, hkv, hd))
    O.pack_kv_into(k, v, kp, vp, start)
    for got, planes, x in ((kp, kp_np, k_np), (vp, vp_np, v_np)):
        want = lax.dynamic_update_slice(jnp.asarray(planes), j_pack_kv(_j_bf16(x), 16),
                                        (0, 0, start, 0, 0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunk_pack_refuses_rows_past_the_cache():
    kp = torch.zeros((16, 1, 32, 1, 8), dtype=torch.uint8)
    k = torch.zeros((1, 8, 1, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="outside the cache"):
        O.pack_kv_into(k, k, kp, kp.clone(), 30)


@pytest.mark.parametrize("keep", [16, 12, 8, 4, 1])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_unpack_pair_matches_reference(hd, keep):
    rng = np.random.default_rng(hd * 100 + keep)
    kp_np, kp = _cache(rng, 16, 2, 32, 3, hd)
    vp_np, vp = _cache(rng, 16, 2, 32, 3, hd)
    got = O.unpack_kv_pair(kp, vp, keep)
    assert got.shape == (2, 2, 32, 3, hd) and got.dtype == torch.bfloat16
    for i, planes in enumerate((kp_np, vp_np)):
        want = np.asarray(lax.bitcast_convert_type(j_unpack_kv(jnp.asarray(planes), keep, 16),
                                                   jnp.uint16))
        np.testing.assert_array_equal(got[i].view(torch.int16).numpy().view(np.uint16), want)


def test_unpack_pair_at_keep_0_is_zero():
    rng = np.random.default_rng(0)
    _, kp = _cache(rng, 16, 2, 16, 3, 64)
    got = O.unpack_kv_pair(kp, kp.clone(), 0)
    assert got.shape == (2, 2, 16, 3, 64) and not got.view(torch.int16).any()


def test_unpack_pair_reads_the_slot_view_of_the_stacked_cache():
    """The memory tier's read: (layers, bits, B, S, Hkv, hd/8) sliced at one
    slot and a token range, planes moved first (strides, no copy) equal the
    stacked planes unpacked, as ``slot_kv_bits`` did before."""
    rng = np.random.default_rng(5)
    cache = {n: torch.from_numpy(rng.integers(0, 256, (4, 16, 3, 64, 3, 8), dtype=np.uint8))
             for n in ("k_planes", "v_planes")}
    kp, vp = (cache[n][1:3, :, 2, 16:40].movedim(1, 0) for n in ("k_planes", "v_planes"))
    got = O.unpack_kv_pair(kp, vp, 16)
    stacked = torch.stack([cache[n][1:3, :, 2, 16:40] for n in ("k_planes", "v_planes")])
    want = R.unpack_kv_ref(stacked.movedim(2, 0), 16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_cpu_route_launches_nothing():
    K.reset_launches()
    rng = np.random.default_rng(1)
    _, kp = _cache(rng, 16, 2, 16, 1, 8)
    vp = kp.clone()
    k = torch.zeros((2, 1, 1, 8), dtype=torch.bfloat16)
    O.pack_kv_into(k, k, kp, vp, torch.tensor([3, 20], dtype=torch.int32))
    O.pack_kv_into(torch.zeros((2, 4, 1, 8), dtype=torch.bfloat16), k.expand(2, 4, 1, 8),
                   kp, vp, 4)
    O.unpack_kv_pair(kp, vp, 12)
    O.unpack_raw(O.pack_raw(torch.zeros(64, dtype=torch.int16), 16), 16, 8, torch.int16)
    assert K.LAUNCHES == {"bitplane_pack": 0, "bitplane_unpack": 0}


# ----------------------------------------------- the plane rows of the cache views
def test_plane_rows_of_the_serving_views():
    """The per-layer view of the stacked cache, one slot of it (a prefill
    chunk's narrow) and the memory tier's layer-slice view: strides read
    from the tensors, in bytes."""
    cache = torch.zeros((5, 16, 8, 64, 3, 8), dtype=torch.uint8)
    r8 = 24
    layer = plane_rows_of(cache[2])
    assert layer == {"planes": 16, "n_a": 8, "n_b": 64, "r8": r8, "ps": 8 * 64 * r8,
                     "sa": 64 * r8, "sb": r8}
    slot = plane_rows_of(cache.narrow(2, 3, 1)[2])
    assert slot == {**layer, "n_a": 1}
    tier = plane_rows_of(cache[1:4, :, 6, 10:30].movedim(1, 0))
    assert tier == {"planes": 16, "n_a": 3, "n_b": 20, "r8": r8, "ps": 8 * 64 * r8,
                    "sa": 16 * 8 * 64 * r8, "sb": r8}


def plane_rows_of(t):
    return K.plane_rows(t, t)


def test_plane_rows_refuse_what_the_kernels_do_not_take():
    cache = torch.zeros((16, 2, 8, 3, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="must be dense"):
        K.plane_rows(cache.transpose(3, 4), cache.transpose(3, 4))
    with pytest.raises(ValueError, match="differ"):
        K.plane_rows(cache, cache[:, :, :4])
    with pytest.raises(ValueError, match="differ"):
        K.plane_rows(cache, cache.contiguous().narrow(1, 0, 1).expand(cache.shape))
    with pytest.raises(TypeError, match="uint8"):
        K.plane_rows(cache.to(torch.int16), cache.to(torch.int16))


# ----------------------------------------------------- the NumPy mirror of the kernel
M32 = np.uint64(0xFFFFFFFF)


def byte_perm(x, y, s):
    """``__byte_perm``: byte n of the result is byte (s >> 4n) & 7 of
    (x, y), x bytes 0-3, y bytes 4-7."""
    src = [(x >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    src += [(y >> np.uint32(8 * k)) & np.uint32(0xFF) for k in range(4)]
    out = np.zeros_like(x)
    for n in range(4):
        out |= src[(s >> (4 * n)) & 7] << np.uint32(8 * n)
    return out


def join(lo, hi):
    return (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)


def halves(x):
    return (x & M32).astype(np.uint32), (x >> np.uint64(32)).astype(np.uint32)


def transpose8(x):
    for shift, mask in ((7, 0x00AA00AA00AA00AA), (14, 0x0000CCCC0000CCCC),
                        (28, 0x00000000F0F0F0F0)):
        sh, m = np.uint64(shift), np.uint64(mask)
        t = (x ^ (x >> sh)) & m
        x = x ^ t ^ (t << sh)
    return x


def transpose4(a):
    t0, t1 = byte_perm(a[0], a[1], 0x5140), byte_perm(a[0], a[1], 0x7362)
    t2, t3 = byte_perm(a[2], a[3], 0x5140), byte_perm(a[2], a[3], 0x7362)
    return [byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632)]


def rows_of(w, width, j):
    zero = np.zeros_like(w[0])
    if width == 1:
        return join(byte_perm(w[1], zero, 0x0123), byte_perm(w[0], zero, 0x0123))
    if width == 2:
        sel = 0x1357 if j else 0x0246
        return join(byte_perm(w[2], w[3], sel), byte_perm(w[0], w[1], sel))
    sel = (4 + j) | (j << 4)
    return join(byte_perm(byte_perm(w[6], w[7], sel), byte_perm(w[4], w[5], sel), 0x5410),
                byte_perm(byte_perm(w[2], w[3], sel), byte_perm(w[0], w[1], sel), 0x5410))


def from_rows(x, width):
    if width == 1:
        lo, hi = halves(x[0])
        zero = np.zeros_like(lo)
        return [byte_perm(hi, zero, 0x0123), byte_perm(lo, zero, 0x0123)]
    if width == 2:
        (l0, h0), (l1, h1) = halves(x[0]), halves(x[1])
        return [byte_perm(h0, h1, 0x6273), byte_perm(h0, h1, 0x4051),
                byte_perm(l0, l1, 0x6273), byte_perm(l0, l1, 0x4051)]
    w = []
    for v in range(8):
        half = [halves(xi)[1 if v < 4 else 0] for xi in x]
        p = 3 - v if v < 4 else 7 - v
        sel = p | ((4 + p) << 4)
        w.append(byte_perm(byte_perm(half[0], half[1], sel),
                           byte_perm(half[2], half[3], sel), 0x5410))
    return w


def units(streams, n_a, n_b, r8):
    """Every unit's (stream, row, a, b, quad, octets), as the kernel's
    ``locate`` computes them from its index."""
    quads = -(-r8 // 4)
    per_stream = n_a * n_b * quads
    u = np.arange(streams * per_stream)
    stream = u // per_stream
    rem = u - stream * per_stream
    row = rem // quads
    quad = rem - row * quads
    a = row // n_b
    return stream, row, a, row - a * n_b, quad, np.minimum(4, r8 - 4 * quad)


def mirror_pack(vals, mem, base, rows, width, bits, start=None, start0=0, s_max=0):
    """The pack kernel over value bytes ``vals`` (streams, n_a * n_b * r8 *
    8 * width) into the byte memory ``mem`` at offsets ``base`` (per
    stream), with the rows' strides."""
    stream, row, a, b, quad, octets = units(len(base), rows["n_a"], rows["n_b"], rows["r8"])
    pos = b + (np.clip(start[a], 0, s_max) if start is not None else start0)
    dst = np.asarray(base)[stream] + a * rows["sa"] + pos * rows["sb"] + 4 * quad
    w = []
    for o in range(4):
        off = (row * rows["r8"] + 4 * quad + o) * 8 * width
        live = o < octets
        octet = [np.zeros(len(off), np.uint32) for _ in range(2 * width)]
        for k in range(2 * width):
            idx = off[live] + 4 * k
            got = np.zeros(live.sum(), np.uint32)
            for byte in range(4):
                got |= vals[stream[live], idx + byte].astype(np.uint32) << np.uint32(8 * byte)
            octet[k][live] = got
        w.append(octet)
    pw = [None] * (8 * width)
    for j in range(width):
        t = [halves(transpose8(rows_of(w[o], width, j))) for o in range(4)]
        pw[8 * j:8 * j + 4] = transpose4([t[o][0] for o in range(4)])
        pw[8 * j + 4:8 * j + 8] = transpose4([t[o][1] for o in range(4)])
    for q in range(min(bits, 8 * width)):
        p = dst + (bits - 1 - q) * rows["ps"]
        for o in range(4):
            live = o < octets
            byte = (pw[q][live] >> np.uint32(8 * o)) & np.uint32(0xFF)
            mem[p[live] + o] = byte.astype(np.uint8)


def mirror_unpack(mem, base, rows, width, bits, keep):
    """The unpack kernel: planes [0, keep) from ``mem`` at ``base`` (per
    stream) -> value bytes (streams, rows * r8 * 8 * width)."""
    streams = len(base)
    stream, row, a, b, quad, octets = units(streams, rows["n_a"], rows["n_b"], rows["r8"])
    src = np.asarray(base)[stream] + a * rows["sa"] + b * rows["sb"] + 4 * quad
    pw = []
    for q in range(8 * width):
        plane = bits - 1 - q
        v = np.zeros(len(src), np.uint32)
        if q < bits and plane < keep:
            for o in range(4):
                live = o < octets
                v[live] |= mem[src[live] + plane * rows["ps"] + o].astype(np.uint32) \
                    << np.uint32(8 * o)
        pw.append(v)
    out = np.zeros((streams, rows["n_a"] * rows["n_b"] * rows["r8"] * 8 * width), np.uint8)
    xs = [[None] * width for _ in range(4)]
    for j in range(width):
        lo, hi = transpose4(pw[8 * j:8 * j + 4]), transpose4(pw[8 * j + 4:8 * j + 8])
        for o in range(4):
            xs[o][j] = transpose8(join(lo[o], hi[o]))
    for o in range(4):
        live = o < octets
        off = (row * rows["r8"] + 4 * quad + o) * 8 * width
        for k, word in enumerate(from_rows(xs[o], width)):
            for byte in range(4):
                out[stream[live], off[live] + 4 * k + byte] = \
                    ((word[live] >> np.uint32(8 * byte)) & np.uint32(0xFF)).astype(np.uint8)
    return out


UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}
FLAT = [(width, bits, m) for width, bits_set in ((1, (8, 4)), (2, (16, 12)), (4, (32, 23)))
        for bits in bits_set for m in (8, 8 * 5, 8 * 32, 8 * 37)]


@pytest.mark.parametrize("width,bits,m", FLAT)
def test_mirror_of_the_flat_kernels_matches_plain(width, bits, m):
    """One stream of one row of m/8 plane bytes: m = 8 (one partial word),
    m/8 = 5 and 37 (a ragged last word), 32 (whole words)."""
    rng = np.random.default_rng(width * 1000 + bits * 10 + m)
    raw = rng.integers(0, 1 << bits, m, dtype=np.uint64).astype(UNSIGNED[width])
    u = torch.from_numpy(raw.copy()).view(K.CONTAINERS[width])
    want = R.pack_ref(u, bits).numpy()
    m8 = m // 8
    rows = {"n_a": 1, "n_b": 1, "r8": m8, "ps": m8, "sa": 0, "sb": 0}
    mem = np.zeros(bits * m8, np.uint8)
    mirror_pack(raw.view(np.uint8)[None], mem, [0], rows, width, bits)
    np.testing.assert_array_equal(mem.reshape(bits, m8), want)
    for keep in sorted({bits, bits - 3, bits // 2, 1, 0}):
        back = mirror_unpack(mem, [0], rows, width, bits, keep)[0].view(UNSIGNED[width])
        plain = R.unpack_ref(torch.from_numpy(want), bits, keep, K.CONTAINERS[width])
        np.testing.assert_array_equal(back, plain.numpy().view(UNSIGNED[width]))
    np.testing.assert_array_equal(mirror_unpack(mem, [0], rows, width, bits, bits)[0]
                                  .view(UNSIGNED[width]), raw)


KV = [(b, s, hkv, hd) for hd in HEAD_DIMS for b, s, hkv in ((3, 20, 1), (2, 16, 3))]


def _stacked(rng, layers, b, s, hkv, hd):
    return torch.from_numpy(rng.integers(0, 256, (layers, 16, b, s, hkv, hd // 8),
                                         dtype=np.uint8))


@pytest.mark.parametrize("b,s,hkv,hd", KV)
def test_mirror_of_the_kv_kernels_matches_plain_on_cache_views(b, s, hkv, hd):
    """K and V in one launch on the views the serving path passes: a
    layer's decode append at clamped, idle and in-range positions; a
    prefill chunk into one slot (the narrowed view); the memory tier's
    layer-slice unpack and the prefill's whole-slot unpack at several keeps."""
    rng = np.random.default_rng(b * 100 + s + hkv * 7 + hd)
    caches = [_stacked(rng, 3, b, s, hkv, hd) for _ in range(2)]
    mem = np.concatenate([c.numpy().reshape(-1) for c in caches])
    base = [0, caches[0].numel()]

    def run_pack(views, vals, **kw):
        # the values' rows: (A, c) of the planes' (A, S)
        rows = {**K.plane_rows(*views), "n_a": vals[0].shape[0], "n_b": vals[0].shape[1]}
        n = vals[0].numel()
        raw = np.stack([x.contiguous().view(torch.int16).numpy().view(np.uint8)
                        .reshape(-1) for x in vals])
        assert raw.shape == (2, n * 2)
        offs = [base[i] + views[i].storage_offset() for i in range(2)]
        mirror_pack(raw, mem, offs, rows, 2, 16, **kw)

    # decode into layer 1: positions 0, S - 1, past S and negative
    k = [_bf16_bits(rng, (b, 1, hkv, hd))[1] for _ in range(2)]
    pos = np.array([s + 9, 0, -2][:b], np.int32)
    views = [c[1] for c in caches]
    run_pack(views, k, start=pos, s_max=s - 1)
    R.pack_kv_into_ref(*k, *views, torch.from_numpy(pos))
    # a chunk of 4 rows at offset 5 into slot b - 1 of layer 2
    c4 = [_bf16_bits(rng, (1, 4, hkv, hd))[1] for _ in range(2)]
    views = [c.narrow(2, b - 1, 1)[2] for c in caches]
    run_pack(views, c4, start0=5)
    R.pack_kv_into_ref(*c4, *views, 5)
    np.testing.assert_array_equal(mem, np.concatenate([c.numpy().reshape(-1) for c in caches]))
    for keep in (16, 9, 4, 0):
        for views in ([c[0] for c in caches],
                      [c[0:3, :, b - 1, 2:s - 1].movedim(1, 0) for c in caches]):
            rows = K.plane_rows(*views)
            offs = [base[i] + views[i].storage_offset() for i in range(2)]
            got = mirror_unpack(mem, offs, rows, 2, 16, keep)
            want = R.unpack_kv_pair_ref(*views, keep)
            np.testing.assert_array_equal(got.view(np.int16).reshape(want.shape),
                                          want.view(torch.int16).numpy())


def test_transpose8_moves_bit_8r_plus_c_to_8c_plus_r():
    rng = np.random.default_rng(8)
    x = rng.integers(0, 1 << 63, 64, dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    got = transpose8(x)
    for r in range(8):
        for c in range(8):
            src = (x >> np.uint64(8 * r + c)) & np.uint64(1)
            assert np.array_equal((got >> np.uint64(8 * c + r)) & np.uint64(1), src)
    assert np.array_equal(transpose8(got), x)


# ------------------------------------------------------------------ the model's calls
@pytest.fixture(scope="module")
def small_model():
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _counting(monkeypatch):
    """Count calls of the KV entry points and of the flat pack/unpack the
    attention layer made before them."""
    from repro_torch.kernels.paged_attention import ops as PO
    from repro_torch.models import attention as A

    calls = {"pack_kv_into": 0, "unpack_kv_pair": 0, "flat": 0}

    def wrap(mod, name, key):
        fn = getattr(mod, name)

        def counted(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)
        monkeypatch.setattr(mod, name, counted)

    wrap(A.bitplane_ops, "pack_kv_into", "pack_kv_into")
    wrap(A.bitplane_ops, "unpack_kv_pair", "unpack_kv_pair")
    for name in ("pack_raw", "unpack_raw"):
        wrap(A.bitplane_ops, name, "flat")
    for name in ("pack_kv_planes", "unpack_kv"):
        wrap(PO, name, "flat")
    return calls


def test_model_packs_and_unpacks_once_a_layer(small_model, monkeypatch):
    """A prefill chunk unpacks K and V once a layer and packs them once a
    layer; a decode step packs once a layer and unpacks nothing; neither
    reaches the flat entry points.  On the card each call is one launch."""
    from repro_torch.models.transformer import bitplane_cache_from_dense

    model, params = small_model
    n = model.cfg.n_layers
    b, s = 2, 64
    cache = bitplane_cache_from_dense(model.init_cache(b, s, device="cpu"))
    calls = _counting(monkeypatch)
    tokens = torch.arange(16)[None] % model.cfg.vocab
    model.prefill_chunk(params, tokens, cache, 0, 0, 15)
    assert calls == {"pack_kv_into": n, "unpack_kv_pair": n, "flat": 0}
    for key in calls:
        calls[key] = 0
    cache["len"] = torch.tensor([16, 3], dtype=torch.int32)
    model.decode(params, torch.tensor([1, 2]), cache)
    assert calls == {"pack_kv_into": n, "unpack_kv_pair": 0, "flat": 0}
