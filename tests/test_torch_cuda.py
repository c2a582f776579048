"""The port's bit-plane, exponent-delta, SSD and flash-attention CUDA
kernels against their plain PyTorch versions on the card.  Every test here needs an NVIDIA GPU and ``nvcc``, carries
the ``cuda`` marker and skips without a GPU.  The file imports no JAX, so
it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: pack and unpack move bits and must match bit for bit.  The
matmul takes exact bf16 x bf16 products in float32 on both sides; the
kernel sums them on the tensor cores, 16 rows of K at a time within each
split of K and then the splits in order, the plain version through cuBLAS
in an order of its own, so it is held to atol = rtol = 1e-4.  The SSD scan is
float32 on both sides: the kernel takes its products on the tensor cores
as 3xTF32 (each operand split into a TF32 high part and its remainder,
the remainder times remainder term dropped, about 2^-20 of a product) and
sums in another order: it is held to 1e-4 of the largest output (about
1e-5 measured at full width).  Flash
attention rounds p to bf16 at the running max of its 128-key tiles (within
a split of the keys, whose partials a second kernel merges), the plain
version at that of its 512-key chunks, and the float32 sums run in another
order, which can flip a rounding of p or of the output: it is held to two
bf16 steps at the largest magnitude of each output row (batch row, query,
head), since a causal row's output shrinks with its depth.  The
exponent-delta encode and decode are integer transforms and, like the KV
store's blobs and decoded pages, must match bit for bit.
"""

import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ref as R
from repro_torch.kernels.bitplane_matmul import kernel as MK
from repro_torch.kernels.bitplane_matmul import ops as MM
from repro_torch.kernels.bitplane_matmul import ref as MR
from repro_torch.kernels.exp_delta import kernel as EK
from repro_torch.kernels.exp_delta import ref as ER
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.flash_attention import ref as FR
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd import ref as SR

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402

MATMUL_TOL = 1e-4
SSD_REL_TOL = 1e-4
FLASH_BF16_STEPS = 2


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc to build the kernels)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [16, 8])
@pytest.mark.parametrize("m", [1536, 196608, 8 * 12345])
def test_cuda_pack_unpack_match_plain_on_card(m, bits):
    """Bit-exact: the decode token rows (B=8), one slot's full cache per
    layer (S=1024, Hkv=3, hd=64), and an m that is no multiple of 32768."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m + bits)
    dtype = K.CONTAINERS[bits // 8]
    u = torch.randint(0, 1 << bits, (m,), generator=gen, device=dev,
                      dtype=torch.int32).to(dtype)
    planes = K.pack(u, bits)
    assert torch.equal(planes, R.pack_ref(u, bits))
    for keep in sorted({bits, 12, 8, 4} & set(range(1, bits + 1)), reverse=True):
        got = K.unpack(planes[:keep].contiguous(), bits, keep, dtype)
        assert torch.equal(got, R.unpack_ref(planes, bits, keep, dtype))
    assert torch.equal(K.unpack(planes, bits, bits, dtype), u)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("width,bits", [(1, 8), (1, 4), (2, 16), (2, 12), (4, 32), (4, 23)])
@pytest.mark.parametrize("m", [8, 8 * 37, 1536, 8 * 12345, 786432])
def test_cuda_flat_kernels_match_plain_at_every_width(width, bits, m):
    """Bit-exact at 1-, 2- and 4-byte containers: one octet, m/8 = 37 and
    12345 (a ragged last plane word, plane rows not 4-byte aligned), the
    decode token rows and the memory tier's span; values at an odd offset
    (copied to an aligned block) and planes read from a larger stack."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m + 7 * bits)
    dtype = K.CONTAINERS[width]
    u = torch.randint(0, 1 << bits, (m + 1,), generator=gen, device=dev,
                      dtype=torch.int64).to(dtype)[1:]
    planes = K.pack(u, bits)
    assert torch.equal(planes, R.pack_ref(u, bits))
    stack = torch.cat([planes, planes[:2]])
    for keep in sorted({bits, bits - 1, 8, 4, 1, 0} & set(range(bits + 1))):
        want = R.unpack_ref(planes, bits, keep, dtype)
        assert torch.equal(K.unpack(planes[:keep].contiguous(), bits, keep, dtype), want)
        assert torch.equal(K.unpack(stack, bits, keep, dtype), want)
    torch.cuda.synchronize()


KV_SHAPES = [(8, 1024, 3, 64), (4, 64, 1, 8), (2, 64, 1, 112), (2, 48, 2, 112), (2, 32, 4, 128)]


def _kv_cache(dev, gen, b, s, hkv, hd, layers=2):
    return [torch.randint(0, 256, (layers, 16, b, s, hkv, hd // 8), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.uint8) for _ in range(2)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,hd", KV_SHAPES)
def test_cuda_pack_kv_into_matches_plain(b, s, hkv, hd):
    """K and V in one launch, bit for bit against the plain version: the
    decode append at 0, mid, S - 1, past S and negative (clamped), idle
    rows at their own position; prefill chunks into one slot at offset 0,
    mid and the end.  Rows of Hkv * hd / 8 = 1 and 14 bytes take the byte
    path (plane rows not 4-byte aligned)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(b * s + hkv + hd)
    caches = _kv_cache(dev, gen, b, s, hkv, hd)
    plain = [c.clone() for c in caches]

    def rows(a, c):
        return [torch.randn((a, c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
                for _ in range(2)]

    pos = torch.tensor([0, s // 2, s - 1, s + 3, -1, 5, 2, 1][:b], device=dev,
                       dtype=torch.int32)
    K.reset_launches()
    k, v = rows(b, 1)
    K.pack_kv_into(k, v, caches[0][1], caches[1][1], pos)
    R.pack_kv_into_ref(k, v, plain[0][1], plain[1][1], pos)
    c = min(s // 4, 256)
    for start in (0, s // 2 - 3, s - c):
        k, v = rows(1, c)
        K.pack_kv_into(k, v, *(t.narrow(2, b - 1, 1)[0] for t in caches), start)
        R.pack_kv_into_ref(k, v, *(t.narrow(2, b - 1, 1)[0] for t in plain), start)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": 4, "bitplane_unpack": 0}
    for got, want in zip(caches, plain):
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hkv,hd", KV_SHAPES)
def test_cuda_unpack_kv_pair_matches_plain(b, s, hkv, hd):
    """Both streams in one launch from planes [0, keep), keep 16, 12, 8, 4
    and 0: a layer's whole cache, one slot of it (a prefill chunk's read)
    and a layer range of one slot (the memory tier's read)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(b * s * hkv + hd)
    caches = _kv_cache(dev, gen, b, s, hkv, hd)
    views = (lambda c: c[1], lambda c: c.narrow(2, b - 1, 1)[0],
             lambda c: c[:, :, b // 2, 3:s - 5].movedim(1, 0))
    K.reset_launches()
    for keep in (16, 12, 8, 4, 0):
        for view in views:
            kp, vp = (view(c) for c in caches)
            got = K.unpack_kv_pair(kp, vp, keep)
            want = R.unpack_kv_pair_ref(kp, vp, keep)
            assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": 0, "bitplane_unpack": 15}


@pytest.mark.cuda
def test_cuda_model_packs_and_unpacks_once_a_layer():
    """A prefill chunk launches one unpack and one pack a layer, a decode
    step one pack a layer and no unpack."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import bitplane_cache_from_dense

    dev = _cuda()
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cache = bitplane_cache_from_dense(model.init_cache(2, 64, device=dev))
    tokens = (torch.arange(16, device=dev)[None] * 5) % cfg.vocab
    K.reset_launches()
    model.prefill_chunk(params, tokens, cache, 1, 0, 15)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": cfg.n_layers, "bitplane_unpack": cfg.n_layers}
    K.reset_launches()
    cache["len"] = torch.tensor([3, 16], dtype=torch.int32, device=dev)
    model.decode(params, torch.tensor([1, 2], device=dev), cache)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": cfg.n_layers, "bitplane_unpack": 0}


@pytest.mark.cuda
def test_cuda_launch_floor_probe_runs_uncounted():
    _cuda()
    K.reset_launches()
    K.launch_empty()
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": 0, "bitplane_unpack": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 576, 576), (128, 576, 192), (8, 576, 1536),
                                   (128, 1536, 576), (8, 1024, 1024), (5, 100, 24),
                                   (8, 3584, 14336), (128, 3584, 14336), (64, 1024, 1024),
                                   (16, 1024, 1024), (8, 1000, 1024), (200, 520, 1032)])
def test_cuda_bitplane_matmul_matches_plain_on_card(m, k, n):
    """Full-width SmolLM-135M projections, the quickstart's shape, the
    Zamba2-7B MLP up-projection at M 8 and 128, M 64 and 16 (x slabs of 64
    and 16 rows), K that the split does not divide (1000, 520), and ragged
    ones (M, K, N not multiples of the kernel's tiles; N % 128 != 0 or
    K % 8 != 0 take the plain loads); every keep from 16 down to 1 and 0."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    planes = MM.pack_weights(w)
    for keep in (16, 12, 8, 4, 1, 0):
        got = MK.bitplane_matmul(x, planes, keep=keep)
        torch.testing.assert_close(got, MR.bitplane_matmul_ref(x, planes, keep),
                                   atol=MATMUL_TOL, rtol=MATMUL_TOL)
    torch.cuda.synchronize()


def _ssd_draw(dev, gen, b, l, h, p, n, g, h0=True):
    """dt in [1e-3, 1e-1], A in [-16, -1] as ``ssm_params`` draws them; b
    and c per group."""
    a = -(torch.rand((h,), generator=gen, device=dev) * 15 + 1)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 1e-3
    xdt = torch.randn((b, l, h, p), generator=gen, device=dev) * dt[..., None]
    bg = torch.randn((b, l, g, n), generator=gen, device=dev)
    cg = torch.randn((b, l, g, n), generator=gen, device=dev)
    state = torch.randn((b, h, n, p), generator=gen, device=dev) if h0 else None
    return xdt, dt * a, bg, cg, state


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n,chunk,h0", [
    (4, 1024, 64, 64, 128, 256, True),   # Mamba2-1.3B prefill
    (4, 1000, 64, 64, 128, 256, True),   # ragged L
    (4, 37, 64, 64, 128, 256, False),    # below one chunk
    (2, 45, 4, 32, 16, 32, True),        # the smoke config
    (1, 300, 3, 8, 4, 100, True),        # a chunk that is no multiple of 64
])
def test_cuda_ssd_matches_plain_on_card(b, l, h, p, n, chunk, h0):
    """dt in [1e-3, 1e-1] and A in [-16, -1], as ``ssm_params`` draws them:
    a chunk's cumsum reaches some -400, so an exponent of the masked half
    would overflow."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(l * h + n)
    case = _ssd_draw(dev, gen, b, l, h, p, n, h, h0)  # one group a head
    SK.reset_launches()
    y, hf = SO.ssd(*case, chunk=chunk)
    assert SK.LAUNCHES["ssd"] == 1
    y_r, hf_r = SR.ssd_ref(*case, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    assert (y - y_r).abs().max() <= SSD_REL_TOL * y_r.abs().max()
    assert (hf - hf_r).abs().max() <= SSD_REL_TOL * hf_r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("b,l,h,p,n,g,chunk", [
    (4, 1024, 64, 64, 128, 1, 256),   # Mamba2-1.3B prefill, b and c per group
    (2, 1024, 112, 64, 64, 2, 256),   # Zamba2-7B widths, two groups
    (1, 300, 6, 8, 4, 3, 100),        # three groups of two heads, chunk 100
    (2, 512, 4, 128, 64, 2, 256),     # P 128, the widest the kernel takes
])
@pytest.mark.parametrize("bc", ["float32", "bf16-valued", "c bf16-valued"])
def test_cuda_ssd_grouped_matches_plain_on_card(b, l, h, p, n, g, chunk, bc):
    """b and c per group, as the model passes them: the kernel reads head
    h's group h // (H / G); the plain version expands them to heads.  b and
    c drawn in float32 (every product 3xTF32), rounded to bf16 values as
    the model's are (the scores one TF32 product, c.state two), and c alone
    rounded (c.state two products, the scores three)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(l * h + n + g)
    xdt, da, bg, cg, h0 = _ssd_draw(dev, gen, b, l, h, p, n, g)
    if bc != "float32":
        cg = cg.bfloat16().float()
    if bc == "bf16-valued":
        bg = bg.bfloat16().float()
    case = (xdt, da, bg, cg, h0)
    SK.reset_launches()
    y, hf = SO.ssd(*case, chunk=chunk)
    assert SK.LAUNCHES["ssd"] == 1
    y_r, hf_r = SR.ssd_ref(*case, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    assert (y - y_r).abs().max() <= SSD_REL_TOL * y_r.abs().max()
    assert (hf - hf_r).abs().max() <= SSD_REL_TOL * hf_r.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("n,p,q", [(128, 64, 256), (64, 64, 256)])
def test_cuda_ssd_shared_memory_fits_two_blocks_an_sm(n, p, q):
    """At both models' prefill widths two blocks of the chunk-state kernel
    and two of the output kernel fit an SM's shared memory, as the source
    sizes them."""
    _cuda()
    for which in (0, 1):
        assert 2 * SK._library().ssd_smem_bytes(which, n, p, q) <= SK.MAX_SMEM_BYTES


@pytest.mark.cuda
def test_cuda_mamba_prefill_runs_the_kernel_once_per_layer():
    """The smoke Mamba2 on the card: prefill launches the SSD kernel once
    per layer, the serve steps never; the default device is CUDA."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    _cuda()
    model = build_model(get_config("mamba2-1.3b", smoke=True))
    params = model.init()
    assert params["embed"]["table"].device.type == "cuda"
    tokens = torch.randint(0, 512, (2, 70), device="cuda", dtype=torch.int32)
    SK.reset_launches()
    tok, cache = make_prefill_step(model)(params, {"tokens": tokens})
    assert SK.LAUNCHES["ssd"] == model.cfg.n_layers
    SK.reset_launches()
    serve = make_serve_step(model)
    for _ in range(4):
        tok, cache = serve(params, tok, cache)
    torch.cuda.synchronize()
    assert SK.LAUNCHES["ssd"] == 0
    assert tok.dtype == torch.int32 and int(cache["len"]) == 74


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hp,hkv,hd,start,valid,causal,window", [
    (2, 4096, 4096, 32, 32, 112, 0, 4096, True, 0),   # Zamba2-7B prefill
    (1, 64, 1024, 9, 3, 64, 0, 64, True, 0),          # SmolLM chunks: first,
    (1, 512, 1024, 9, 3, 64, 448, 960, True, 0),      # ... at an offset,
    (1, 1, 1024, 9, 3, 64, 1000, 1001, True, 0),      # ... one row
    (1, 64, 1024, 9, 3, 64, 960, 1024, True, 0),      # ... the last,
    (1, 64, 4096, 9, 3, 64, 4032, 4096, True, 0),     # ... over a long cache: keys split
    (1, 64, 4096, 9, 3, 64, 2000, 2064, True, 0),     # ... mid-cache: keys split below valid
    (2, 1000, 1000, 8, 2, 64, 0, 1000, True, 0),      # ragged L
    (1, 256, 256, 4, 4, 128, 0, 256, True, 64),       # sliding window,
    (2, 1024, 1024, 32, 32, 112, 0, 1024, True, 64),  # ... at hd 112 (Zamba2's heads),
    (1, 300, 700, 9, 3, 64, 400, 700, True, 200),     # ... GQA at an offset
    (2, 64, 192, 6, 3, 32, 0, 150, False, 0),         # bidirectional, valid < Skv
    (3, 40, 40, 4, 4, 16, 0, 40, True, 0),            # the smoke config
    (2, 300, 1000, 32, 4, 128, 500, (800, 1000), True, 0),  # Yi-9B heads: rep 8
    (2, 600, 1500, 32, 32, 112, 700, (1300, 901), True, 0),  # hd 112, ragged valid
    (1, 96, 2048, 32, 32, 112, 1952, 2048, True, 0),  # hd 112, keys split
    (2, 130, 130, 6, 2, 48, 0, 130, True, 0),         # hd 48, a slab zero past 48
    (1, 200, 333, 4, 1, 80, 0, (333,), False, 0),     # hd 80, rep 4, bidirectional
    (2, 257, 257, 8, 8, 96, 0, 257, True, 100),       # hd 96, window
])
def test_cuda_flash_attention_matches_plain_on_card(b, sq, skv, hp, hkv, hd, start,
                                                    valid, causal, window):
    """Every head dim of HEAD_DIMS, GQA packing (rep 1, 3, 4, 8), ragged
    per-row kv_valid, launches whose keys are split and merged, and one
    launch a call."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq * hp + hd)
    q = torch.randn((b, sq, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq)
    if isinstance(valid, tuple):
        valid = torch.tensor(valid, dtype=torch.int32, device=dev).expand(b).contiguous()
    FK.reset_launches()
    got = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=valid, causal=causal,
                             window=window)
    assert FK.LAUNCHES["flash_attention"] == 1
    want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=valid, causal=causal,
                                  window=window)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    rmax = want.float().abs().amax(-1, keepdim=True).clamp(min=1e-30)
    step = torch.exp2(torch.floor(torch.log2(rmax)) - 7)
    assert ((got.float() - want.float()).abs() <= FLASH_BF16_STEPS * step).all()


@pytest.mark.cuda
def test_cuda_flash_attention_split_repeats_bit_for_bit():
    """A call whose keys are split merges the splits in a fixed order: two
    calls on the same inputs give the same bits."""
    dev = _cuda()
    assert FK.plan(1, 64, 4096, 9, 3, 64)["splits"] > 1
    gen = torch.Generator(device=dev).manual_seed(5)
    q = torch.randn((1, 64, 9, 64), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 4096, 3, 64), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, 4096, 3, 64), generator=gen, device=dev).to(torch.bfloat16)
    pos = (4032 + torch.arange(64, device=dev, dtype=torch.int32))[None]
    a = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=4096)
    b = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=4096)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_flash_attention_last_split_runs_past_a_low_bound():
    """A host bound on kv_valid below the real kv_valid plans splits over
    the keys below the bound only; the last split runs on to the end of the
    keys, so the result still matches the plain version."""
    dev = _cuda()
    pl = FK.plan(1, 64, 4096, 9, 3, 64, valid=1024)
    assert pl["splits"] > 1 and pl["splits"] * pl["tiles_per_split"] < 4096 // FK.KEYS
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((1, 64, 9, 64), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, 4096, 3, 64), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, 4096, 3, 64), generator=gen, device=dev).to(torch.bfloat16)
    pos = (4032 + torch.arange(64, device=dev, dtype=torch.int32))[None].contiguous()
    kv_valid = torch.full((1,), 4096, dtype=torch.int32, device=dev)
    got = FK.flash_attention(q, k, v, pos, kv_valid, causal=True, window=0, valid=1024)
    want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=4096)
    torch.cuda.synchronize()
    rmax = want.float().abs().amax(-1, keepdim=True).clamp(min=1e-30)
    step = torch.exp2(torch.floor(torch.log2(rmax)) - 7)
    assert ((got.float() - want.float()).abs() <= FLASH_BF16_STEPS * step).all()


@pytest.mark.cuda
def test_cuda_zamba2_prefill_runs_flash_once_per_shared_block():
    """The smoke Zamba2 on the card: prefill launches the flash kernel once
    per shared-block call and the SSD kernel once per Mamba2 layer; the
    serve steps launch neither."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.model import prepare_decode_cache

    _cuda()
    cfg = get_config("zamba2-7b", smoke=True)
    model = build_model(cfg)
    params = model.init()
    tokens = torch.randint(0, 512, (2, 70), device="cuda", dtype=torch.int32)
    FK.reset_launches()
    SK.reset_launches()
    tok, cache = make_prefill_step(model)(params, {"tokens": tokens})
    assert FK.LAUNCHES["flash_attention"] == cfg.n_attn_slots
    assert SK.LAUNCHES["ssd"] == cfg.n_layers - cfg.n_attn_slots
    cache = prepare_decode_cache(cfg, cache, 74)
    FK.reset_launches()
    SK.reset_launches()
    serve = make_serve_step(model)
    for _ in range(4):
        tok, cache = serve(params, tok, cache)
    torch.cuda.synchronize()
    assert FK.LAUNCHES["flash_attention"] == 0 and SK.LAUNCHES["ssd"] == 0
    assert tok.dtype == torch.int32 and int(cache["len"]) == 74


@pytest.mark.cuda
@pytest.mark.parametrize("rows,g,bits", [
    (256 * 192, 16, 16), (8 * 192, 16, 16), (32 * 256, 16, 16),
    (256 * 192, 16, 8), (7 * 24, 16, 16), (300, 8, 16), (64, 4, 8),
    (100, 12, 16), (96, 16, 32)])
def test_cuda_exp_delta_matches_plain_on_card(rows, g, bits):
    """Bit-exact: a 512-token serving span (256 pages of 192 channels), a
    decode page fill (8 pages), the quickstart's KV (32 groups of 256
    channels), fp8_e4m3 in uint8, ragged row counts, the reference's test
    shapes (G 8 and 4) and G 12, which take the kernel's run-time path as
    every G but 16 does, and fp32;
    then decode of top-k truncations of the encoded values."""
    dev = _cuda()
    man, mask = {16: (7, 0xFF), 8: (3, 0xF), 32: (23, 0xFF)}[bits]
    gen = torch.Generator(device=dev).manual_seed(rows + g)
    dtype = K.CONTAINERS[bits // 8]
    u = torch.randint(-(1 << 31), 1 << 31, (rows, g), generator=gen, device=dev,
                      dtype=torch.int64)
    u = ER._narrow(u & ((1 << bits) - 1), dtype)
    enc, base = EK.encode(u, man, mask)
    enc_r, base_r = ER.encode_ref(u, man, mask)
    assert torch.equal(enc, enc_r) and torch.equal(base, base_r)
    assert torch.equal(EK.decode(enc, base, man, mask), u)
    for keep in (k for k in (12, 8, 4) if k < bits):
        low = (1 << (bits - keep)) - 1
        trunc = ER._narrow(ER._widen(enc) & ~low, dtype)
        assert torch.equal(EK.decode(trunc, base, man, mask),
                           ER.decode_ref(trunc, base, man, mask))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("kind,g", [("offset", 16), ("offset", 12), ("wide", 16),
                                    ("wide", 8)])
def test_cuda_exp_delta_flat_rows_read_in_place(kind, g):
    """The flat entry point reads its (R, G) rows in place at any start and
    row stride (one value past an aligned start; rows inside wider rows),
    through the staged path or the direct one as the plan decides, bit for
    bit against the plain version, one launch."""
    dev = _cuda()
    man, mask = C.EXP_DELTA_FIELDS[16]
    gen = torch.Generator(device=dev).manual_seed(g)
    rows = 1000
    u = torch.randint(0, 1 << 16, (rows * (g + 4) + 1,), generator=gen, device=dev,
                      dtype=torch.int64)
    u = ER._narrow(u, torch.int16)
    u = u[1 : rows * g + 1].view(rows, g) if kind == "offset" else \
        u[: rows * (g + 4)].view(rows, g + 4)[:, :g]
    EK.reset_launches()
    enc, base = EK.encode(u, man, mask)
    torch.cuda.synchronize()
    assert EK.LAUNCHES["exp_delta_encode"] == 1
    enc_r, base_r = ER.encode_ref(u, man, mask)
    assert torch.equal(enc, enc_r) and torch.equal(base, base_r)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,group,bits", C.EXP_DELTA_VIEWS)
def test_cuda_cluster_encode_matches_plain_on_card(kind, shape, group, bits):
    """The token-major view read in place, clustered, tail-padded and
    encoded in one launch, bit for bit against the plain version (pad,
    cluster, encode_ref), at chip_smoke's phase-2 views: the memory tier's,
    every container, G 8, 12 and 16, the byte path and channel chunks."""
    dev = _cuda()
    man, mask = C.EXP_DELTA_FIELDS[bits]
    gen = torch.Generator(device=dev).manual_seed(sum(shape) + group)
    n = shape[0] * (shape[1] + 8) if kind == "wide" else math.prod(shape) + 1
    u = torch.randint(0, 1 << bits, (n,), generator=gen, device=dev, dtype=torch.int64)
    view = C.encode_view(ER._narrow(u, K.CONTAINERS[bits // 8]), kind, shape)
    EK.reset_launches()
    enc, base = EK.cluster_encode(view, group, man, mask)
    torch.cuda.synchronize()
    assert EK.LAUNCHES["exp_delta_encode"] == 1
    enc_r, base_r = ER.cluster_encode_ref(view, group, man, mask)
    assert enc.shape == enc_r.shape and base.shape == base_r.shape
    assert torch.equal(enc, enc_r) and torch.equal(base, base_r)


def _kv_bits(dev, tokens, channels, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    kv = torch.randn((tokens, channels), generator=gen, device=dev) * 0.5
    return kv.to(torch.bfloat16).view(torch.int16)


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [16, 37, 512])
def test_cuda_compress_kv_equals_cpu(tokens):
    """compress_kv of a CUDA tensor (transformed by the kernels) gives the
    CPU's blobs for the same bits, and decompresses to them on the card."""
    from repro_torch.core import compressed_store as CS
    from repro_torch.core.bitplane import BF16

    dev = _cuda()
    kv = _kv_bits(dev, tokens, 192, tokens)
    cfg = CS.StoreConfig(codec="lz4")
    EK.reset_launches()
    ct = CS.compress_kv(kv, BF16, cfg)
    assert EK.LAUNCHES["exp_delta_encode"] == 1
    ref = CS.compress_kv(kv.cpu(), BF16, cfg)
    assert ct.segments == ref.segments and ct.base_blob == ref.base_blob
    for keep in (None, 12, 8, 4):
        got = CS.decompress_kv(ct, keep, device=dev)
        want = CS.decompress_kv(ref, keep, device="cpu")
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
    assert torch.equal(CS.decompress_kv(ct, device=dev), kv)
    assert EK.LAUNCHES["exp_delta_decode"] == 5


@pytest.mark.cuda
def test_cuda_get_sequence_round_trip():
    """put_sequence / get_sequence on the card: one encode per put, one
    decode per get; full precision reads the KV back bit for bit, a ladder
    of keeps equals the CPU store's read."""
    from repro_torch.core.compressed_store import StoreConfig
    from repro_torch.serving.kv_cache import CompressedKVStore

    dev = _cuda()
    kv = _kv_bits(dev, 70, 192, 3)
    card = CompressedKVStore(config=StoreConfig(codec="lz4"))
    host = CompressedKVStore(config=StoreConfig(codec="lz4"))
    EK.reset_launches()
    assert card.put_sequence(1, 0, "k", kv) == host.put_sequence(1, 0, "k", kv.cpu()) == 5
    assert EK.LAUNCHES["exp_delta_encode"] == 1
    assert torch.equal(card.get_sequence(1, 0, "k", 70, device=dev), kv)
    full = host.get_sequence(1, 0, "k", 70)
    assert torch.equal(kv.cpu(), torch.from_numpy(full.view("int16")))
    keeps = {0: 12, 1: 8, 2: 4, 4: 16}
    got = card.get_sequence(1, 0, "k", 70, keeps, device=dev)
    want = host.get_sequence(1, 0, "k", 70, keeps)
    assert torch.equal(got.cpu(), torch.from_numpy(want.view("int16")))
    assert EK.LAUNCHES["exp_delta_decode"] == 2
    assert card.controller.stats.totals == host.controller.stats.totals


# ---------------------------------------------------------------------------
# Shared-prefix pages and weight streaming on the card
# ---------------------------------------------------------------------------


def _tree_to(tree, dev):
    return {k: _tree_to(v, dev) if isinstance(v, dict) else v.to(dev) for k, v in tree.items()}


@pytest.mark.cuda
def test_cuda_prefix_snapshot_and_adoption_are_bit_exact():
    """Full-width SmolLM-135M with a bit-plane cache: the registered
    snapshot equals the donor slot's rows of every layer, and adopting it
    into another slot writes planes equal to the donor's (one pack)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ContinuousScheduler, Request

    dev = _cuda()
    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    sched = ContinuousScheduler(model, params,
                                C.prefix_config(C.engine_config("fused"), True, "resident"))
    rng = np.random.default_rng(0)
    shared = rng.integers(0, cfg.vocab, 384).astype(np.int32)
    donor = np.concatenate([shared, rng.integers(0, cfg.vocab, 40).astype(np.int32)])
    sched.submit(Request(rid=0, prompt=donor, max_new_tokens=4))
    sched.run_until_drained()
    backend = sched.backend
    (entry,) = backend.prefix._entries.values()
    t = len(donor) // 16 * 16
    assert entry.k.shape == (cfg.n_layers, t, cfg.n_kv_heads * cfg.head_dim)
    assert entry.k.device.type == "cuda"
    # the donor held slot 0, whose rows retirement leaves in place
    rows = backend.slot_kv_bits(0, 0, t, layers=slice(None))
    assert torch.equal(rows[:, 0], entry.k) and torch.equal(rows[:, 1], entry.v)
    follower = np.concatenate([shared, rng.integers(0, cfg.vocab, 30).astype(np.int32)])
    backend.bind_slot(5, 1)
    K.reset_launches()
    assert backend.match_prefix(5, follower) == len(shared)
    torch.cuda.synchronize()
    assert K.LAUNCHES == {"bitplane_pack": 1, "bitplane_unpack": 0}
    cache = backend.cache
    for name in ("k_planes", "v_planes"):
        assert torch.equal(cache[name][:, :, 5, :len(shared)], cache[name][:, :, 0, :len(shared)])
    got = backend.slot_kv_bits(5, 0, len(shared), layers=slice(None))
    assert torch.equal(got[:, 0], entry.k[:, :len(shared)])
    backend.retire(5, 1)


@pytest.mark.cuda
def test_cuda_sharing_counters_equal_the_cpu():
    """With no store budget the matches depend on the prompts alone: the
    card and the CPU match the same requests, tokens, pages and chunks."""
    from repro_torch.configs import get_config
    from repro_torch.core.quantization import PrecisionLadder
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig

    dev = _cuda()
    model = build_model(get_config("smollm-135m", smoke=True))
    params = model.init(torch.Generator().manual_seed(0))
    base = EngineConfig(max_batch=4, max_ctx=192, ladder=PrecisionLadder(C.LADDER),
                        codec="lz4", device_kv="bitplane", backend="paged")
    classes = (("chat", 64, (4, 20), (4, 8), 0.6), ("agentic", 32, (4, 12), (6, 10), 0.2),
               ("longdoc", 0, (40, 70), (2, 4), 0.2))
    keys = ("requests_matched", "tokens_matched", "pages_matched", "prefill_chunks_skipped")
    got = {}
    for where, p in (("cpu", params), ("cuda", _tree_to(params, dev))):
        run = C.serve_trace(torch, model, p, C.prefix_config(base, True, "resident"),
                            C.prefix_trace(n=12, max_ctx=192, classes=classes))
        got[where] = {k: run["rep"]["prefix"][k] for k in keys}
    assert got["cuda"] == got["cpu"]
    assert got["cuda"]["requests_matched"] > 0


@pytest.mark.cuda
def test_cuda_attach_weights_equals_host_copies():
    """The weight store of card-resident params holds the blobs and bytes
    of a store fed host copies of them, in the backend and by itself."""
    from repro_torch.configs import get_config
    from repro_torch.core.compressed_store import StoreConfig
    from repro_torch.core.controller import MemoryController
    from repro_torch.models import build_model
    from repro_torch.models.transformer import split_layer_params
    from repro_torch.serving import ContinuousScheduler, EngineConfig
    from repro_torch.weights import CompressedWeightStore

    dev = _cuda()
    model = build_model(get_config("smollm-135m", smoke=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    host = CompressedWeightStore.from_handles(
        split_layer_params(_tree_to(params, "cpu")),
        MemoryController(StoreConfig(codec="lz4"), retain_events=False))
    sched = ContinuousScheduler(model, params, EngineConfig(
        max_ctx=128, codec="lz4", weight_stream="compressed"))
    card = sched.backend.streamers[0].store
    assert card.stored_bytes == host.stored_bytes and \
        card.valid_logical_bytes == host.valid_logical_bytes
    for li in range(card.n_layers):
        for e in card.layer(li).entries:
            assert card.controller.weight_tensor(e.key).segments == \
                host.controller.weight_tensor(e.key).segments


# ---------------------------------------------------------------------------
# The ring: flash attention with key positions, the paged kernels over a
# ring mask, a Mixtral ring step through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("c,w,filled,hp,hkv,hd,window", [
    (512, 4096, 6096, 32, 8, 128, 4096),   # Mixtral's ring chunk, a full ring
    (512, 4096, 3000, 32, 8, 128, 4096),   # ... a ring with unfilled slots (-1)
    (64, 256, 300, 6, 2, 16, 256),         # Mixtral SMOKE's heads
    (128, 512, 700, 9, 3, 64, 300),        # a window shorter than the ring
    (1, 1024, 2000, 32, 8, 128, 1024),     # one query
    (1000, 1024, 1500, 8, 8, 112, 1024),   # ragged chunk, hd 112
])
def test_cuda_flash_attention_with_key_positions_matches_plain(c, w, filled, hp, hkv, hd,
                                                               window):
    """The ring chunk's call, [ring] ++ [chunk] with every key at its own
    position (-1 unfilled), one launch, within FLASH_BF16_STEPS of the plain
    version at each row's largest magnitude; the chunk's last 5 tokens are
    pad, beyond kv_valid."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(c + hd)
    ring = C.ring_positions(torch, dev, 1, w, (filled,))
    q_pos = (filled + torch.arange(c, device=dev, dtype=torch.int32))[None].contiguous()
    kv_pos = torch.cat([ring, q_pos], dim=1)
    q = torch.randn((1, c, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    valid = filled + max(1, c - 5)
    FK.reset_launches()
    got = FO.flash_attention(q, k, v, q_pos=q_pos, kv_valid=valid, window=window,
                             kv_pos=kv_pos)
    assert FK.LAUNCHES["flash_attention"] == 1
    want = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=valid, window=window,
                                  kv_pos=kv_pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert C.row_bf16_steps(got, want) <= FLASH_BF16_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("c", [512, 16])
def test_cuda_flash_attention_key_positions_two_rings_of_their_own(c):
    """Two batch rows whose rings wrap at different slots (one full, one
    part-filled) and whose kv_valid differ: each row's key tiles are sorted
    from its own positions' bounds (at 16 queries the keys are split, each
    split a share of the row's visited tiles); within FLASH_BF16_STEPS of
    the plain version."""
    dev = _cuda()
    w, hp, hkv, hd = 1024, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(c)
    ends = (2000, 700)
    ring = C.ring_positions(torch, dev, 2, w, ends)
    q_pos = torch.stack([e + torch.arange(c, device=dev, dtype=torch.int32) for e in ends])
    kv_pos = torch.cat([ring, q_pos], dim=1).contiguous()
    kv_valid = torch.tensor([ends[0] + c, ends[1] + c - 3], dtype=torch.int32, device=dev)
    q = torch.randn((2, c, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((2, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((2, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    got = FK.flash_attention(q, k, v, q_pos.contiguous(), kv_valid, causal=True, window=w,
                             kv_pos=kv_pos)
    want = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid, window=w,
                                  kv_pos=kv_pos)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    assert C.row_bf16_steps(got, want) <= FLASH_BF16_STEPS


@pytest.mark.cuda
def test_cuda_flash_attention_key_positions_in_index_order_match_the_index_path():
    """kv_pos = arange(Skv): the tiles sorted from their positions' bounds
    skip and take whole what the index path does; the result stays within
    FLASH_BF16_STEPS of the index path's."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(9)
    q = torch.randn((2, 256, 8, 64), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((2, 768, 2, 64), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((2, 768, 2, 64), generator=gen, device=dev).to(torch.bfloat16)
    pos = (512 + torch.arange(256, device=dev, dtype=torch.int32))[None].expand(2, 256)
    index = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=768, window=300)
    kv_pos = torch.arange(768, device=dev, dtype=torch.int32)[None].expand(2, 768)
    ring = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=768, window=300, kv_pos=kv_pos)
    torch.cuda.synchronize()
    assert C.row_bf16_steps(ring, index) <= FLASH_BF16_STEPS


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused", "rung"])
def test_cuda_paged_attention_over_a_ring_mask_matches_plain(kernel):
    """Decode over a bit-plane ring (wrapped, part-filled and just-full
    rows): the positions and the window fold into the mask; the kernel
    against the plain version at the serving tolerance."""
    from repro_torch.kernels.paged_attention import ops as O

    dev = _cuda()
    b, w, hkv, rep, hd = 4, 1024, 8, 4, 128
    gen = torch.Generator(device=dev).manual_seed(21)
    q = torch.randn((b, 1, hkv * rep, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = (O.pack_kv_planes(torch.randn((b, w, hkv, hd), generator=gen, device=dev)
                               .to(torch.bfloat16)) for _ in range(2))
    ln = torch.tensor([3000, 1100, 600, 1023], dtype=torch.int32, device=dev)
    kv_pos = C.ring_positions(torch, dev, b, w, [int(n) + 1 for n in ln])
    choice = torch.tensor((8, 12, 16), dtype=torch.int32, device=dev)
    pp = choice[torch.randint(0, 3, (b, w // 16), generator=gen, device=dev)]
    args = dict(keeps=(8, 12, 16), q_pos=ln[:, None], kv_pos=kv_pos, window=800,
                kernel=kernel)
    got = O.batched_ladder_paged_attention(q, kp, vp, pp, ln + 1, **args)
    with C.plain_attention():
        want = O.batched_ladder_paged_attention(q, kp, vp, pp, ln + 1, **args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), atol=C.KERNEL_ATOL, rtol=C.KERNEL_RTOL)


@pytest.mark.cuda
def test_cuda_mixtral_ring_step_matches_the_plain_path():
    """Mixtral SMOKE (window 64) through the ring on the card: prefill
    chunks past the window and decode steps through the kernels, against
    the same steps with the plain attention and flash versions, logits
    within LOGITS_RTOL_OF_MAX of the largest; every kernel of the path
    launched."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.transformer import bitplane_cache_from_dense

    dev = _cuda()
    model = build_model(get_config("mixtral-8x7b", smoke=True))
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    w = model.cfg.attn_window
    prompt = torch.randint(0, model.cfg.vocab, (1, 160), generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev)

    def run(cache):
        for start in range(0, 160, w):  # chunks of the window, as the scheduler caps them
            chunk = prompt[:, start:start + w]
            logits, cache = model.prefill_chunk(params, chunk, cache, 0, start,
                                                chunk.shape[1] - 1)
        out = [logits]
        cache["len"] = torch.tensor([160, 0], dtype=torch.int32, device=dev)
        tok = logits.argmax(-1).repeat(2)
        for _ in range(3):
            logits, cache = model.decode(params, tok, cache, keeps=(16,))
            out.append(logits[:1])
            tok = logits.argmax(-1)
        return torch.cat(out)

    caches = []
    for _ in range(2):  # the layout's conversion packs each layer's streams
        caches.append(bitplane_cache_from_dense(model.init_cache(2, 256, dev)))
        caches[-1]["len"] = torch.zeros(2, dtype=torch.int32, device=dev)
    for m in C.launch_modules():
        m.reset_launches()
    got = run(caches[0])
    launches = {k: v for m in C.launch_modules() for k, v in m.LAUNCHES.items()}
    with C.uncounted(), C.plain_attention(), C.plain_flash():
        want = run(caches[1])
    torch.cuda.synchronize()
    n = model.cfg.n_layers
    assert launches["flash_attention"] == n * 3
    assert launches["paged_attention_fused"] == n * 3
    assert launches["bitplane_pack"] == n * 6 and launches["bitplane_unpack"] == n * 3
    assert float((got - want).abs().max()) <= C.LOGITS_RTOL_OF_MAX * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hp,hkv,hd,start,valid,causal", [
    (1, 512, 2048, 48, 8, 128, 0, 512, True),       # Nemotron-4: rep 6, 21 tokens a block
    (1, 512, 2048, 48, 8, 128, 1024, 1536, True),   # ... a chunk at an offset: keys split
    (1, 512, 2048, 16, 16, 128, 0, 512, True),      # DeepSeek-MoE: rep 1 at hd 128
    (1, 700, 700, 64, 8, 128, 0, 700, True),        # LLaVA's heads: 56 padded to 64
    (2, 1500, 1500, 6, 6, 64, 0, 1500, False),      # Whisper encoder: 92 keys in the last tile
    (2, 224, 1500, 6, 6, 64, 0, 1500, False),       # Whisper cross attention: Sq != Skv
])
def test_cuda_flash_attention_matches_plain_at_the_new_families(b, sq, skv, hp, hkv, hd,
                                                                start, valid, causal):
    """The flash kernel at the shapes the new families give it (phase 8),
    each against its plain version within FLASH_BF16_STEPS a row; a
    padded q head's zero query attends uniformly (its output is the mean
    of the values, masked by the model before ``wo``)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq + hp * hd)
    q = torch.randn((b, sq, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
    if hp == 64:  # LLaVA's grouped layout: the last slot of each group of 8 is padding
        q[:, :, 7::8] = 0
    k = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq)
    FK.reset_launches()
    got = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=valid, causal=causal)
    assert FK.LAUNCHES["flash_attention"] == 1
    want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=valid, causal=causal)
    torch.cuda.synchronize()
    assert C.row_bf16_steps(got, want) <= FLASH_BF16_STEPS
    if hp == 64:
        mean = v.float().mean(1)[:, None, :, None].expand(b, sq, hkv, 1, hd)
        pad = got.reshape(b, sq, hkv, 8, hd)[:, :, :, 7:].float()
        assert not causal or torch.allclose(pad[:, -1], mean[:, -1], atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape", C.PAGED_PHASE8)
def test_cuda_paged_attention_matches_plain_at_the_new_families(name, shape):
    """Both paged kernels at phase 8's decode shapes (DeepSeek: 16 kv heads,
    rep 1; Nemotron-4: 8 kv heads, rep 6; hd 128), keeps {8, 12, 16} and
    phase 8's lengths with a row that holds nothing: the fused output, the
    rung partials and their merge against the plain versions."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(31)
    case = C.random_case(torch, dev, gen, shape, (8, 12, 16), C.PAGED_PHASE8_LENS)
    C.check_paged_case(torch, case, 3, (8, 12, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-tiny"])
def test_cuda_prefill_families_match_the_plain_path(arch):
    """LLaVA (SMOKE, q heads padded 8 -> 16) and Whisper SMOKE through
    phase 8c's and 8d's runs on the card: every attention sub-layer of the
    prefill through the flash kernel within FLASH_BF16_STEPS of the plain
    one, padded heads exactly zero before ``wo``, decode after prefill
    within LOGITS_RTOL_OF_MAX of prefill, and flash launched once per
    attention sub-layer of a prefill and never in decode."""
    dev = _cuda()
    if arch == "whisper-tiny":
        out = C.run_whisper_phase(torch, dev, smoke=True, b=2, text=40, steps=4)
        assert out["launches"]["flash_attention"] == 2 + 2 * 2
    else:
        out = C.run_vlm_phase(torch, dev, smoke=True, b=2, text=40, max_len=128, steps=4,
                              pad_heads_to=16, n_layers=2)
        assert out["launches"]["flash_attention"] == 2
    assert out["attn_steps"] <= FLASH_BF16_STEPS


@pytest.mark.cuda
def test_cuda_deepseek_serving_matches_the_plain_path():
    """DeepSeek-MoE SMOKE served through the paged kernels on the card
    (phase 8a's run at smoke size): every request served, launches as the
    counts predict, each attention sub-layer of a decode step fused and
    rung within two bf16 steps of the plain attention."""
    dev = _cuda()
    model, params = C.family_model(torch, dev, "deepseek-moe-16b", smoke=True)
    out = C.run_family_phase(torch, model, params, 4, 20, 70, "card test", new=6,
                             profile_steps=0, max_batch=2, max_ctx=128)
    assert max(max(w) for w in out["layers"]) <= C.ATTN_BF16_STEPS
    assert out["forced"]["fused_vs_plain"] <= C.LOGITS_RTOL_OF_MAX * out["forced"]["max_logit"]
