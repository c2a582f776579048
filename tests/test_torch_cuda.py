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
float32 on both sides and differs only in the order of its sums: it is held
to 1e-4 of the largest output (about 1e-5 measured at full width).  Flash
attention rounds p to bf16 at the running max of its 64-key tiles, the plain
version at that of its 512-key chunks, and the float32 sums run in another
order, which can flip a rounding of p or of the output: it is held to two
bf16 steps at the largest magnitude of each output row (batch row, query,
head), since a causal row's output shrinks with its depth.  The
exponent-delta encode and decode are integer transforms and, like the KV
store's blobs and decoded pages, must match bit for bit.
"""

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
    a = -(torch.rand((h,), generator=gen, device=dev) * 15 + 1)
    dt = torch.rand((b, l, h), generator=gen, device=dev) * 0.099 + 1e-3
    xdt = torch.randn((b, l, h, p), generator=gen, device=dev) * dt[..., None]
    b_h = torch.randn((b, l, h, n), generator=gen, device=dev)
    c_h = torch.randn((b, l, h, n), generator=gen, device=dev)
    state = torch.randn((b, h, n, p), generator=gen, device=dev) if h0 else None
    SK.reset_launches()
    y, hf = SO.ssd(xdt, dt * a, b_h, c_h, state, chunk=chunk)
    assert SK.LAUNCHES["ssd"] == 1
    y_r, hf_r = SR.ssd_ref(xdt, dt * a, b_h, c_h, state, chunk=chunk)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    assert (y - y_r).abs().max() <= SSD_REL_TOL * y_r.abs().max()
    assert (hf - hf_r).abs().max() <= SSD_REL_TOL * hf_r.abs().max()


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
    (2, 1000, 1000, 8, 2, 64, 0, 1000, True, 0),      # ragged L
    (1, 256, 256, 4, 4, 128, 0, 256, True, 64),       # sliding window
    (2, 64, 192, 6, 3, 32, 0, 150, False, 0),         # bidirectional, valid < Skv
    (3, 40, 40, 4, 4, 16, 0, 40, True, 0),            # the smoke config
])
def test_cuda_flash_attention_matches_plain_on_card(b, sq, skv, hp, hkv, hd, start,
                                                    valid, causal, window):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(sq * hp + hd)
    q = torch.randn((b, sq, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, skv, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq)
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
