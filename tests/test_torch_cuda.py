"""The port's bit-plane CUDA kernels against their plain PyTorch versions
on the card.  Every test here needs an NVIDIA GPU and ``nvcc``, carries
the ``cuda`` marker and skips without a GPU.  The file imports no JAX, so
it runs on the GPU host:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: pack and unpack move bits and must match bit for bit.  The
matmul takes exact bf16 x bf16 products in float32 on both sides; the
kernel sums them in K order and the plain version through cuBLAS in an
order of its own, so it is held to atol = rtol = 1e-4.
"""

import pytest
import torch

from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ref as R
from repro_torch.kernels.bitplane_matmul import kernel as MK
from repro_torch.kernels.bitplane_matmul import ops as MM
from repro_torch.kernels.bitplane_matmul import ref as MR

MATMUL_TOL = 1e-4


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
                                   (128, 1536, 576), (8, 1024, 1024), (5, 100, 24)])
def test_cuda_bitplane_matmul_matches_plain_on_card(m, k, n):
    """Full-width SmolLM-135M projections, the quickstart's shape, and a
    ragged one (M, K, N not multiples of the kernel's tiles)."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(m * k + n)
    w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    planes = MM.pack_weights(w)
    for keep in (16, 12, 8, 4):
        got = MK.bitplane_matmul(x, planes, keep=keep)
        torch.testing.assert_close(got, MR.bitplane_matmul_ref(x, planes, keep),
                                   atol=MATMUL_TOL, rtol=MATMUL_TOL)
    torch.cuda.synchronize()
