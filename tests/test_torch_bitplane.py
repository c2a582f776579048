"""Bit-plane pack, unpack and the bit-plane matmul: the port's plain
versions vs the reference's Pallas kernels (interpret mode on the CPU).
The CUDA kernels are held against the plain versions on the card in
``tests/test_torch_cuda.py``, which imports no JAX.

Tolerances: pack, unpack, weight packing and weight reconstruction move
bits and must match bit for bit.  The matmul takes exact bf16 x bf16
products in float32 on both sides and sums them in another order, so it
is held to atol = rtol = 1e-5 (float32 sums of K <= 1024 terms of
magnitude <= 1 differ by far less).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.bitplane import BF16 as J_BF16
from repro.kernels.bitplane import kernel as JK
from repro.kernels.bitplane import ops as JO
from repro.kernels.bitplane_matmul import ops as JMM
from repro.kernels.bitplane_matmul.ref import reconstruct_ref as j_reconstruct
from repro.kernels.paged_attention.ops import pack_kv_planes as j_pack_kv

from repro_torch.core.bitplane import BF16
from repro_torch.kernels.bitplane import kernel as K
from repro_torch.kernels.bitplane import ops as O
from repro_torch.kernels.bitplane import ref as R
from repro_torch.kernels.bitplane_matmul import kernel as MK
from repro_torch.kernels.bitplane_matmul import ops as MM
from repro_torch.kernels.bitplane_matmul import ref as MR
from repro_torch.kernels.paged_attention.ops import pack_kv_planes, unpack_kv

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

MATMUL_TOL = 1e-5
UNSIGNED = {1: np.uint8, 2: np.uint16, 4: np.uint32}


def _raw(m, bits, seed):
    """m random ``bits``-bit values: (NumPy unsigned, torch container)."""
    width = max(1, bits // 8)
    u = np.random.default_rng(seed).integers(0, 1 << bits, m, dtype=np.uint64)
    raw = u.astype(UNSIGNED[width])
    return raw, torch.from_numpy(raw.copy()).view(K.CONTAINERS[width])


def _unsigned(t):
    return t.numpy().view(UNSIGNED[t.element_size()])


CASES = [(bits, keep, m) for bits in (16, 8) for keep in sorted({bits, 12, 8, 4}, reverse=True)
         if keep <= bits for m in (32768, 65536)]


@pytest.mark.parametrize("bits,keep,m", CASES)
def test_pack_unpack_match_reference_pallas(bits, keep, m):
    raw, u = _raw(m, bits, seed=bits * 100 + keep + m)
    want = np.asarray(JK.pack(jnp.asarray(raw.astype(np.uint32)), bits))
    got = O.pack_raw(u, bits)
    np.testing.assert_array_equal(got.numpy(), want)
    back = np.asarray(JK.unpack(jnp.asarray(want), bits, keep))
    mine = O.unpack_raw(got, bits, keep, u.dtype)
    np.testing.assert_array_equal(_unsigned(mine).astype(np.uint32), back)
    # only the top `keep` planes are an input of the unpack
    np.testing.assert_array_equal(O.unpack_raw(got[:keep].clone(), bits, keep, u.dtype),
                                  mine)
    if keep == bits:
        np.testing.assert_array_equal(_unsigned(mine), raw)


@pytest.mark.parametrize("keep", [16, 8])
def test_value_space_pack_unpack_match_reference_bf16(keep):
    rng = np.random.default_rng(keep)
    shape = (300, 70)  # 21000 values: padded to one 32768-value block
    x = rng.standard_normal(shape).astype(ml_dtypes.bfloat16)
    j_planes, j_n = JO.pack(jnp.asarray(x), J_BF16)
    xt = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    planes, n = O.pack(xt, BF16)
    assert n == j_n == x.size
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_planes))
    want = np.asarray(JO.unpack(j_planes, J_BF16, shape, keep=keep)).view(np.uint16)
    got = O.unpack(planes, BF16, shape, keep=keep)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), want)


@pytest.mark.parametrize("keep", [16, 12, 8, 4])
def test_kv_planes_are_the_flat_pack_reshaped(keep):
    """pack_kv_planes / unpack_kv equal the flat Pallas pack / unpack of the
    row-major values, reshaped (bits, B, S, Hkv, hd/8)."""
    rng = np.random.default_rng(keep + 40)
    kv = rng.standard_normal((2, 128, 2, 64)).astype(ml_dtypes.bfloat16)
    kvt = torch.from_numpy(kv.view(np.int16).copy()).view(torch.bfloat16)
    flat = np.asarray(JK.pack(jnp.asarray(kv.view(np.uint16).reshape(-1).astype(np.uint32)), 16))
    planes = pack_kv_planes(kvt)
    assert tuple(planes.shape) == (16, 2, 128, 2, 8)
    np.testing.assert_array_equal(planes.numpy(), flat.reshape(planes.shape))
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_pack_kv(jnp.asarray(kv))))
    want = np.asarray(JK.unpack(jnp.asarray(flat), 16, keep)).astype(np.uint16)
    got = unpack_kv(planes, keep)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == kv.shape
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16).reshape(-1),
                                  want)


def _weights(k, n, seed):
    w = (np.random.default_rng(seed).standard_normal((k, n)) * 0.05).astype(ml_dtypes.bfloat16)
    return w, torch.from_numpy(w.view(np.int16).copy()).view(torch.bfloat16)


@pytest.mark.parametrize("keep", [16, 12, 8, 4])
def test_pack_weights_and_reconstruct_match_reference(keep):
    w, wt = _weights(256, 512, seed=keep)
    want = np.asarray(JMM.pack_weights(jnp.asarray(w)))
    planes = MM.pack_weights(wt)
    np.testing.assert_array_equal(planes.numpy(), want)
    rec = MR.reconstruct_ref(planes, keep)
    np.testing.assert_array_equal(rec.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(j_reconstruct(jnp.asarray(want), keep)).view(np.uint16))


@pytest.mark.parametrize("keep", [16, 12, 8, 4])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 512), (128, 512, 256)])
def test_bitplane_matmul_matches_reference_pallas(m, k, n, keep):
    w, wt = _weights(k, n, seed=k + n)
    x = np.random.default_rng(m + keep).standard_normal((m, k)).astype(ml_dtypes.bfloat16)
    j_planes = JMM.pack_weights(jnp.asarray(w))
    want = np.asarray(JMM.bitplane_matmul(jnp.asarray(x), j_planes, keep=keep))
    xt = torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    got = MM.bitplane_matmul(xt, MM.pack_weights(wt), keep=keep)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.numpy(), want, atol=MATMUL_TOL, rtol=MATMUL_TOL)
    assert MM.weight_fetch_bytes(MM.pack_weights(wt), keep) == JMM.weight_fetch_bytes(
        j_planes, keep) == keep * k * n // 8


def test_cpu_takes_plain_versions_and_launches_nothing():
    K.reset_launches()
    MK.reset_launches()
    _, u = _raw(1536, 16, seed=1)
    planes = O.pack_raw(u, 16)
    O.unpack_raw(planes, 16, 8, torch.int16)
    _, wt = _weights(64, 64, seed=2)
    MM.bitplane_matmul(torch.ones(3, 64, dtype=torch.bfloat16), MM.pack_weights(wt), keep=8)
    assert K.LAUNCHES == {"bitplane_pack": 0, "bitplane_unpack": 0}
    assert MK.LAUNCHES == {"bitplane_matmul": 0}


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_shapes():
    _, u = _raw(64, 16, seed=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.pack(u, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.unpack(R.pack_ref(u, 16), 16, 8, torch.int16)
    _, wt = _weights(64, 64, seed=4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        MK.bitplane_matmul(torch.ones(2, 64, dtype=torch.bfloat16),
                           MR.pack_weights_ref(wt.view(torch.int16)), keep=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        O.pack_raw(u[:60], 16)
