"""PyTorch port vs JAX reference: the NumPy and host layer, bit for bit.

Same inputs, made with NumPy from a seed, go through the reference and the
port: bit-plane packing, codec blobs, compressed KV pages, controller and
engine counters, and the Quest precision ladder on bf16 keys.
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.compression import get_codec as j_get_codec, have_zstd
from repro.core import compressed_store as JS
from repro.core.bitplane import SPECS as J_SPECS
from repro.core import quantization as JQ
from repro.core.controller import MemoryController as JController
from repro.kernels.paged_attention.ref import pack_kv_ref as j_pack, unpack_kv_ref as j_unpack
from repro.memctl import CompressionEngineRuntime as JEngine, Job as JJob, JobClass as JClass
from repro.memctl import MemCtlConfig as JMemCtl

from repro_torch.compression import get_codec as t_get_codec
from repro_torch.core import compressed_store as TS
from repro_torch.core.bitplane import SPECS as T_SPECS
from repro_torch.core import quantization as TQ
from repro_torch.core.controller import MemoryController as TController
from repro_torch.kernels.paged_attention.ref import pack_kv_ref as t_pack, unpack_kv_ref as t_unpack
from repro_torch.memctl import CompressionEngineRuntime as TEngine, Job as TJob, JobClass as TClass
from repro_torch.memctl import MemCtlConfig as TMemCtl
from repro_torch.models.convert import params_from_jax

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

CODECS = ["lz4", "zstd"]


def _bf16(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


def _torch(a):
    return params_from_jax(a, "cpu")


def _need(codec):
    if codec == "zstd" and not have_zstd():
        pytest.skip("zstandard is not installed")


@pytest.mark.parametrize("keep", [16, 12, 8, 4])
def test_pack_unpack_bit_exact(keep):
    rng = np.random.default_rng(keep)
    kv = _bf16(rng, 3, 48, 2, 16)
    pj = np.asarray(j_pack(jnp.asarray(kv)))
    pt = t_pack(_torch(kv))
    assert pt.dtype == torch.uint8
    np.testing.assert_array_equal(pj, pt.numpy())
    uj = np.asarray(j_unpack(jnp.asarray(pj), keep)).view(np.uint16)
    ut = t_unpack(pt, keep).view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(uj, ut)


@pytest.mark.parametrize("codec", CODECS)
def test_codec_blobs_identical(codec):
    _need(codec)
    rng = np.random.default_rng(1)
    blocks = [rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
              bytes(4096), (b"plane" * 900)[:4096],
              np.repeat(rng.integers(0, 4, 512, dtype=np.uint8), 8).tobytes()]
    jc, tc = j_get_codec(codec), t_get_codec(codec)
    for blk in blocks:
        blob = tc.compress(blk)  # repro-lint: disable=accounting-taint
        assert blob == jc.compress(blk)  # repro-lint: disable=accounting-taint
        assert tc.decompress(blob) == blk  # repro-lint: disable=accounting-taint


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("tokens", [16, 37])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_compress_kv_bit_exact(codec, tokens, kind):
    _need(codec)
    rng = np.random.default_rng(tokens)
    kv = _bf16(rng, tokens, 32, scale=0.5)
    jct = JS.compress_kv(kv, J_SPECS["bf16"], JS.StoreConfig(codec=codec))
    # the port takes bf16 as its raw uint16 bit patterns, or a CPU tensor of
    # bf16 values (transformed by the kernels' plain versions)
    bits = kv.view(np.uint16)
    if kind == "tensor":
        bits = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    tct = TS.compress_kv(bits, T_SPECS["bf16"], TS.StoreConfig(codec=codec))
    assert tct.segments == jct.segments and tct.base_blob == jct.base_blob
    assert tct.stored_bytes == jct.stored_bytes
    for keep in (None, 12, 8, 4):
        assert tct.fetch_bytes(keep) == jct.fetch_bytes(keep)
        dj = JS.decompress_kv(jct, keep).view(np.uint16)
        dt = TS.decompress_kv(tct, keep)
        assert dt.dtype == np.uint16
        np.testing.assert_array_equal(dj, dt)


def _controller_events(ctl, pages, spec):
    for i, page in enumerate(pages):
        ctl.write_kv_page(("r", 0, i), page, spec,
                          valid_values=None if i % 3 else 7 * page.shape[1])
    for i in range(len(pages)):
        for planes in (None, 16, 8, 4):
            ctl.account_kv_read(("r", 0, i), planes)
    ctl.drop_kv_page(("r", 0, 0))
    return ctl


@pytest.mark.parametrize("codec", CODECS)
def test_controller_stats_identical(codec):
    _need(codec)
    rng = np.random.default_rng(2)
    pages = [_bf16(rng, 16, 24, scale=s) for s in (0.1, 1.0, 3.0, 1e-3)]
    j = _controller_events(JController(JS.StoreConfig(codec=codec)), pages,
                           J_SPECS["bf16"])
    t = _controller_events(TController(TS.StoreConfig(codec=codec)),
                           [p.view(np.uint16) for p in pages], T_SPECS["bf16"])
    assert t.stats.totals == j.stats.totals
    assert [(e.kind, e.logical_bytes, e.physical_bytes, e.planes, e.device_bytes)
            for e in t.stats.events] == \
        [(e.kind, e.logical_bytes, e.physical_bytes, e.planes, e.device_bytes)
         for e in j.stats.events]
    assert t.footprint() == j.footprint()


def _engine_run(engine_cls, job_cls, klass, memctl_cls):
    eng = engine_cls(memctl_cls(engine="lz4", step_cycles=64))
    done = []
    sizes = [5000, 300, 12000, 64, 0, 9000, 2048]
    for step in range(6):
        for i, n in enumerate(sizes):
            k = [klass.KV_WRITE, klass.DECODE_FETCH, klass.BACKGROUND][(i + step) % 3]
            eng.submit(job_cls(k, n, fn=lambda s=step, i=i: done.append((s, i)),
                               key=("p", step, i), seq_id=i % 2))
        if step == 3:
            eng.cancel_seq(1)
        eng.tick()
    while len(eng.queue):
        eng.tick()
    return eng.report(), done


def test_engine_stats_identical():
    j_rep, j_done = _engine_run(JEngine, JJob, JClass, JMemCtl)
    t_rep, t_done = _engine_run(TEngine, TJob, TClass, TMemCtl)
    assert t_rep == j_rep
    assert t_done == j_done


@pytest.mark.parametrize("trial", range(6))
def test_assign_page_precision_bit_exact(trial):
    """Quest scores in bf16 and the stable per-head ranking: scores equal
    bit for bit, plane assignments equal — including tied scores (rounded
    keys make many pages tie)."""
    rng = np.random.default_rng(100 + trial)
    pages, heads, dim = int(rng.integers(2, 30)), (2, 3)[trial % 2], (16, 64)[trial % 2]
    keys = _bf16(rng, pages * 16, heads, dim, scale=10.0 ** rng.uniform(-2, 1))
    if trial % 3 == 0:
        keys = np.round(keys.astype(np.float32)).astype(ml_dtypes.bfloat16)
    kj = jnp.asarray(keys)
    kmin, kmax = JQ.page_minmax(kj, 16)
    sj = JQ.quest_scores(kj[-1], kmin, kmax)
    kt = _torch(keys)
    tmin, tmax = TQ.page_minmax(kt, 16)
    st = TQ.quest_scores(kt[-1], tmin, tmax)
    np.testing.assert_array_equal(np.asarray(sj).view(np.uint16),
                                  st.view(torch.int16).numpy().view(np.uint16))
    if trial % 3 == 0:
        assert len(np.unique(np.asarray(sj, np.float32))) < sj.size  # ties present
    for rungs in ([(2, 16), (2, 8), (-1, 4)], [(1, 16), (3, 12)], [(-1, 16)]):
        for drop in (False, True):
            pj = JQ.assign_page_precision(sj, JQ.PrecisionLadder(rungs, drop))
            pt = TQ.assign_page_precision(st, TQ.PrecisionLadder(rungs, drop))
            np.testing.assert_array_equal(np.asarray(pj), pt.numpy())
