"""PyTorch port vs JAX reference: the exponent-delta transform and the
memory tier's KV page path, on the CPU, bit for bit.

Same inputs, made with NumPy from a seed, go through the reference (its
Pallas exponent-delta kernel in interpret mode, its NumPy clustering, its
compressed store) and the port (the kernels' plain PyTorch versions, which
a CPU tensor takes).  Every comparison is exact: these are integer
transforms of raw bits and codec blobs.

    PYTHONPATH=src python -m pytest -q tests/test_torch_exp_delta.py
"""

import math

import ml_dtypes
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import compressed_store as JS
from repro.core import kv_clustering as JC
from repro.core.bitplane import SPECS as J_SPECS
from repro.kernels.exp_delta import ops as j_ops
from repro.kernels.exp_delta.ref import encode_ref as j_encode_ref
from repro.serving.kv_cache import CompressedKVStore as JStore

from repro_torch.core import compressed_store as TS
from repro_torch.core import kv_clustering as TC
from repro_torch.core.bitplane import SPECS as T_SPECS
from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.kernels.exp_delta import ops as t_ops
from repro_torch.kernels.exp_delta import ref as t_ref
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.serving.backends import base as backend_base
from repro_torch.serving.kv_cache import CompressedKVStore as TStore

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

CONTAINER = {8: torch.uint8, 16: torch.int16}
HOST = {8: np.uint8, 16: np.uint16}


def _bits(rng, bits, shape):
    return rng.integers(0, 2**bits, shape).astype(HOST[bits])


def _tensor(u):
    return torch.from_numpy(u.view({np.dtype(np.uint16): np.int16}.get(u.dtype, u.dtype)))


def _host(t):
    return t.numpy().view({torch.int16: np.uint16}.get(t.dtype, np.uint8))


@pytest.mark.parametrize("spec_name", ["bf16", "fp8_e4m3", "int8"])
@pytest.mark.parametrize("c,g", [(256, 16), (300, 8), (64, 4), (5 * 192, 16)])
def test_encode_decode_match_pallas_and_ref(spec_name, c, g):
    """The plain encode/decode against the reference's Pallas kernel
    (interpret mode) and its jnp oracle, at the reference's test shapes and
    the serving page (5 stored pages of 192 channels); an integer spec
    passes through with zero bases."""
    js, ts = J_SPECS[spec_name], T_SPECS[spec_name]
    rng = np.random.default_rng(c * g + ts.bits)
    u = _bits(rng, ts.bits, (c, g))
    enc_j, base_j = j_ops.encode(jnp.asarray(u.astype(np.uint32)), js)
    enc_o, base_o = j_encode_ref(jnp.asarray(u.astype(np.uint32)), js)
    enc_t, base_t = t_ops.encode(_tensor(u), ts)
    assert enc_t.dtype == CONTAINER[ts.bits] and base_t.dtype == torch.uint8
    np.testing.assert_array_equal(_host(enc_t), np.asarray(enc_j).astype(HOST[ts.bits]))
    np.testing.assert_array_equal(_host(enc_t), np.asarray(enc_o).astype(HOST[ts.bits]))
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_j))
    np.testing.assert_array_equal(base_t.numpy(), np.asarray(base_o).astype(np.uint8))
    dec_j = np.asarray(j_ops.decode(enc_j, base_j, js)).astype(HOST[ts.bits])
    dec_t = t_ops.decode(enc_t, base_t, ts)
    np.testing.assert_array_equal(_host(dec_t), dec_j)
    np.testing.assert_array_equal(_host(dec_t), u)


@pytest.mark.parametrize("keep", [12, 8, 4])
def test_decode_of_truncated_planes_matches_reference(keep):
    """Decode inputs whose low planes were dropped (a top-k fetch): the
    exponent field may lose bits, and the sum with the base wraps modulo
    the field, as the reference's does."""
    spec = T_SPECS["bf16"]
    rng = np.random.default_rng(keep)
    u = _bits(rng, 16, (192, 16))
    enc, base = t_ref.encode_ref(_tensor(u), spec.man_bits, spec.exp_mask)
    trunc = _host(enc) & np.uint16((0xFFFF << (16 - keep)) & 0xFFFF)
    want = np.asarray(j_ops.decode(jnp.asarray(trunc.astype(np.uint32)),
                                   jnp.asarray(base.numpy()), J_SPECS["bf16"]))
    got = t_ops.decode(_tensor(trunc), base, spec)
    np.testing.assert_array_equal(_host(got), want.astype(np.uint16))


@pytest.mark.parametrize("mode", ["delta", "xor", "none"])
@pytest.mark.parametrize("spec_name", ["bf16", "fp8_e4m3"])
def test_cluster_and_encode_match_reference_numpy(mode, spec_name):
    js, ts = J_SPECS[spec_name], T_SPECS[spec_name]
    rng = np.random.default_rng(len(mode) + ts.bits)
    u = _bits(rng, ts.bits, (48, 40))
    enc_j, base_j = JC.cluster_and_encode_np(u, js, 16, mode=mode)
    enc_t, base_t = TC.cluster_and_encode(_tensor(u), ts, 16, mode=mode)
    np.testing.assert_array_equal(_host(enc_t), enc_j)
    np.testing.assert_array_equal(base_t.numpy(), base_j)
    back_j = JC.decode_and_uncluster_np(enc_j, base_j, js, mode=mode)
    back_t = TC.decode_and_uncluster(enc_t, base_t, ts, mode=mode)
    np.testing.assert_array_equal(_host(back_t.contiguous()), back_j)
    np.testing.assert_array_equal(back_j, u)


def _bf16(rng, *shape, scale=0.5):
    return (rng.standard_normal(shape) * scale).astype(ml_dtypes.bfloat16)


@pytest.mark.parametrize("tokens", [16, 37])
def test_decompress_on_cpu_device_matches_reference(tokens):
    """``decompress_kv(..., device="cpu")`` returns raw bits as a tensor,
    equal at every keep to the reference's decompression."""
    rng = np.random.default_rng(tokens + 100)
    kv = _bf16(rng, tokens, 32)
    cfg_j, cfg_t = JS.StoreConfig(codec="lz4"), TS.StoreConfig(codec="lz4")
    jct = JS.compress_kv(kv, J_SPECS["bf16"], cfg_j)
    tct = TS.compress_kv(_tensor(kv.view(np.uint16)), T_SPECS["bf16"], cfg_t)
    assert tct.segments == jct.segments and tct.base_blob == jct.base_blob
    for keep in (None, 12, 8, 4):
        want = JS.decompress_kv(jct, keep).view(np.uint16)
        got = TS.decompress_kv(tct, keep, device="cpu")
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int16
        np.testing.assert_array_equal(_host(got), want)


def _stores():
    return (JStore(config=JS.StoreConfig(codec="lz4")),
            TStore(config=TS.StoreConfig(codec="lz4")))


@pytest.mark.parametrize("keep_by_page", [None, {0: 12, 1: 8, 3: 4}],
                         ids=["ladder-hint", "keep-by-page"])
@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "tensor"])
def test_put_get_sequence_match_reference(keep_by_page, device):
    """put_sequence (one encode for all pages) and get_sequence (one decode
    for all pages, each at its own keep) against the reference's per-page
    loops: blobs, arrays and the controller's totals."""
    rng = np.random.default_rng(7)
    js, ts = _stores()
    seqs = {(0, "k"): _bf16(rng, 61, 48), (0, "v"): _bf16(rng, 61, 48),
            (1, "k"): _bf16(rng, 32, 48, scale=2.0)}
    for (layer, stream), kv in seqs.items():
        n_j = js.put_sequence(5, layer, stream, kv, planes=8 if layer else None)
        host = kv.view(np.uint16)
        n_t = ts.put_sequence(5, layer, stream, host if device is None else _tensor(host),
                              planes=8 if layer else None)
        assert n_t == n_j
    for kt, ct in js.controller._kv_pages.items():
        got = ts.controller._kv_pages[kt]
        assert got.segments == ct.segments and got.base_blob == ct.base_blob
        assert got.valid_values == ct.valid_values
    for (layer, stream), kv in seqs.items():
        want = js.get_sequence(5, layer, stream, kv.shape[0], keep_by_page).view(np.uint16)
        got = ts.get_sequence(5, layer, stream, kv.shape[0], keep_by_page, device=device)
        np.testing.assert_array_equal(got if device is None else _host(got), want)
    assert ts.controller.stats.totals == js.controller.stats.totals
    assert ts.footprint() == {k: v for k, v in js.footprint().items()
                              if k in ts.footprint()}


@pytest.mark.parametrize("device", [None, "cpu"], ids=["numpy", "tensor"])
def test_get_sequence_miss_charges_like_reference(device):
    """A page reclaimed mid-sequence: both stores raise at that page after
    charging the pages before it, so the controllers' totals and the
    stores' hit and miss counts stay equal; the sequence before the miss
    still reads back equal."""
    rng = np.random.default_rng(11)
    js, ts = _stores()
    kv = _bf16(rng, 70, 48)
    js.put_sequence(3, 0, "k", kv)
    host = kv.view(np.uint16)
    ts.put_sequence(3, 0, "k", host if device is None else _tensor(host))
    for store in (js, ts):
        store._forget((3, 0, 2, "k"))
    keeps = {0: 12, 1: 8}
    with pytest.raises(KeyError):
        js.get_sequence(3, 0, "k", 70, keeps)
    with pytest.raises(KeyError):
        ts.get_sequence(3, 0, "k", 70, keeps, device=device)
    assert ts.controller.stats.totals == js.controller.stats.totals
    assert ts.controller.stats.kind_count("kv_read") == 2
    assert ts.counters == {k: v for k, v in js.counters.items() if k in ts.counters}
    want = js.get_sequence(3, 0, "k", 32, keeps).view(np.uint16)
    got = ts.get_sequence(3, 0, "k", 32, keeps, device=device)
    np.testing.assert_array_equal(got if device is None else _host(got), want)
    assert ts.controller.stats.totals == js.controller.stats.totals


def _pages(shape) -> int:
    """Pages of 16 tokens an encode call holds: its (..., tokens, channels)
    view's leading dims times the pages of its tokens."""
    return math.prod(shape[:-2]) * -(-shape[-2] // 16)


def test_serving_backend_encodes_each_span_once(monkeypatch):
    """The backend transforms every (layer, stream, page) of a written span
    in one encode call (``compressed_store._encode_groups``, the transform
    ``encode_kv`` runs too), and each re-activated page in one; the
    backend's own counts agree with the calls."""
    calls = []
    real = TS._encode_groups

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(TS, "_encode_groups", counting)
    spans = []
    real_span = backend_base.KVBackend._write_span

    def span(self, slot_id, t0, t1):
        before = len(calls)
        real_span(self, slot_id, t0, t1)
        # one call, holding every page of the span: stored layers x 2 streams
        assert len(calls) == before + 1
        assert _pages(calls[-1]) == self.stored_layers() * 2 * -(-(t1 - t0) // 16)
        spans.append((t0, t1))

    monkeypatch.setattr(backend_base.KVBackend, "_write_span", span)
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    sched = ContinuousScheduler(model, params, EngineConfig(
        max_batch=2, max_ctx=96, device_kv="bitplane", decode_kernel="fused",
        backend="paged", codec="lz4", max_stored_bytes=12 * 1024,
        ladder=PrecisionLadder([(1, 16), (-1, 8)])), device="cpu")
    rng = np.random.default_rng(0)
    for i, n in enumerate((37, 20, 50)):
        sched.submit(Request(rid=i, prompt=rng.integers(0, 512, n).astype(np.int32),
                             max_new_tokens=18))
    sched.run_until_drained()
    counts = sched.backend.page_encodes
    assert counts["write_spans"] == len(spans) > 0
    assert counts["reactivations"] > 0  # the budget evicted pages that came back
    assert len(calls) == counts["write_spans"] + counts["reactivations"]
    assert sum(_pages(shape) == 1 for shape in calls) >= counts["reactivations"]
