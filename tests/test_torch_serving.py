"""The PyTorch port's serving slice vs the JAX reference, on the CPU.

Both sides serve the smollm-135m smoke config with the reference's
``PRNGKey(0)`` weights (carried across bit-exactly) through the paged
backend, bit-plane device KV, the fused decode kernel (plain version here,
Pallas interpret mode in the reference), a mixed precision ladder and a
byte budget that forces evictions, over the same 6-request trace.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.compressed_store import StoreConfig as JStoreConfig
from repro.core.controller import MemoryController as JController
from repro.core.quantization import PrecisionLadder as JLadder
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.core.compressed_store import StoreConfig
from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import embed_apply
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.telemetry import TelemetryConfig

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

RUNGS = [(2, 16), (2, 8), (-1, 4)]
ENGINE_KW = dict(max_batch=4, max_ctx=128, device_kv="bitplane",
                 decode_kernel="fused", backend="paged", codec="lz4",
                 max_stored_bytes=40 * 1024)
PROMPT_LENS = [37, 80, 16, 55, 100, 23]
MAX_NEW = [12, 9, 20, 6, 10, 15]
COUNTERS = ("device_bytes_read", "kv_read_device_bytes", "decode_tokens",
            "prefill_tokens", "requests_completed", "kv_evictions")
COMPRESSED = ("kv_stored_bytes", "kv_logical_bytes", "kv_fetch_physical",
              "kv_fetch_logical", "kv_evicted_bytes", "kv_resident_stored_bytes")

# Teacher-forced logits tolerance.  Both sides run the same bf16 math with
# the same rounding points, but XLA's float32 exp differs from torch's in
# the last bit for about a tenth of inputs, and the attention sums run in
# another order, so a bf16 intermediate (a cached key, an attention output)
# can round one step differently; one bf16 step near |x| = 4 is 0.03.
LOGITS_ATOL = 5e-2


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("smollm-135m", smoke=True)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("smollm-135m", smoke=True))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, n).astype(np.int32) for n in PROMPT_LENS]


def _serve(sched, req_cls):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(_prompts(), MAX_NEW))]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    assert all(r.done for r in reqs)
    return sched, reqs


@pytest.fixture(scope="module")
def served(models):
    jm, jp, tm, tp = models
    jctl = JController(JStoreConfig(codec="lz4"), retain_events=True)
    tctl = MemoryController(StoreConfig(codec="lz4"), retain_events=True)
    j_sched, j_reqs = _serve(JScheduler(
        jm, jp, JEngineConfig(ladder=JLadder(RUNGS), **ENGINE_KW),
        controller=jctl), JRequest)
    t_sched, t_reqs = _serve(ContinuousScheduler(
        tm, tp, EngineConfig(ladder=PrecisionLadder(RUNGS), **ENGINE_KW),
        device="cpu", controller=tctl), Request)
    return j_sched, j_reqs, t_sched, t_reqs


def test_plain_forward_matches_reference(models):
    jm, jp, tm, tp = models
    toks = (np.arange(40, dtype=np.int32)[None] * 13) % 512
    pos = np.arange(40, dtype=np.int32)[None]
    xj, _, _ = JT.run_stack(jp, jm.cfg, JT.embed_apply(jp["embed"], jnp.asarray(toks)),
                            jnp.asarray(pos))
    xt = TT.run_stack(tp, tm.cfg, embed_apply(tp["embed"], torch.from_numpy(toks).long()),
                      torch.from_numpy(pos))
    np.testing.assert_array_equal(np.asarray(xj, np.float32), xt.float().numpy())


@pytest.mark.parametrize("kernel", ["fused", "rung"])
def test_teacher_forced_decode_logits(models, kernel):
    """Same cache, same tokens, same mixed plane map: one bit-plane decode
    step's logits agree within LOGITS_ATOL."""
    jm, jp, tm, tp = models
    b, s = 3, 128
    jc = JT.bitplane_cache_from_dense(jm.init_cache(b, s))
    tc = TT.bitplane_cache_from_dense(tm.init_cache(b, s, "cpu"))
    prompt = np.random.default_rng(5).integers(0, 512, 70).astype(np.int32)
    j_chunk = jax.jit(jm.prefill_chunk)
    for slot, n in ((0, 64), (2, 48)):
        tokens = prompt[None, :n]
        jc["len"] = jnp.int32(0)
        _, jc = j_chunk(jp, jnp.asarray(tokens), jc, jnp.int32(slot),
                        jnp.int32(0), jnp.int32(n - 1))
        _, tc = tm.prefill_chunk(tp, torch.from_numpy(tokens).long(), tc,
                                 slot, 0, n - 1)
    lens = np.array([64, 0, 48], np.int32)
    planes = np.full((b, s // 16), 16, np.int32)
    planes[0, :4] = [4, 8, 4, 16]
    planes[2, :3] = [8, 4, 4]
    keeps = (4, 8, 16)
    jc.update(len=jnp.asarray(lens), planes=jnp.asarray(planes))
    tc.update(len=torch.from_numpy(lens), planes=torch.from_numpy(planes))
    tok = np.array([7, 0, 300], np.int32)
    lj, _ = jax.jit(lambda p, t, c: jm.decode(p, t, c, keeps=keeps,
                                              decode_kernel=kernel))(
        jp, jnp.asarray(tok), jc)
    lt, _ = tm.decode(tp, torch.from_numpy(tok).long(), tc, keeps=keeps,
                      decode_kernel=kernel)
    rows = [0, 2]  # row 1 is an idle slot
    np.testing.assert_allclose(lt.numpy()[rows], np.asarray(lj)[rows],
                               atol=LOGITS_ATOL, rtol=0)


def test_greedy_tokens_equal(served):
    _, j_reqs, _, t_reqs = served
    for a, b in zip(j_reqs, t_reqs):
        assert b.output == a.output, f"request {a.rid}"
        assert len(b.output) == b.max_new_tokens


@pytest.mark.parametrize("key", COUNTERS)
def test_report_counters_equal(served, key):
    j_sched, _, t_sched, _ = served
    a, b = j_sched.report(), t_sched.report()
    assert b[key] == a[key]
    if key == "kv_evictions":
        assert b[key] > 0  # the budget really evicted


def test_device_bytes_are_the_controllers_plane_scaled_reads(served):
    _, _, t_sched, _ = served
    rep = t_sched.report()
    assert rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0
    assert rep["device_bytes_read"] < rep["kv_fetch_logical"]  # the ladder cut reads


@pytest.mark.parametrize("key", COMPRESSED)
def test_compressed_byte_counters_equal(served, key):
    """These depend on the last bit of every stored bf16 value."""
    j_sched, _, t_sched, _ = served
    je = j_sched.backend.controller.stats.events
    te = t_sched.backend.controller.stats.events
    for i, (a, b) in enumerate(zip(je, te)):
        fa = (a.kind, a.name, a.logical_bytes, a.physical_bytes, a.planes)
        fb = (b.kind, b.name, b.logical_bytes, b.physical_bytes, b.planes)
        assert fa == fb, f"first differing page event #{i}: reference {fa} port {fb}"
    assert len(te) == len(je)
    assert t_sched.report()[key] == j_sched.report()[key]


@pytest.mark.parametrize("ladder", [None, PrecisionLadder([(-1, 16)])],
                         ids=["no-ladder", "full-ladder"])
def test_bitplane_full_precision_is_lossless(models, ladder):
    """On the port alone: bit-plane device KV at 16 planes serves the same
    greedy tokens as the dense device layout."""
    _, _, tm, tp = models

    def run(device_kv, lad):
        kw = dict(ENGINE_KW, device_kv=device_kv, max_stored_bytes=None)
        _, reqs = _serve(ContinuousScheduler(
            tm, tp, EngineConfig(ladder=lad, **kw), device="cpu"), Request)
        return [r.output for r in reqs]

    assert run("bitplane", ladder) == run("dense", None)


def test_telemetry_attributes_every_device_byte(models):
    """The copied collector on the port's path: tokens unchanged, and the
    per-request device bytes sum to the report's device_bytes_read."""
    _, _, tm, tp = models
    kw = dict(ENGINE_KW, max_stored_bytes=None)
    cfg = EngineConfig(ladder=PrecisionLadder(RUNGS), **kw)
    plain, plain_reqs = _serve(ContinuousScheduler(tm, tp, cfg, device="cpu"), Request)
    traced, traced_reqs = _serve(ContinuousScheduler(
        tm, tp, dataclasses.replace(cfg, telemetry=TelemetryConfig()),
        device="cpu"), Request)
    assert [r.output for r in traced_reqs] == [r.output for r in plain_reqs]
    attr = traced.telemetry.attribution_report()
    assert attr["device_bytes_read"] == traced.report()["device_bytes_read"] > 0
    assert traced.report()["telemetry"]["spans_closed"] == len(PROMPT_LENS)
