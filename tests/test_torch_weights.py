"""The port's compressed weight streaming and telemetry exporters against
the JAX reference, on the CPU (the cases of ``tests/test_weight_stream.py``
on the paged backend, and the Perfetto and Prometheus exports of one
served trace).

The parameters are the reference's ``PRNGKey(0)`` smoke weights, carried
across bit for bit, so the weight store compresses the same bits on both
sides and its blobs must be equal.  Streaming is accounting through the
lane engine (compute keeps the resident weights), so tokens must not move.
The exports are compared without their wall-clock fields: the serving
process's timestamps and durations, ``ttft_wall_ns``, and the report's
``prefill_s``, ``decode_s`` and ``decode_tok_per_s`` (the fields
``tests/test_torch_serving.py`` leaves out too), and without the
reference's ``prefill_compiles``, which counts XLA compilations.
"""

import collections
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as j_get_config
from repro.core.compressed_store import StoreConfig as JStoreConfig
from repro.core.controller import MemoryController as JController
from repro.models.model import build_model as j_build_model
from repro.models.transformer import named_layer_tensors as j_named_layer_tensors
from repro.models.transformer import split_layer_params as j_split_layer_params
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.telemetry import TelemetryConfig as JTelemetryConfig
from repro.telemetry import build_trace_events as j_build_trace_events
from repro.telemetry import prometheus_snapshot as j_prometheus_snapshot
from repro.weights import CompressedWeightStore as JWeightStore

from repro_torch.configs import get_config
from repro_torch.core.bitplane import BF16
from repro_torch.core.compressed_store import StoreConfig, compress_weights
from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.core.surrogates import gaussian_weights
from repro_torch.memctl import (
    CompressionEngineRuntime,
    Job,
    JobClass,
    MemCtlConfig,
    PriorityJobQueue,
)
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (
    join_layer_params,
    named_layer_tensors,
    split_layer_params,
)
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.telemetry import (
    TelemetryConfig,
    build_trace_events,
    prometheus_snapshot,
    validate_trace,
    write_perfetto_trace,
)
from repro_torch.telemetry.perfetto import SCHED_PID
from repro_torch.weights import CompressedWeightStore, WeightStreamer

torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as C  # noqa: E402

ENGINE_KW = dict(max_batch=2, max_ctx=128, store_layers=2, backend="paged", codec="lz4")
# the streaming case: a lane window (256 cycles) far smaller than one
# weight pass, so weight jobs defer across windows and compute stalls
THRASH_KW = dict(ENGINE_KW, weight_stream="compressed",
                 engine=MemCtlConfig(step_cycles=256))
WALL_FIELDS = ("prefill_s", "decode_s", "decode_tok_per_s")


@pytest.fixture(scope="module")
def models():
    jm = j_build_model(j_get_config("smollm-135m", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("smollm-135m", smoke=True))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


def _serve(sched, req_cls, prompts, max_new=8):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=max_new) for i, p in enumerate(prompts)]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    assert all(r.done for r in reqs)
    sched.served = [r.output for r in reqs]
    return sched


def _port(models, prompts, controller=None, max_new=8, **kw):
    _, _, tm, tp = models
    return _serve(ContinuousScheduler(tm, tp, EngineConfig(**kw), device="cpu",
                                      controller=controller), Request, prompts, max_new)


def _reference(models, prompts, controller=None, max_new=8, **kw):
    jm, jp, _, _ = models
    return _serve(JScheduler(jm, jp, JEngineConfig(**kw), controller=controller), JRequest,
                  prompts, max_new)


THRASH_PROMPTS = [_prompt(21), _prompt(33, 5)]


@pytest.fixture(scope="module")
def thrash(models):
    """The tight-window streaming run, telemetry on, on both sides (each
    with an event-keeping controller)."""
    tctl = MemoryController(StoreConfig(codec="lz4"), retain_events=True)
    jctl = JController(JStoreConfig(codec="lz4"), retain_events=True)
    port = _port(models, THRASH_PROMPTS, tctl, telemetry=TelemetryConfig(), **THRASH_KW)
    ref = _reference(models, THRASH_PROMPTS, jctl, telemetry=JTelemetryConfig(), **THRASH_KW)
    return port, tctl, ref, jctl


# ---------------------------------------------------------------------------
# Layer handles
# ---------------------------------------------------------------------------


def test_split_join_layer_params_roundtrip(models):
    _, _, _, tp = models
    handles = split_layer_params(tp)
    assert len(handles) == 2  # smoke config
    # handles are views into the stacked tensors, not copies
    wq = tp["layers"]["attn"]["wq"]
    assert handles[1]["attn"]["wq"].data_ptr() == wq[1].data_ptr()
    rejoined = join_layer_params(handles)
    for (na, a), (nb, b) in zip(named_layer_tensors(rejoined),
                                named_layer_tensors(tp["layers"])):
        assert na == nb and torch.equal(a, b)


def test_layer_tensor_names_equal_the_reference(models):
    _, jp, _, tp = models
    want = [[name for name, _ in j_named_layer_tensors(h)] for h in j_split_layer_params(jp)]
    got = [[name for name, _ in named_layer_tensors(h)] for h in split_layer_params(tp)]
    assert got == want
    assert "attn/wq" in got[0]


# ---------------------------------------------------------------------------
# Store: blobs and bytes equal the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("part", [(0, 1), (0, 2), (1, 2)])
def test_store_blobs_equal_the_reference(models, part):
    _, jp, _, tp = models
    ctl = MemoryController(StoreConfig(codec="lz4"), retain_events=False)
    jctl = JController(JStoreConfig(codec="lz4"), retain_events=False)
    store = CompressedWeightStore.from_handles(split_layer_params(tp), ctl, part=part)
    ref = JWeightStore.from_handles(j_split_layer_params(jp), jctl, part=part)
    assert store.n_layers == ref.n_layers == 2
    for li in range(store.n_layers):
        got, want = store.layer(li).entries, ref.layer(li).entries
        assert [(e.key, e.valid_values, e.valid_logical_bytes, e.stored_bytes) for e in got] == \
            [(e.key, e.valid_values, e.valid_logical_bytes, e.stored_bytes) for e in want]
        for e in got:
            assert ctl.weight_tensor(e.key).segments == jctl.weight_tensor(e.key).segments
    assert store.exact_savings == ref.exact_savings
    assert ctl.footprint() == jctl.footprint()


def test_sharded_ingest_conserves_bytes(models):
    _, _, _, tp = models
    handles = split_layer_params(tp)
    full = CompressedWeightStore.from_handles(
        handles, MemoryController(StoreConfig(codec="lz4"), retain_events=False))
    parts = [CompressedWeightStore.from_handles(
        handles, MemoryController(StoreConfig(codec="lz4"), retain_events=False),
        part=(i, 2)) for i in range(2)]
    assert sum(p.valid_logical_bytes for p in parts) == full.valid_logical_bytes


def test_store_roundtrip_and_stripe_padding(models):
    _, _, _, tp = models
    handles = split_layer_params(tp)
    ctl = MemoryController(StoreConfig(codec="lz4"), retain_events=False)
    store = CompressedWeightStore.from_handles(handles, ctl)
    vps = ctl.config.values_per_segment
    for li, handle in enumerate(handles):
        peek = store.peek_layer(li)
        for name, leaf in named_layer_tensors(handle):
            # lossless, trimmed back to the valid element count (bf16 as
            # its raw bits)
            want = leaf.reshape(-1).view(torch.int16).numpy().view(np.uint16)
            assert np.array_equal(peek[name], want), name
        for e in store.layer(li).entries:
            ct = ctl.weight_tensor(e.key)
            assert ct.n_values % vps == 0
            assert ct.valid_values == e.valid_values <= ct.n_values
    fp = ctl.footprint()
    assert fp["weights_logical"] == store.valid_logical_bytes
    assert fp["weights_saving"] == pytest.approx(store.exact_savings)


def test_exact_savings_matches_table3_definition():
    """One savings definition: the store's equals ``compress_weights``'
    ``exact_savings`` on the same surrogate weights (stripe padding moves
    it only by the compressed zeros of the tail)."""
    w = gaussian_weights((256, 96), seed=3)
    cfg = StoreConfig(codec="lz4")
    offline = compress_weights(w, BF16, cfg)
    assert offline.exact_savings == pytest.approx(offline.savings)
    store = CompressedWeightStore(MemoryController(cfg, retain_events=False))
    store.ingest_layer({"w": torch.from_numpy(w.view(np.int16)).view(torch.bfloat16)})
    assert store.exact_savings == pytest.approx(offline.exact_savings, abs=0.02)


# ---------------------------------------------------------------------------
# Streamer
# ---------------------------------------------------------------------------


def test_weight_fetch_priority_tier():
    q = PriorityJobQueue()
    for klass in (JobClass.BACKGROUND, JobClass.KV_WRITE, JobClass.WEIGHT_FETCH,
                  JobClass.DECODE_FETCH):
        q.push(Job(klass, 8, fn=lambda: None))
    assert [q.pop().klass for _ in range(4)] == [
        JobClass.DECODE_FETCH, JobClass.WEIGHT_FETCH, JobClass.KV_WRITE, JobClass.BACKGROUND]


def _surrogate_store(n_layers=2, shape=(128, 96)):
    ctl = MemoryController(StoreConfig(codec="lz4"), retain_events=True)
    store = CompressedWeightStore(ctl)
    for li in range(n_layers):
        w = gaussian_weights(shape, seed=li)
        store.ingest_layer({"w": torch.from_numpy(w.view(np.int16)).view(torch.bfloat16)})
    return store, ctl


def test_streamer_double_buffers_one_pass_ahead():
    store, ctl = _surrogate_store()
    eng = CompressionEngineRuntime()
    ws = WeightStreamer(store, eng)
    for step in range(1, 4):
        ws.begin_pass()
        eng.tick()
        ws.window_close()
        rep = ws.report()
        assert rep["passes_consumed"] == step
        assert rep["passes_fetched"] == step + 1  # the next pass rides along
        assert rep["stall_steps"] == 0
    assert ctl.stats.kind_count("weight_read") == 4 * store.n_layers


def test_streamer_depth_zero_fetches_cold():
    store, _ = _surrogate_store()
    eng = CompressionEngineRuntime()
    ws = WeightStreamer(store, eng, prefetch_depth=0)
    ws.begin_pass()
    eng.tick()
    ws.window_close()
    rep = ws.report()
    assert rep["prefetch_depth"] == 0
    assert rep["passes_fetched"] == rep["passes_consumed"] == 1


def test_streamer_stalls_under_tight_budget():
    store, _ = _surrogate_store()
    eng = CompressionEngineRuntime(MemCtlConfig(step_cycles=8))
    ws = WeightStreamer(store, eng)
    ws.begin_pass()
    eng.tick()
    ns = ws.window_close()
    rep = ws.report()
    assert rep["stall_steps"] == 1 and rep["stall_layers"] >= 1
    assert ns > 0 and rep["stall_ns"] == pytest.approx(ns)


def test_weight_bytes_charged_once_per_layer_per_step_under_thrash(thrash):
    sched, ctl, _, _ = thrash
    w = sched.report()["weights"]
    # every layer charged the same number of passes, passes_fetched, and
    # passes_consumed <= passes_fetched <= passes_consumed + 1
    reads = collections.Counter(e.name for e in ctl.stats.events if e.kind == "weight_read")
    assert set(C.once_per_layer(reads, w).values()) == {w["passes_fetched"]}
    assert w["stall_steps"] > 0 and w["stall_ns"] > 0
    assert sched.backend.engine_time_ns() > sched.backend.engine.clock.elapsed_ns
    # the fetched logical bytes are whole passes of the store
    store = sched.backend.streamers[0].store
    assert w["read_logical_bytes"] == w["passes_fetched"] * store.valid_logical_bytes


def test_weights_report_equals_the_reference(thrash):
    sched, _, ref, _ = thrash
    assert sched.report()["weights"] == ref.report()["weights"]
    assert sched.served == ref.served


def test_weight_read_events_equal_the_reference(thrash):
    _, ctl, _, jctl = thrash

    def reads(c):
        return [(e.name, e.logical_bytes, e.physical_bytes, e.cycle)
                for e in c.stats.events if e.kind.startswith("weight")]

    assert reads(ctl) == reads(jctl)


def test_serving_weight_bandwidth_saving_ballpark(models):
    sched = _port(models, [_prompt(30)], weight_stream="compressed", **ENGINE_KW)
    w = sched.report()["weights"]
    assert 0.10 < w["bandwidth_saving"] < 0.45
    assert w["bandwidth_saving"] == pytest.approx(
        1 - w["read_physical_bytes"] / w["read_logical_bytes"])


def test_resident_mode_has_no_weight_traffic(models):
    ctl = MemoryController(StoreConfig(codec="lz4"), retain_events=True)
    sched = _port(models, [_prompt(25)], ctl, weight_stream="resident", **ENGINE_KW)
    assert ctl.stats.kind_count("weight_read") == 0
    assert ctl.stats.kind_count("weight_write") == 0
    assert sched.report()["weights"] == {"mode": "resident"}


def test_ladder_decode_streams_bit_identically(models):
    """Weight streaming composes with the ladder and the bit-plane device
    path: tokens and KV byte counters equal the resident run's."""
    kw = dict(ENGINE_KW, ladder=PrecisionLadder([(2, 16), (2, 8), (-1, 4)]),
              device_kv="bitplane")
    prompts = [_prompt(37), _prompt(52, 3)]
    resident = _port(models, prompts, max_new=6, weight_stream="resident", **kw)
    streamed = _port(models, prompts, max_new=6, weight_stream="compressed", **kw)
    assert resident.served == streamed.served
    a, b = resident.report(), streamed.report()
    for key in ("kv_fetch_physical", "device_bytes_read", "kv_stored_bytes"):
        assert a[key] == b[key], key


def test_weight_events_reach_telemetry_and_trace(thrash, tmp_path):
    sched = thrash[0]
    tel = sched.telemetry
    assert tel.counts["weight_fetches"] > 0
    assert tel.counts["weight_fetches"] == len(tel.weight_events)
    trace = write_perfetto_trace(tel, str(tmp_path / "trace.json"))
    weights = [e for e in trace["traceEvents"] if e.get("cat") == "weights"]
    assert len(weights) == tel.counts["weight_fetches"]
    assert all(e[3] >= 0 for e in tel.weight_events)
    summary = validate_trace(str(tmp_path / "trace.json"))
    assert summary["has_lane_track"] and summary["has_counters"]


# ---------------------------------------------------------------------------
# Exporters: the reference's output for the same served trace
# ---------------------------------------------------------------------------


def _engine_events(events):
    """Trace events without the serving process's wall-clock fields."""
    out = []
    for e in events:
        e = dict(e)
        if e["pid"] == SCHED_PID:
            e.pop("ts", None)
            e.pop("dur", None)
            if "args" in e:
                e["args"] = {k: v for k, v in e["args"].items() if k != "ttft_wall_ns"}
        out.append(e)
    return out


def test_perfetto_events_equal_the_reference(thrash):
    sched, _, ref, _ = thrash
    got = build_trace_events(sched.telemetry)
    want = j_build_trace_events(ref.telemetry)
    assert _engine_events(got) == _engine_events(want)
    assert any(e.get("cat") == "weights" for e in got)
    validate_trace({"traceEvents": got})


def _metric_lines(text):
    """Exposition lines without the wall-clock metrics (samples and their
    HELP/TYPE headers)."""
    wall = {f"repro_serving_{k}" for k in WALL_FIELDS + ("prefill_compiles",)}

    def name(line):
        return line.split(" ")[2] if line.startswith("#") else line.split(" ")[0].split("{")[0]

    return [line for line in text.splitlines()
            if name(line) not in wall and "_wall_" not in name(line)]


def test_prometheus_snapshot_equals_the_reference(thrash):
    sched, _, ref, _ = thrash
    got = prometheus_snapshot(sched.report())
    want = j_prometheus_snapshot(ref.report())
    assert _metric_lines(got) == _metric_lines(want)
    assert "repro_serving_decode_tokens_total" in got
