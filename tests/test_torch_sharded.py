"""The port's sharded backend against the JAX reference, on the CPU: the
``("sharded", 1)`` and ``("sharded", 2)`` cases of
``tests/test_kv_backend.py``, the sharded case of
``tests/test_prefix_sharing.py``, and the owner rule against the
reference's ``cache_pspecs`` on an abstract mesh.

Both sides serve the smollm-135m smoke config (2 kv heads of 16) with the
reference's ``PRNGKey(0)`` weights, carried across bit for bit, on the
dense device layout and an lz4 store: 2 shards split each page's channels
(the head route), 3 shards own whole pages block-cyclically (the sequence
route).  Greedy tokens, every integer counter of ``report()``, each shard's
report and each shard's stored blobs must equal the reference's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as j_get_config
from repro.core.quantization import PrecisionLadder as JLadder
from repro.memctl import MemCtlConfig as JMemCtlConfig
from repro.models.model import build_model as j_build_model
from repro.runtime.sharding import abstract_mesh, cache_pspecs
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.memctl import Job, JobClass, MemCtlConfig, PriorityJobQueue
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.serving.backends import BACKENDS, make_backend
from repro_torch.serving.backends.sharded import kv_cache_owner
from repro_torch.serving.kv_cache import PAGE_TOKENS, is_prefix_seq

torch.set_num_threads(1)

UNTIMED = {"prefill_s", "decode_s", "decode_tok_per_s", "prefill_compiles"}
LADDER = [(2, 16), (2, 8), (-1, 4)]
SHARDS = [1, 2]


@pytest.fixture(scope="module")
def models():
    jm = j_build_model(j_get_config("smollm-135m", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("smollm-135m", smoke=True))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


def _kw(backend="sharded", shards=2, **kw):
    base = dict(max_batch=4, max_ctx=192, backend=backend, shards=shards, store_layers=2,
                codec="lz4")
    return {**base, **kw}


def _j_kw(kw):
    out = dict(kw)
    if out.get("ladder") is not None:
        out["ladder"] = JLadder(list(out["ladder"].rungs))
    if "engine" in out:
        out["engine"] = JMemCtlConfig(lanes=out["engine"].lanes,
                                      step_cycles=out["engine"].step_cycles)
    return out


def _serve(models, kw, waves, max_new, side):
    jm, jp, tm, tp = models
    if side == "port":
        sched, req = ContinuousScheduler(tm, tp, EngineConfig(**kw), device="cpu"), Request
    else:
        sched, req = JScheduler(jm, jp, JEngineConfig(**_j_kw(kw))), JRequest
    reqs = []
    for wave in waves:
        batch = [req(rid=len(reqs) + i, prompt=p, max_new_tokens=max_new)
                 for i, p in enumerate(wave)]
        for r in batch:
            sched.submit(r)
        sched.run_until_drained()
        assert all(r.done for r in batch)
        reqs.extend(batch)
    return sched, reqs


def _both(models, kw, waves, max_new):
    return (_serve(models, kw, waves, max_new, "port"),
            _serve(models, kw, waves, max_new, "reference"))


def _counters(report):
    return {k: v for k, v in report.items()
            if isinstance(v, int) and not isinstance(v, bool) and k not in UNTIMED}


def _assert_same(port, ref):
    """Tokens, integer counters, the per-shard reports and the stores'
    pages (keys and stored sizes) equal the reference's."""
    assert [r.output for r in port[1]] == [r.output for r in ref[1]]
    rp, rr = port[0].report(), ref[0].report()
    assert _counters(rp) == _counters(rr)
    assert rp["shard_route"] == rr["shard_route"]
    assert rp["shards"] == rr["shards"]
    for tt, tj in zip(port[0].backend.tiers, ref[0].backend.tiers):
        assert list(tt.store._lru.items()) == list(tj.store._lru.items())
        assert tt.store.footprint() == tj.store.footprint()


# ---------------------------------------------------------------------------
# test_kv_backend.py: sharded cases
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=[(n, kv) for n in SHARDS for kv in ("dense", "bitplane")])
def served(request, models):
    """:95 (and :430 on the bit-plane layout): two prompts under the mixed
    ladder."""
    shards, device_kv = request.param
    kw = _kw(shards=shards, ladder=PrecisionLadder(LADDER), device_kv=device_kv)
    return request.param, _both(models, kw, [[_prompt(37), _prompt(80, 11)]], 6)


def test_sharded_decodes_match_the_reference(served):
    _assert_same(*served[1])


def test_sharded_one_is_bit_exact_with_paged(models):
    """:116: shards=1 equals the paged tier, tokens and byte accounting,
    under a byte budget that evicts; and both equal the reference's."""
    waves = [[_prompt(24), _prompt(90, 3), _prompt(50, 7)]]
    # the reference's case as it stands: the default codec
    kw = dict(ladder=PrecisionLadder(LADDER), max_stored_bytes=48 * 1024, codec=None)
    sharded = _serve(models, _kw(shards=1, **kw), waves, 8, "port")
    paged = _serve(models, _kw("paged", 1, **kw), waves, 8, "port")
    assert [r.output for r in sharded[1]] == [r.output for r in paged[1]]
    rs, rp = sharded[0].report(), paged[0].report()
    for key in ("kv_logical_bytes", "kv_stored_bytes", "kv_fetch_logical",
                "kv_fetch_physical", "kv_evictions", "kv_evicted_bytes",
                "kv_reactivations", "kv_fetch_misses", "kv_fetch_deferrals",
                "engine_jobs_cancelled", "kv_peak_stored_bytes"):
        assert rs[key] == rp[key], key
    _assert_same(sharded, _serve(models, _kw(shards=1, **kw), waves, 8, "reference"))


@pytest.mark.parametrize("shards", SHARDS + [3])
def test_pad_free_savings_invariant(models, shards):
    """:146: logical bytes count real tokens only, and a sharded tier's
    channel slices (or owned pages) sum back to the whole pages."""
    _, _, tm, tp = models
    n = 37
    sched = ContinuousScheduler(tm, tp, EngineConfig(**_kw(shards=shards)), device="cpu")
    sched.submit(Request(rid=0, prompt=_prompt(n), max_new_tokens=8))
    sched.step()
    per_tok = 2 * tm.cfg.n_kv_heads * tm.cfg.head_dim * 2
    logical = sum(t.store.footprint()["logical_bytes"] for t in sched.backend.tiers)
    assert logical == 2 * n * per_tok


@pytest.mark.parametrize("shards", SHARDS)
def test_eviction_reactivation_charged_exactly_once(models, shards):
    """:163: every kv_write on every tier is one serviced write or one
    re-activation; tokens and counters as the reference's."""
    kw = _kw(shards=shards, ladder=PrecisionLadder(LADDER), max_stored_bytes=10 * 1024,
             engine=MemCtlConfig(lanes=2, step_cycles=512), weight_stream="resident")
    port, ref = _both(models, kw, [[_prompt(80), _prompt(80, 3)]], 16)
    rep = port[0].report()
    assert rep["kv_evictions"] > 0 and rep["kv_reactivations"] > 0
    tiers = port[0].backend.tiers
    n_writes = sum(t.controller.stats.kind_count("kv_write") for t in tiers)
    serviced = sum(t.engine.stats.serviced_jobs["KV_WRITE"] for t in tiers)
    assert n_writes == serviced + rep["kv_reactivations"]
    _assert_same(port, ref)


def test_make_backend_knows_every_backend(models):
    _, _, tm, tp = models
    assert set(BACKENDS) == {"paged", "sharded", "ring"}
    with pytest.raises(ValueError, match="unknown KV backend"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64, backend="nvme"), device="cpu")


def test_sharded_routes_follow_mesh_rules(models):
    """:219: Hkv = 2 divides 2 shards -> head route (channel slices); 3
    shards fall back to the sequence axis; a count dividing neither is
    refused."""
    _, _, tm, _ = models
    head = make_backend(tm, EngineConfig(**_kw(shards=2)), "cpu")
    assert head._route == "head" and len(head.tiers) == 2
    assert head._cols == [slice(0, 16), slice(16, 32)]
    assert make_backend(tm, EngineConfig(**_kw(shards=3)), "cpu")._route == "seq"
    with pytest.raises(ValueError, match="divides neither"):
        make_backend(tm, EngineConfig(**_kw(shards=7, max_ctx=100)), "cpu")


@pytest.mark.parametrize("hkv,max_ctx,shards", [
    (2, 192, 1), (2, 192, 2), (2, 192, 3), (2, 112, 7), (3, 1024, 3),
    (3, 1024, 2), (8, 8192, 4), (8, 4096, 16), (1, 96, 2), (4, 100, 3),
])
def test_owner_rule_equals_the_reference_cache_pspecs(hkv, max_ctx, shards):
    """The port's owner rule against the reference's ``cache_pspecs`` on an
    abstract (1, shards) ('data', 'model') mesh, for the k, v and ring pos
    leaves of a decode cache."""
    cfg = dataclasses.replace(j_get_config("smollm-135m", smoke=True), n_kv_heads=hkv,
                              n_heads=hkv)
    shape = (2, 4, max_ctx, hkv, 16)
    tree = {"k": jax.ShapeDtypeStruct(shape, np.float32),
            "v": jax.ShapeDtypeStruct(shape, np.float32),
            "pos": jax.ShapeDtypeStruct(shape[:3], np.int32),
            "len": jax.ShapeDtypeStruct((), np.int32)}
    specs = cache_pspecs(cfg, tree, abstract_mesh((1, shards), ("data", "model")))
    kspec = tuple(specs["k"]) + (None,) * (5 - len(tuple(specs["k"])))
    want = "head" if kspec[3] == "model" else "seq" if kspec[2] == "model" else "replicate"
    assert kv_cache_owner(shape, shards) == want
    assert tuple(specs["v"]) == tuple(specs["k"])
    pspec = tuple(specs["pos"]) + (None,) * (3 - len(tuple(specs["pos"])))
    assert (pspec[2] == "model") == (want == "seq")


def test_queue_cancellation_is_shard_scoped():
    """:234"""
    q = PriorityJobQueue()
    q.push(Job(JobClass.KV_WRITE, 64, key=("p", 0), seq_id=(0, 7)))
    q.push(Job(JobClass.KV_WRITE, 64, key=("p", 1), seq_id=(1, 7)))
    q.push(Job(JobClass.BACKGROUND, 64, key=("e", 0), seq_id=None))
    assert q.cancel_seq((0, 7)) == 1
    assert q.pending(("p", 1), JobClass.KV_WRITE)
    assert q.pending(("e", 0), JobClass.BACKGROUND)
    assert q.cancel_seq(7) == 0


def test_sharded_retire_cancels_on_every_shard_without_crosstalk(models):
    """:248: a retiring request's jobs are cancelled on every shard, another
    request's survive on every shard."""
    _, _, tm, tp = models
    cfg = EngineConfig(**_kw(shards=2, engine=MemCtlConfig(lanes=1, step_cycles=16)))
    sched = ContinuousScheduler(tm, tp, cfg, device="cpu")
    a = Request(rid=0, prompt=_prompt(40), max_new_tokens=2)
    b = Request(rid=1, prompt=_prompt(40, 5), max_new_tokens=30)
    sched.submit(a)
    sched.submit(b)
    while not a.done:
        sched.step()
    for tier in sched.backend.tiers:
        for q in tier.engine.queue._queues.values():
            assert all(job.seq_id in (None, (tier.index, 1)) for job in q)
    assert sched.stats["engine_jobs_cancelled"] > 0
    sched.run_until_drained()
    assert b.done


@pytest.mark.parametrize("shards", SHARDS)
def test_weight_stream_tokens_bit_identical(models, shards):
    """:692: streamed weights leave tokens and KV accounting alone on every
    tier topology, and the weights report equals the reference's."""
    waves = [[_prompt(37), _prompt(64, 9)]]
    res = {mode: _serve(models, _kw(shards=shards, weight_stream=mode), waves, 8, "port")
           for mode in ("resident", "compressed")}
    assert ([r.output for r in res["resident"][1]]
            == [r.output for r in res["compressed"][1]])
    rr, rc = res["resident"][0].report(), res["compressed"][0].report()
    for key in ("kv_logical_bytes", "kv_stored_bytes", "kv_fetch_logical", "kv_fetch_physical"):
        assert rr[key] == rc[key], key
    assert rc["engine"]["serviced_bytes"]["WEIGHT_FETCH"] > 0
    ref = _serve(models, _kw(shards=shards, weight_stream="compressed"), waves, 8, "reference")
    assert rc["weights"] == ref[0].report()["weights"]


def test_sharded_ingest_conserves_bytes(models):
    """Through the backend: two shards' weight stores hold the one-shard
    store's logical and stored bytes between them, each part as the
    reference's."""
    waves = [[_prompt(20)]]
    one = _serve(models, _kw(shards=1, weight_stream="compressed"), waves, 2, "port")
    two = _serve(models, _kw(shards=2, weight_stream="compressed"), waves, 2, "port")
    ref = _serve(models, _kw(shards=2, weight_stream="compressed"), waves, 2, "reference")
    w1, w2 = one[0].report()["weights"], two[0].report()["weights"]
    assert w1["logical_bytes"] == w2["logical_bytes"] > 0
    parts = [ws.store.valid_logical_bytes for ws in two[0].backend.streamers]
    assert sum(parts) == one[0].backend.streamers[0].store.valid_logical_bytes
    assert parts == [ws.store.valid_logical_bytes for ws in ref[0].backend.streamers]


# ---------------------------------------------------------------------------
# test_prefix_sharing.py: the sharded case
# ---------------------------------------------------------------------------

SHARED = _prompt(4 * PAGE_TOKENS, 7)


def test_stored_bytes_independent_of_holder_count(models):
    """:207 ("sharded", 2): one follower or three leave the same shared
    bytes on the shards, one copy of the prefix; as the reference."""

    def shared_bytes(n_followers, side):
        waves = [[np.concatenate([SHARED, _prompt(9, 100)])],
                 [np.concatenate([SHARED, _prompt(13, 200 + i)]) for i in range(n_followers)]]
        sched, _ = _serve(models, _kw(prefix_sharing=True), waves, 8, side)
        assert sched.report()["prefix"]["requests_matched"] >= 1
        return [sum(st._lru[kt] for kt in st._lru if is_prefix_seq(kt[0]))
                for st in (tier.store for tier in sched.backend.tiers)]

    one, three = shared_bytes(1, "port"), shared_bytes(3, "port")
    assert one == three and sum(one) > 0
    assert one == shared_bytes(1, "reference")


@pytest.mark.parametrize("shards", [2, 3])
def test_sharded_sharing_matches_the_reference(models, shards):
    """Sharing on through both routes: tokens equal sharing off, and the
    prefix report, counters and shards' pages equal the reference's."""
    waves = [[np.concatenate([SHARED, _prompt(9, 100)])],
             [np.concatenate([SHARED, _prompt(13, 200)]),
              np.concatenate([SHARED, _prompt(5, 400)])]]
    on, ref = _both(models, _kw(shards=shards, prefix_sharing=True), waves, 8)
    off = _serve(models, _kw(shards=shards), waves, 8, "port")
    assert [r.output for r in on[1]] == [r.output for r in off[1]]
    assert on[0].report()["prefix"] == ref[0].report()["prefix"]
    assert on[0].report()["prefix"]["requests_matched"] > 0
    _assert_same(on, ref)


@pytest.mark.parametrize("shards", [2, 3])
def test_per_shard_bytes_sum_to_the_paged_run(models, shards):
    """Each shard's KV bytes, summed, equal the paged tier's on the same
    trace (a head route splits every page's channels; a sequence route
    deals whole pages), and the tokens are the paged run's."""
    waves = [[_prompt(37), _prompt(80, 11), _prompt(130, 5)]]
    sharded = _serve(models, _kw(shards=shards), waves, 10, "port")
    paged = _serve(models, _kw("paged", 1), waves, 10, "port")
    assert [r.output for r in sharded[1]] == [r.output for r in paged[1]]
    rs, rp = sharded[0].report(), paged[0].report()
    assert sum(s["kv_logical_bytes"] for s in rs["shards"]) == rp["kv_logical_bytes"]
    assert rs["kv_logical_bytes"] == rp["kv_logical_bytes"]
    if shards == 3:  # whole pages: the compressed bytes too
        assert sum(s["kv_stored_bytes"] for s in rs["shards"]) == rp["kv_stored_bytes"]
