"""The port's shared-prefix pages and request traces against the JAX
reference, on the CPU (the cases of ``tests/test_prefix_sharing.py`` on the
paged backend).

Both sides serve the smollm-135m smoke config with the reference's
``PRNGKey(0)`` weights, carried across bit for bit.  Followers are
submitted after the donor wave drained, so the donor's prefix is
registered when they arrive.  Greedy tokens, ``report()["prefix"]``, the
store's page keys and, on the dense device layout, its footprint must
equal the reference's.  On the bit-plane layout the stored bytes of a page
can differ from the reference's by the compressed size of one bf16
rounding (XLA's float32 ``rsqrt`` and ``exp`` differ from torch's in the
last bit; ROADMAP §3), with sharing off as much as on, so there the port's
sharing-on run is held to its own sharing-off run.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.configs.base import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving import make_trace as j_make_trace
from repro.serving.kv_cache import CompressedKVStore as JStore
from repro.serving.kv_cache import PageKey as JPageKey
from repro.serving.kv_cache import page_chain_hashes as j_page_chain_hashes
from repro.serving.traces import RequestClass as JRequestClass
from repro.core.surrogates import logmag_kv_cache as j_logmag_kv_cache

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.core.surrogates import logmag_kv_cache
from repro_torch.memctl import MemCtlConfig
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import (
    DEFAULT_CLASSES,
    ContinuousScheduler,
    EngineConfig,
    Request,
    make_trace,
)
from repro_torch.serving.kv_cache import (
    PAGE_TOKENS,
    CompressedKVStore,
    PageKey,
    PrefixEntry,
    PrefixIndex,
    is_prefix_seq,
    page_chain_hashes,
    prefix_seq_id,
)
from repro_torch.serving.sampler import SamplerConfig
from repro_torch.serving.traces import RequestClass

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    jm = j_build_model(j_get_config("smollm-135m", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("smollm-135m", smoke=True))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


ENGINE_KW = dict(max_batch=4, max_ctx=192, backend="paged", store_layers=2,
                 codec="lz4")


def _cfg(sharing=True, **kw):
    return EngineConfig(prefix_sharing=sharing, **{**ENGINE_KW, **kw})


def _j_cfg(sharing=True, **kw):
    return JEngineConfig(prefix_sharing=sharing, **{**ENGINE_KW, **kw})


def _serve_waves(sched, req_cls, waves, max_new=8):
    """Submit wave 0, drain, submit wave 1, drain, ... so that followers
    always arrive after the donor wave's prefixes are registered."""
    reqs, rid = [], 0
    for wave in waves:
        batch = []
        for prompt, n_new in wave:
            r = req_cls(rid=rid, prompt=prompt, max_new_tokens=n_new or max_new)
            sched.submit(r)
            batch.append(r)
            rid += 1
        sched.run_until_drained()
        assert all(r.done for r in batch)
        reqs.extend(batch)
    return sched, reqs


def _port(models, cfg, waves, **kw):
    _, _, tm, tp = models
    return _serve_waves(ContinuousScheduler(tm, tp, cfg, device="cpu"), Request, waves, **kw)


def _reference(models, cfg, waves, **kw):
    jm, jp, _, _ = models
    return _serve_waves(JScheduler(jm, jp, cfg), JRequest, waves, **kw)


# a 4-page shared system prompt; followers append distinct tails
SHARED = _prompt(4 * PAGE_TOKENS, 7)


def _family_waves(tails=(3, 11, 29)):
    """Donor wave (shared prefix + tail 0), then followers with distinct
    tails, one of which diverges inside page 2."""
    donor = np.concatenate([SHARED, _prompt(9, 100)])
    diverge_mid = SHARED.copy()
    diverge_mid[2 * PAGE_TOKENS + 5] += 1
    followers = [np.concatenate([SHARED, _prompt(13, 200 + t)]) for t in tails]
    followers.append(np.concatenate([diverge_mid, _prompt(5, 400)]))
    return [[(donor, 0)], [(f, 0) for f in followers]]


@pytest.fixture(scope="module")
def family(models):
    """The family waves on the dense device layout: the reference with
    sharing on, the port with sharing on and off."""
    waves = _family_waves()
    return {
        "reference": _reference(models, _j_cfg(True), waves),
        "on": _port(models, _cfg(True), waves),
        "off": _port(models, _cfg(False), waves),
    }


def _outputs(run):
    return [r.output for r in run[1]]


# ---------------------------------------------------------------------------
# The served family against the reference
# ---------------------------------------------------------------------------


def test_sharing_on_matches_off_and_the_reference(family):
    assert _outputs(family["on"]) == _outputs(family["off"]) == _outputs(family["reference"])
    px = family["on"][0].report()["prefix"]
    assert px["enabled"] and px["requests_matched"] > 0, px
    assert px["bytes_deduplicated"] > 0
    assert family["off"][0].report()["prefix"] == {"enabled": False}


def test_prefix_report_equals_the_reference(family):
    assert family["on"][0].report()["prefix"] == family["reference"][0].report()["prefix"]


@pytest.mark.parametrize("key", ["prefill_tokens", "prefill_chunks", "prefill_chunks_skipped",
                                 "kv_logical_bytes", "kv_stored_bytes", "kv_fetch_logical",
                                 "kv_fetch_physical", "device_bytes_read",
                                 "kv_resident_stored_bytes"])
def test_report_counters_equal_the_reference(family, key):
    assert family["on"][0].report()[key] == family["reference"][0].report()[key]


def test_store_keys_and_footprint_equal_the_reference(family):
    """Content-addressed keys (``px:<hash>``) and the footprint's shared
    counters equal the reference's after the run."""
    t_store = family["on"][0].backend.store
    j_store = family["reference"][0].backend.store
    assert list(t_store._lru.items()) == list(j_store._lru.items())
    assert any(is_prefix_seq(kt[0]) for kt in t_store._lru)
    assert t_store.footprint() == j_store.footprint()


def test_prefix_report_shape(family):
    sched = family["on"][0]
    px = sched.report()["prefix"]
    for key in ("requests_matched", "tokens_matched", "pages_matched",
                "bytes_deduplicated", "prefill_chunks_skipped", "hit_ratio",
                "index_entries", "resident_shared_pages",
                "resident_shared_bytes", "bound_pages", "shared_evictions"):
        assert key in px, key
    assert 0.0 < px["hit_ratio"] < 1.0
    assert px["prefill_chunks_skipped"] == sched.stats["prefill_chunks_skipped"] > 0
    assert px["bound_pages"] == 0  # everything retired: all released
    # matched tokens were skipped, not recomputed
    off = family["off"][0].report()
    assert off["prefill_tokens"] - sched.report()["prefill_tokens"] == px["tokens_matched"]


def test_resident_shared_bytes_are_the_shared_pages_bytes(family):
    store = family["on"][0].backend.store
    px = family["on"][0].report()["prefix"]
    shared = [kt for kt in store._lru if is_prefix_seq(kt[0])]
    assert px["resident_shared_pages"] == len(shared) > 0
    assert px["resident_shared_bytes"] == sum(store._lru[kt] for kt in shared)


# ---------------------------------------------------------------------------
# Conformance cases on the port
# ---------------------------------------------------------------------------


def test_mid_page_divergence_never_matches(models):
    """A follower whose prompt differs inside page 0 shares nothing: the
    chain hash diverges at that page, so nothing matches and the request
    prefills cold (and decodes as with sharing off)."""
    donor = np.concatenate([SHARED, _prompt(9, 100)])
    poisoned = SHARED.copy()
    poisoned[3] += 1
    follower = np.concatenate([poisoned, _prompt(9, 100)])
    waves = [[(donor, 0)], [(follower, 0)]]
    sched, reqs = _port(models, _cfg(True), waves)
    assert sched.report()["prefix"]["requests_matched"] == 0
    _, off = _port(models, _cfg(False), waves)
    assert [r.output for r in reqs] == [r.output for r in off]


def test_bitplane_device_path_matches_with_sharing(models):
    """Adoption packs the snapshot into the bit-plane cache: tokens equal
    sharing off on the port and the reference's with sharing on, and the
    prefix report equals the reference's."""
    waves = _family_waves(tails=(3,))
    on_sched, on = _port(models, _cfg(True, device_kv="bitplane"), waves)
    _, off = _port(models, _cfg(False, device_kv="bitplane"), waves)
    j_sched, j_on = _reference(models, _j_cfg(True, device_kv="bitplane"), waves)
    assert [r.output for r in on] == [r.output for r in off] == [r.output for r in j_on]
    px = on_sched.report()["prefix"]
    assert px["requests_matched"] > 0
    assert px == j_sched.report()["prefix"]


def test_adopted_rows_equal_the_donor_snapshot(models):
    """A follower's slot rows [0, m) right after adoption equal the donor
    snapshot bit for bit, on both device layouts."""
    _, _, tm, tp = models
    donor = np.concatenate([SHARED, _prompt(9, 100)])
    follower = np.concatenate([SHARED, _prompt(13, 203)])
    for device_kv in ("dense", "bitplane"):
        sched = ContinuousScheduler(tm, tp, _cfg(True, device_kv=device_kv), device="cpu")
        sched.submit(Request(rid=0, prompt=donor, max_new_tokens=4))
        sched.run_until_drained()
        backend = sched.backend
        (entry,) = backend.prefix._entries.values()
        assert entry.k.shape == (tm.cfg.n_layers, len(SHARED), tm.cfg.n_kv_heads * tm.cfg.head_dim)
        sched.submit(Request(rid=1, prompt=follower, max_new_tokens=4))
        sched._admit_tick()
        slot = next(i for i, s in enumerate(sched._slots) if s is not None)
        m = backend.match_prefix(slot, follower)
        assert m == len(SHARED)
        got = backend.slot_kv_bits(slot, 0, m, layers=slice(None))
        assert torch.equal(got[:, 0], entry.k[:, :m])
        assert torch.equal(got[:, 1], entry.v[:, :m])


@pytest.mark.parametrize("followers", [1, 3])
def test_stored_bytes_independent_of_holder_count(models, followers):
    """N requests sharing a prefix leave the bytes one copy of it occupies
    (the followers bind refcounts, they never store it again); the count
    equals the reference's one-follower run."""
    def shared_bytes(sched):
        st = sched.backend.store
        return sum(st._lru[kt] for kt in st._lru if is_prefix_seq(kt[0]))

    waves = [[(np.concatenate([SHARED, _prompt(9, 100)]), 0)],
             [(np.concatenate([SHARED, _prompt(13, 200 + i)]), 0)
              for i in range(followers)]]
    sched, _ = _port(models, _cfg(True), waves)
    assert sched.report()["prefix"]["requests_matched"] >= 1
    one_follower = [waves[0], waves[1][:1]]
    j_sched, _ = _reference(models, _j_cfg(True), one_follower)
    assert shared_bytes(sched) == shared_bytes(j_sched) > 0


def test_eviction_thrash_kv_write_accounting_with_sharing(models):
    """Exactly once under sharing: every kv_write is one serviced KV_WRITE
    job or one serviced re-activation, while a tight budget thrashes pages
    around bound prefixes."""
    cfg = _cfg(True, ladder=PrecisionLadder([(2, 16), (2, 8), (-1, 4)]),
               max_stored_bytes=10 * 1024,
               engine=MemCtlConfig(lanes=2, step_cycles=512))
    waves = [[(np.concatenate([SHARED, _prompt(9, 100)]), 16)],
             [(np.concatenate([SHARED, _prompt(13, 211)]), 16),
              (np.concatenate([SHARED, _prompt(13, 222)]), 16)]]
    sched, _ = _port(models, cfg, waves)
    rep = sched.report()
    assert rep["kv_evictions"] > 0
    tier = sched.backend.tiers[0]
    n_writes = tier.controller.stats.kind_count("kv_write")
    assert n_writes == tier.engine.stats.serviced_jobs["KV_WRITE"] + rep["kv_reactivations"]


def test_prefix_joined_request_keeps_cold_sampling_stream(models):
    """A matched request skips prefill chunks but draws from the same
    per-request stream as a cold run, at temperature > 0 where any shift
    of the stream changes tokens.  The port's streams are its own (torch
    generators), so the port's sharing-on run is held to its cold run."""
    sampler = SamplerConfig(temperature=0.8, top_k=8)
    waves = _family_waves(tails=(3, 11))
    on_sched, on = _port(models, _cfg(True, sampler=sampler), waves)
    _, off = _port(models, _cfg(False, sampler=sampler), waves)
    assert on_sched.report()["prefix"]["requests_matched"] > 0
    assert [r.output for r in on] == [r.output for r in off]


def test_explicit_rng_seed_survives_prefix_join(models):
    _, _, tm, tp = models
    sampler = SamplerConfig(temperature=1.1)
    donor = np.concatenate([SHARED, _prompt(9, 100)])
    probe = np.concatenate([SHARED, _prompt(13, 203)])

    def run(sharing):
        sched = ContinuousScheduler(tm, tp, _cfg(sharing, sampler=sampler), device="cpu")
        sched.submit(Request(rid=0, prompt=donor, max_new_tokens=6))
        sched.run_until_drained()
        p = Request(rid=1, prompt=probe, max_new_tokens=10)
        sched.submit(p, rng_seed=1234)
        sched.run_until_drained()
        return sched, p.output

    sched_on, out_on = run(True)
    _, out_off = run(False)
    assert sched_on.report()["prefix"]["requests_matched"] == 1
    assert out_on == out_off


def test_prefix_sharing_rejects_padded_prefill(models):
    _, _, tm, tp = models
    with pytest.raises(ValueError, match="padded"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=192, prefix_sharing=True,
                                                 prefill_mode="padded"), device="cpu")


# ---------------------------------------------------------------------------
# Keys, refcounts and eviction order (store level)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,offset", [(0, 0), (15, 0), (16, 3), (100, 7), (513, 11)])
def test_page_chain_hashes_equal_the_reference(n, offset):
    tokens = _prompt(n, offset)
    hashes = page_chain_hashes(tokens)
    assert hashes == j_page_chain_hashes(tokens)
    assert len(hashes) == n // PAGE_TOKENS
    if hashes:
        assert prefix_seq_id(hashes[0]) == "px:" + hashes[0]


def _page(seed):
    return logmag_kv_cache(PAGE_TOKENS, 8, seed=seed)


def test_bound_pages_are_immune_to_eviction_and_drop():
    store = CompressedKVStore(max_stored_bytes=None)
    px = PageKey(prefix_seq_id("aa"), 0, 0)
    store.put_page(px, _page(0))
    store.retain_page(px)
    assert store.page_refcount(px) == 1
    store.max_stored_bytes = 3 * store.page_stored_bytes(px)
    for i in range(6):
        store.put_page(PageKey(1, 0, i), _page(i + 1))
    assert store.page_stored_bytes(px) > 0  # a bound page is never evicted
    assert store.footprint()["shared_evictions"] == 0
    assert store.footprint()["bound_pages"] == 1
    assert not store.drop_page(px)  # refused while bound
    assert store.release_page(px) == 0
    assert store.drop_page(px)
    assert store.sequence_pages(px.seq_id) == []


def test_unshared_pages_evicted_before_refcount_zero_shared():
    """Request-keyed pages go first at any temperature; a refcount-0
    shared page goes only once they are gone.  Stored bytes and footprints
    equal the reference store's fed the same surrogate pages."""
    def run(store_cls, key_cls, page):
        store = store_cls(max_stored_bytes=None)
        px = key_cls(prefix_seq_id("bb"), 0, 0)
        store.put_page(px, page(0))
        store.put_page(key_cls(1, 0, 0), page(1))
        per = store.page_stored_bytes(px)
        store.max_stored_bytes = 2 * per + per // 2
        store.put_page(key_cls(1, 0, 1), page(2))
        first = (store.page_stored_bytes(key_cls(1, 0, 0)), store.page_stored_bytes(px),
                 store.footprint()["shared_evictions"])
        store.max_stored_bytes = per + per // 2
        store.put_page(key_cls(1, 0, 2), page(3))
        return first, store.page_stored_bytes(px), store.footprint()

    first, shared_after, fp = run(CompressedKVStore, PageKey, _page)
    assert first[0] == 0 and first[1] > 0 and first[2] == 0
    assert shared_after == 0 and fp["shared_evictions"] == 1
    assert run(JStore, JPageKey, lambda seed: j_logmag_kv_cache(PAGE_TOKENS, 8, seed=seed)) \
        == (first, shared_after, fp)


def test_prefix_index_collision_fails_closed():
    idx = PrefixIndex()
    toks = _prompt(2 * PAGE_TOKENS)
    hashes = page_chain_hashes(toks)
    idx.register(PrefixEntry(tokens=toks, hashes=hashes, r0_token=0, k=None, v=None))
    probe = toks.copy()
    probe[5] += 1
    m, entry = idx.match(probe, hashes, 2)  # forged hashes, other tokens
    assert m == 0 and entry is None
    assert idx.match(toks, hashes, 2)[0] == 2


def test_prefix_index_lru_capacity():
    idx = PrefixIndex(max_entries=2)
    for i in range(3):
        toks = _prompt(PAGE_TOKENS, 50 * i)
        assert idx.register(PrefixEntry(tokens=toks, hashes=page_chain_hashes(toks),
                                        r0_token=0, k=None, v=None))
    assert len(idx) == 2
    assert not idx.has_page(page_chain_hashes(_prompt(PAGE_TOKENS, 0))[0])


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


def _items(trace):
    return [(t.arrival_step, t.klass, t.request.rid, t.request.prompt.tolist(),
             t.request.max_new_tokens) for t in trace]


@pytest.mark.parametrize("kind", ["poisson", "diurnal", "bursty"])
@pytest.mark.parametrize("seed,max_ctx", [(0, None), (3, 192), (7, 1024)])
def test_make_trace_equals_the_reference(kind, seed, max_ctx):
    got = make_trace(32, kind=kind, rate=0.5, seed=seed, max_ctx=max_ctx)
    want = j_make_trace(32, kind=kind, rate=0.5, seed=seed, max_ctx=max_ctx)
    assert _items(got) == _items(want)
    assert all(isinstance(t.request, Request) for t in got)


def test_make_trace_with_custom_classes_equals_the_reference():
    """The deployment-sized mix chip_smoke.py serves (SmolLM-135M,
    max_ctx 1024)."""
    spec = [("chat", 384, (16, 96), (16, 48), 0.6), ("agentic", 256, (16, 64), (24, 64), 0.2),
            ("longdoc", 0, (300, 600), (8, 32), 0.2)]
    got = make_trace(32, kind="poisson", rate=0.5, seed=0, max_ctx=1024,
                     classes=[RequestClass(*c) for c in spec])
    want = j_make_trace(32, kind="poisson", rate=0.5, seed=0, max_ctx=1024,
                        classes=[JRequestClass(*c) for c in spec])
    assert _items(got) == _items(want)


def test_traces_deterministic_and_classed():
    a = make_trace(32, kind="poisson", rate=0.5, seed=3)
    chat = [t for t in a if t.klass == "chat"]
    assert len(chat) >= 2
    npage = dict((c.name, c.shared_prefix) for c in DEFAULT_CLASSES)["chat"]
    assert npage % PAGE_TOKENS == 0
    p0 = chat[0].request.prompt[:npage]
    assert all(np.array_equal(t.request.prompt[:npage], p0) for t in chat)
    c = make_trace(32, kind="poisson", rate=0.5, seed=4)
    assert not np.array_equal([t for t in c if t.klass == "chat"][0].request.prompt[:npage], p0)
    for kind in ("poisson", "diurnal", "bursty"):
        tr = make_trace(16, kind=kind, rate=0.5, seed=1, max_ctx=192)
        steps = [t.arrival_step for t in tr]
        assert steps == sorted(steps)
        assert all(len(t.request.prompt) + t.request.max_new_tokens <= 192 for t in tr)
    with pytest.raises(ValueError, match="kind"):
        make_trace(4, kind="flash-crowd")


def test_classes_are_the_reference_defaults():
    from repro.serving import DEFAULT_CLASSES as J_DEFAULT_CLASSES

    assert [dataclasses.astuple(c) for c in DEFAULT_CLASSES] == \
        [dataclasses.astuple(c) for c in J_DEFAULT_CLASSES]
