"""The rest of serving in the port against the JAX reference, on the CPU:
staged decode caches (``decode_staging`` > 0), the legacy padded admission
(``prefill_mode="padded"``) and the temperature sampler's distribution.

Both sides run the reference's ``PRNGKey(0)`` weights, carried across bit
for bit (``models.convert``).  Staged decode merges two attention partials
where the plain path sums once, so its logits part from the plain cache's
by float32 rounding: held at the reference's own bound (0.08), and greedy
tokens equal on the served traces, as the reference's staging tests hold
them.  Padded admission holds greedy tokens and every integer counter of
``report()`` equal to the reference's.
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
from repro.models.model import prepare_decode_cache as j_prepare
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest
from repro.serving.sampler import SamplerConfig as JSamplerConfig

from repro_torch.configs import get_config
from repro_torch.core.compressed_store import StoreConfig
from repro_torch.core.controller import MemoryController
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.model import prepare_decode_cache
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.serving.backends import make_backend
from repro_torch.serving.sampler import SamplerConfig, sample, token_probs

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

RUNGS = [(2, 16), (2, 8), (-1, 4)]
# the reference's staged-logits bound (tests/test_models.py): the two
# summation orders differ in the last float32 bits, and one bf16 step of a
# logit near 8 is 0.06
STAGED_LOGITS_ATOL = 0.08
UNTIMED = {"prefill_s", "decode_s", "decode_tok_per_s"}


def _pair(arch: str, **change):
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **change)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_config(arch, smoke=True), **change))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def smollm():
    return _pair("smollm-135m")


def _counters(rep: dict) -> dict:
    return {k: v for k, v in rep.items() if isinstance(v, (int, float))
            and not isinstance(v, bool) and k not in UNTIMED}


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


def _serve(sched, req_cls, prompts, max_new):
    reqs = [req_cls(rid=i, prompt=p, max_new_tokens=n)
            for i, (p, n) in enumerate(zip(prompts, max_new))]
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    assert all(r.done for r in reqs)
    return sched, reqs


# ---------------------------------------------------------------------------
# Staged decode caches
# ---------------------------------------------------------------------------


def test_staged_decode_cache_matches_plain():
    """The reference's ``test_staged_decode_cache_matches_plain`` on the
    port: a read-only main cache plus an 8-slot staging ring decodes as the
    plain append cache does across a flush, and both of the port's caches
    follow the reference's staged logits (Yi-34B SMOKE, padded heads)."""
    jm, jp, tm, tp = _pair("yi-34b")
    staged = dataclasses.replace(tm.cfg, decode_staging=8)
    t1 = build_model(staged)
    j1 = j_build_model(dataclasses.replace(jm.cfg, decode_staging=8))
    prompt = np.random.default_rng(0).integers(0, tm.cfg.vocab, (2, 40)).astype(np.int32)

    logits, cache = tm.prefill(tp, {"tokens": torch.from_numpy(prompt)})
    c0 = prepare_decode_cache(tm.cfg, cache, 64)
    c1 = prepare_decode_cache(staged, {k: v.clone() for k, v in cache.items()}, 64)
    assert "sk" in c1 and c1["sk"].shape[2] == 8
    jl, jcache = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(prompt)})
    jc = j_prepare(j1.cfg, jcache, 64)
    tok = torch.argmax(logits, -1)
    jdec = jax.jit(j1.decode)
    jflush = jax.jit(lambda c: JT.flush_staging(c, j1.cfg))
    for i in range(12):  # crosses the 8-slot flush boundary
        l0, c0 = tm.decode(tp, tok, c0)
        l1, c1 = t1.decode(tp, tok, c1)
        lj, jc = jdec(jp, jnp.asarray(tok.numpy(), jnp.int32), jc)
        a, b, r = l0.numpy(), l1.numpy(), np.asarray(lj)
        mask = a > -1e29
        np.testing.assert_allclose(b[mask], a[mask], atol=STAGED_LOGITS_ATOL)
        np.testing.assert_allclose(b[mask], r[mask], atol=STAGED_LOGITS_ATOL)
        for row in range(a.shape[0]):  # the staged argmax is the plain optimum
            assert a[row].max() - a[row, int(b[row].argmax())] <= 0.05, (i, row)
        tok = torch.argmax(l0, -1)  # both decode the plain stream
        if int(c1["len"]) % 8 == 0:
            c1 = TT.flush_staging(c1, staged)
            jc = jflush(jc)
            assert not c1["sk"].any() and not c1["sv"].any()
    # the folded rows are the plain cache's: the first layer's bit for bit
    # (its keys and values depend on the tokens alone), the deeper layers'
    # within their inputs' rounding
    n = int(c1["len"]) - int(c1["len"]) % 8
    for name in ("k", "v"):
        assert torch.equal(c1[name][0, :, :n], c0[name][0, :, :n])
        np.testing.assert_allclose(c1[name][:, :, :n].float().numpy(),
                                   c0[name][:, :, :n].float().numpy(), atol=0.04)


def test_staged_decode_matches_unstaged(smollm):
    """The reference's ``test_staged_decode_matches_unstaged`` on the port:
    decode_staging 4 on the paged backend with dense device KV serves the
    unstaged cache's greedy tokens, across prefill joins at four anchors,
    several flushed windows a row and page writes that span the main cache
    and the ring; tokens and every counter equal the reference's staged
    run's."""
    jm, jp, tm, tp = smollm
    t_st = build_model(dataclasses.replace(tm.cfg, decode_staging=4))
    j_st = j_build_model(dataclasses.replace(jm.cfg, decode_staging=4))
    prompts = [_prompt(20), _prompt(27, 1), _prompt(34, 2), _prompt(41, 3)]
    kw = dict(max_batch=4, max_ctx=192, backend="paged", shards=1, store_layers=2,
              device_kv="dense", codec="lz4")
    new = [12] * 4
    staged = ContinuousScheduler(t_st, tp, EngineConfig(ladder=PrecisionLadder(RUNGS), **kw),
                                 device="cpu")
    s_reqs = [Request(rid=i, prompt=p, max_new_tokens=n)
              for i, (p, n) in enumerate(zip(prompts, new))]
    for r in s_reqs:
        staged.submit(r)
    folded = {}  # rid -> staging windows folded back into the main cache
    while staged.has_work():
        staged.step()
        for st in staged.backend._slots.values():
            folded[st.rid] = (st.stage_base - len(prompts[st.rid])) // 4
    _, p_reqs = _serve(ContinuousScheduler(
        tm, tp, EngineConfig(ladder=PrecisionLadder(RUNGS), **kw), device="cpu"),
        Request, prompts, new)
    j_sched, j_reqs = _serve(JScheduler(j_st, jp, JEngineConfig(ladder=JLadder(RUNGS), **kw)),
                             JRequest, prompts, new)
    assert [r.output for r in s_reqs] == [r.output for r in p_reqs]
    assert [r.output for r in s_reqs] == [r.output for r in j_reqs]
    assert _counters(staged.report()) == _counters(j_sched.report())
    # 12 new tokens at ws 4: every request folded two windows or more
    assert sorted(folded) == [0, 1, 2, 3] and min(folded.values()) >= 2, folded


def test_staged_rows_read_from_the_ring(smollm):
    """Where the tier copies or ranks a staged slot's rows, the tokens still
    in the ring are read from it: the staged cache's rows equal the plain
    cache's at every decode step, the ring's tokens included (one layer,
    whose keys and values depend on the tokens alone, so the two caches
    hold the same bits)."""
    one = dataclasses.replace(smollm[2].cfg, n_layers=1)
    tm = build_model(one)
    tp = tm.init(torch.Generator().manual_seed(0))
    t_st = build_model(dataclasses.replace(one, decode_staging=4))
    kw = dict(max_batch=2, max_ctx=96, store_layers=2, device_kv="dense", codec="lz4")
    runs = []
    for model in (t_st, tm):
        sched = ContinuousScheduler(model, tp, EngineConfig(**kw), device="cpu")
        sched.submit(Request(rid=0, prompt=_prompt(21), max_new_tokens=10))
        rows = []
        while sched.has_work():
            sched.step()
            st = sched.backend._slots.get(0)
            if st is not None and st.stored_tokens:
                ln = int(sched._lens[0])
                rows.append((sched.backend.slot_kv_bits(0, 0, ln).clone(),
                             sched.backend._device_k_rows(0, 0, ln).clone()))
        runs.append(rows)
    assert len(runs[0]) == len(runs[1]) > 5
    for (bits_s, k_s), (bits_p, k_p) in zip(*runs):
        assert torch.equal(bits_s, bits_p)
        assert torch.equal(k_s, k_p)


def test_staged_decode_unsupported_combinations_raise():
    """The reference's refusals, in its words: staged decode needs the paged
    backend with dense device KV."""
    base = get_config("smollm-135m", smoke=True)
    model_st = build_model(dataclasses.replace(base, decode_staging=4))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="device_kv='dense'"):
        make_backend(model_st, EngineConfig(max_batch=4, max_ctx=192, store_layers=2,
                                            device_kv="bitplane"), cpu)
    with pytest.raises(ValueError, match="sharded"):
        make_backend(model_st, EngineConfig(max_batch=4, max_ctx=192, store_layers=2,
                                            backend="sharded", shards=2), cpu)
    model_ring = build_model(dataclasses.replace(base, attn_window=32, decode_staging=4))
    with pytest.raises(ValueError, match="ring"):
        make_backend(model_ring, EngineConfig(max_batch=2, max_ctx=96, backend="ring"), cpu)


# ---------------------------------------------------------------------------
# Padded admission
# ---------------------------------------------------------------------------

PADDED_LENS = [37, 80, 16, 55, 100, 23]
PADDED_NEW = [12, 9, 20, 6, 10, 15]


@pytest.mark.parametrize("device_kv", ["dense", "bitplane"])
def test_padded_admission_matches_reference(smollm, device_kv):
    """prefill_mode="padded" (left-pad to prefill_align, one whole-prompt
    prefill, the cache adopted into the slot, pad KV inside ``len``) under
    a ladder and a byte budget that evicts: greedy tokens and every integer
    counter of ``report()`` (prefill_compiles, the distinct padded lengths,
    included) equal the reference's."""
    jm, jp, tm, tp = smollm
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32) for n in PADDED_LENS]
    kw = dict(max_batch=4, max_ctx=128, device_kv=device_kv, prefill_mode="padded",
              codec="lz4", max_stored_bytes=40 * 1024)
    j_sched, j_reqs = _serve(JScheduler(jm, jp, JEngineConfig(ladder=JLadder(RUNGS), **kw),
                                        controller=JController(JStoreConfig(codec="lz4"))),
                             JRequest, prompts, PADDED_NEW)
    t_sched, t_reqs = _serve(ContinuousScheduler(
        tm, tp, EngineConfig(ladder=PrecisionLadder(RUNGS), **kw), device="cpu",
        controller=MemoryController(StoreConfig(codec="lz4"))), Request, prompts, PADDED_NEW)
    assert [r.output for r in t_reqs] == [r.output for r in j_reqs]
    tp_, tr = _counters(t_sched.report()), _counters(j_sched.report())
    assert tp_ == tr
    assert tp_["prefill_compiles"] == len({-(-n // 16) * 16 for n in PADDED_LENS})
    assert tp_["prefill_tokens"] == sum(-(-n // 16) * 16 for n in PADDED_LENS)


def test_padded_admission_refusals(smollm):
    """The reference's refusals around padded admission: prefix sharing
    needs chunked prefill, a ring cannot adopt a full-length cache, and a
    padded prompt must leave decode room."""
    _, _, tm, tp = smollm
    with pytest.raises(ValueError, match="prefix_sharing"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64, prefill_mode="padded",
                                                 prefix_sharing=True), device="cpu")
    ring = build_model(dataclasses.replace(tm.cfg, attn_window=32))
    with pytest.raises(ValueError, match="bucketed"):
        ContinuousScheduler(ring, tp, EngineConfig(max_ctx=64, backend="ring",
                                                   prefill_mode="padded"), device="cpu")
    sched = ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64, prefill_mode="padded"),
                                device="cpu")
    with pytest.raises(ValueError, match="admitted as 64"):
        sched.submit(Request(rid=0, prompt=_prompt(50)))


# ---------------------------------------------------------------------------
# Temperature sampling: the distribution
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temperature,top_k", [(0.5, 0), (1.0, 0), (1.0, 5), (2.0, 40),
                                               (0.7, 1)])
def test_sampling_distribution_matches_reference(temperature, top_k):
    """The port's temperature draws come from torch generators, not the
    reference's fold_in bits, so the streams differ; the distribution they
    sample does not.  The port's top-k-masked softmax equals the
    distribution of the reference's categorical draw (the softmax of its
    masked logits) within float32 rounding, and 4,000 of the port's draws
    from one row fit it (chi-square over the tokens with expected count 5
    or more, the rest pooled, below the 0.999 quantile)."""
    from scipy import stats

    rng = np.random.default_rng(7)
    logits = (rng.standard_normal((3, 64)) * 2.5).astype(np.float32)
    logits[1, :8] = logits[1, 8]  # ties at the k-th value
    cfg, jcfg = SamplerConfig(temperature, top_k), JSamplerConfig(temperature, top_k)
    got = token_probs(torch.from_numpy(logits), cfg).numpy()
    masked = jnp.asarray(logits) / jcfg.temperature
    if top_k > 0:
        kth = jax.lax.top_k(masked, top_k)[0][:, -1:]
        masked = jnp.where(masked < kth, -1e30, masked)
    want = np.asarray(jax.nn.softmax(masked, axis=-1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    # the reference's own draws land only where its distribution has mass
    keys = jax.random.split(jax.random.PRNGKey(0), 200)
    from repro.serving.sampler import sample as j_sample
    drawn = np.concatenate([np.asarray(j_sample(k, jnp.asarray(logits), jcfg)) for k in keys])
    assert (want[np.tile(np.arange(3), 200), drawn] > 0).all()

    n = 4000
    row = torch.from_numpy(logits[:1])
    counts = np.bincount([int(sample(row, cfg, seed=3, rid=0, draw=i)[0]) for i in range(n)],
                         minlength=64)
    expect = want[0] * n
    big = expect >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(expect[big], expect[~big].sum())
    keep = exp > 0
    if keep.sum() > 1:
        chi2 = float(((obs[keep] - exp[keep]) ** 2 / exp[keep]).sum())
        assert chi2 < stats.chi2.ppf(0.999, keep.sum() - 1), chi2
    else:
        assert counts[np.argmax(want[0])] == n
