"""The port's ring backend (sliding-window attention) against the JAX
reference, on the CPU: the ring cases of ``tests/test_kv_backend.py`` and
``tests/test_prefix_sharing.py``.

Both sides serve the same weights (the reference's ``PRNGKey(0)``, carried
across bit for bit) on two sliding-window models: the smollm-135m smoke
config with ``attn_window=32`` (the reference's ``ring_model`` fixture) and
mixtral-8x7b SMOKE (MoE, window 64).  Greedy tokens and the integer
counters of ``report()`` must equal the reference's.

XLA's float32 ``exp`` and sums differ from torch's in the last bit
(ROADMAP §3), so a value can round one bf16 step apart at a near-tie; the
smoke models' logits are bf16 products, so two tokens can tie exactly.  On
the Mixtral traces an expert product of one token rounds apart inside the
reference's compiled prefill (the same MoE layer compiled alone equals the
port's bit for bit, ``tests/test_torch_moe.py``), and a later greedy step
meets a tie.  So the comparison is tie-aware: each side's decode logits
are recorded, and where a request's tokens part, both sides' rows at the
first divergent token must hold the two tokens within one bf16 step of
each other (each run's choice is a tie in the other's logits too); the
counters that follow the blobs' compressed sizes (``VALUE_BYTES``) are
compared only on runs whose tokens agree throughout, and every other
counter always.  One case parts, and says so where it calls
``_assert_same``.
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
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.memctl import MemCtlConfig
from repro_torch.models import build_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request
from repro_torch.serving.kv_cache import PAGE_TOKENS

torch.set_num_threads(1)

#: report keys that are wall-clock times or the reference's jit counts
UNTIMED = {"prefill_s", "decode_s", "decode_tok_per_s", "prefill_compiles"}


def _pair(j_cfg, cfg):
    jm = j_build_model(j_cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(cfg)
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


@pytest.fixture(scope="module")
def smol():
    return _pair(dataclasses.replace(j_get_config("smollm-135m", smoke=True), attn_window=32),
                 dataclasses.replace(get_config("smollm-135m", smoke=True), attn_window=32))


@pytest.fixture(scope="module")
def mixtral():
    return _pair(j_get_config("mixtral-8x7b", smoke=True), get_config("mixtral-8x7b", smoke=True))


@pytest.fixture(params=["smol", "mixtral"])
def models(request):
    return request.getfixturevalue(request.param)


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


def _ring(**kw):
    base = dict(max_batch=2, max_ctx=96, backend="ring", store_layers=2, codec="lz4")
    return {**base, **kw}


class _Rows:
    """Records which decode logits row produced each (request, output
    index): the row a step computes for a slot produces output index
    ``len(output) + 1`` (the token it consumes is appended when the step
    commits)."""

    def __init__(self, sched, fn):
        self.sched, self.fn, self.rows = sched, fn, {}

    def __call__(self, params, token, cache, *args, **kw):
        logits, cache = self.fn(params, token, cache, *args, **kw)
        host = np.asarray(logits, np.float32)
        for i, slot in enumerate(self.sched._slots):
            if slot is not None and not slot.prefilling:
                self.rows[(slot.req.rid, len(slot.req.output) + 1)] = host[i]
        return logits, cache


def _serve(models, kw, prompts, max_new, side, waves=None):
    """Serve ``prompts`` (or ``waves``, each drained before the next) on
    one side: "port" or "reference".  Returns (scheduler, requests,
    recorded decode rows)."""
    jm, jp, tm, tp = models
    if side == "port":
        sched = ContinuousScheduler(tm, tp, EngineConfig(**kw), device="cpu")
        req = Request
        rows = _Rows(sched, tm.decode)
        sched.model = _Decoding(tm, rows)
    else:
        sched = JScheduler(jm, jp, JEngineConfig(**_j_kw(kw)))
        req = JRequest
        rows = _Rows(sched, sched._decode)
        sched._decode = rows
    reqs = []
    for wave in waves or [prompts]:
        news = max_new if isinstance(max_new, list) else [max_new] * (len(reqs) + len(wave))
        batch = [req(rid=len(reqs) + i, prompt=p, max_new_tokens=news[len(reqs) + i])
                 for i, p in enumerate(wave)]
        for r in batch:
            sched.submit(r)
        sched.run_until_drained()
        assert all(r.done for r in batch)
        reqs.extend(batch)
    return sched, reqs, rows.rows


class _Decoding:
    """The port's model with its ``decode`` recorded (every other
    attribute is the model's own)."""

    def __init__(self, model, rows):
        self._model, self.decode = model, rows

    def __getattr__(self, name):
        return getattr(self._model, name)


def _j_kw(kw):
    """The same engine settings in the reference's classes."""
    out = dict(kw)
    if out.get("ladder") is not None:
        out["ladder"] = JLadder(list(out["ladder"].rungs))
    if "engine" in out:
        e = out["engine"]
        out["engine"] = JMemCtlConfig(lanes=e.lanes, step_cycles=e.step_cycles)
    return out


def _counters(report):
    return {k: v for k, v in report.items()
            if isinstance(v, int) and not isinstance(v, bool) and k not in UNTIMED}


def _both(models, kw, prompts, max_new, waves=None):
    return (_serve(models, kw, prompts, max_new, "port", waves),
            _serve(models, kw, prompts, max_new, "reference", waves))


def _bf16_step(row) -> float:
    """One bf16 step at the row's largest magnitude."""
    return 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)


def _tokens_agree_or_tie(a, b) -> bool:
    """True when the two runs' tokens agree; where a request's tokens part,
    assert the parting is a tie (module docstring) and return False."""
    same = True
    for ra, rb in zip(a[1], b[1]):
        assert len(ra.output) == len(rb.output)
        j = next((i for i, (x, y) in enumerate(zip(ra.output, rb.output)) if x != y), None)
        if j is None:
            continue
        same = False
        assert j > 0, ("the first token parts", ra.rid)
        ta, tb = ra.output[j], rb.output[j]
        for rows in (a[2], b[2]):
            row = rows[(ra.rid, j)]
            assert abs(row[ta] - row[tb]) <= _bf16_step(row), (ra.rid, j, row[ta], row[tb])
    return same


#: counters that follow the stored blobs' compressed sizes, so the K/V
#: values and through them the tokens; every other counter follows the
#: lengths, the pages and the schedule
VALUE_BYTES = {"kv_stored_bytes", "kv_evicted_bytes", "kv_peak_stored_bytes",
               "kv_resident_stored_bytes"}


def _assert_same(port, ref, *, parts=False):
    """Tokens equal and every integer counter of the report equal.  A case
    named with ``parts=True`` may part at a tie (module docstring); then
    every counter but ``VALUE_BYTES`` is still compared.  Of this file's
    cases only ``test_bitplane_device_bytes_equal_controller_kv_read_ring
    [mixtral]`` parts (its kv_stored_bytes and kv_evicted_bytes differ);
    every other case, Mixtral's included, must agree throughout."""
    agree = _tokens_agree_or_tie(port, ref)
    assert agree or parts, "tokens part from the reference's"
    tp, tr = _counters(port[0].report()), _counters(ref[0].report())
    assert tp.keys() == tr.keys()
    for k in tp:
        if agree or k not in VALUE_BYTES:
            assert tp[k] == tr[k], (k, tp[k], tr[k])


# ---------------------------------------------------------------------------
# test_kv_backend.py: ring cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("device_kv", ["dense", "bitplane"])
def test_ring_backend_matches_reference(models, device_kv):
    """:318 (and :452 on the bit-plane layout): a prompt longer than the
    window skips its dead prefix; tokens and counters as the reference."""
    kw = _ring(device_kv=device_kv)
    _assert_same(*_both(models, kw, [_prompt(40), _prompt(70, 9)], 8))


def test_bitplane_ring_full_precision_is_bit_identical(models):
    """:452: at full precision the bit-plane ring serves the dense ring's
    tokens (packing is a bf16 bitcast)."""
    prompts = [_prompt(40), _prompt(70, 9)]
    dense = _serve(models, _ring(device_kv="dense"), prompts, 8, "port")
    planes = _serve(models, _ring(device_kv="bitplane"), prompts, 8, "port")
    assert [r.output for r in planes[1]] == [r.output for r in dense[1]]


def test_ring_backend_mixed_lengths_batch(models):
    """:331: slots of different lengths decode at their own positions and
    retire at their own step."""
    port, ref = _both(models, _ring(store_layers=1), [_prompt(20), _prompt(50, 3)], [4, 24])
    for run in (port, ref):
        short, long = run[1]
        assert len(short.output) == 4 and len(long.output) == 24
        assert short.finish_step < long.finish_step
    assert [r.finish_step for r in port[1]] == [r.finish_step for r in ref[1]]
    _assert_same(port, ref)


def test_ring_pages_retire_with_the_window(models):
    """:350: resident pages stay bounded by the window (+1 boundary page
    and the growing tail, per stream and layer), and dead pages leave
    without eviction accounting; the residency trace (which follows the
    lengths, not the tokens) equals the reference's step for step."""
    w = models[2].cfg.attn_window
    runs = {}
    for side in ("port", "reference"):
        kw = _ring(max_batch=1, store_layers=1)
        jm, jp, tm, tp = models
        if side == "port":
            sched = ContinuousScheduler(tm, tp, EngineConfig(**kw), device="cpu")
            rows = _Rows(sched, tm.decode)
            sched.model = _Decoding(tm, rows)
            req = Request(rid=0, prompt=_prompt(24), max_new_tokens=60)
        else:
            sched = JScheduler(jm, jp, JEngineConfig(**kw))
            rows = _Rows(sched, sched._decode)
            sched._decode = rows
            req = JRequest(rid=0, prompt=_prompt(24), max_new_tokens=60)
        sched.submit(req)
        trace = []
        while sched.has_work():
            sched.step()
            trace.append(sched.backend.store.footprint()["pages"])
        assert req.done
        assert max(trace) <= 2 * (w // PAGE_TOKENS + 2)
        assert sched.report()["kv_evictions"] == 0
        runs[side] = ((sched, [req], rows.rows), trace)
    assert runs["port"][1] == runs["reference"][1]
    _tokens_agree_or_tie(runs["port"][0], runs["reference"][0])


def test_ring_backend_serves_mixtral_family(mixtral):
    """:372: a Mixtral-family config joins continuous batching through the
    ring, and the paged backend refuses it."""
    _, _, tm, tp = mixtral
    with pytest.raises(NotImplementedError, match="ring"):
        ContinuousScheduler(tm, tp, EngineConfig(max_batch=2, max_ctx=128, backend="paged"),
                            device="cpu")
    kw = dict(max_batch=2, max_ctx=128, backend="ring", store_layers=1, codec="lz4")
    prompts = [_prompt(30 + 20 * i, i) for i in range(3)]
    port, ref = _both(mixtral, kw, prompts, 5)
    assert all(r.done and len(r.output) == 5 for r in port[1])
    _assert_same(port, ref)


def test_ring_slot_reuse_clears_stale_positions(models):
    """:394: a retired request's ring entries do not leak into the next
    request admitted into the same slot."""
    kw = _ring(max_batch=1, store_layers=1)
    waves = [[_prompt(20)], [_prompt(40, 5)]]
    port, ref = _both(models, kw, None, 6, waves=waves)
    _assert_same(port, ref)
    alone = _serve(models, kw, [_prompt(40, 5)], 6, "port")
    assert port[1][1].output == alone[1][0].output


def test_ring_backend_rejects_full_attention():
    """:415"""
    model = build_model(get_config("smollm-135m", smoke=True))
    params = model.init(device="cpu")
    with pytest.raises(ValueError, match="full attention"):
        ContinuousScheduler(model, params, EngineConfig(max_ctx=64, backend="ring"),
                            device="cpu")


def test_ring_checks_refuse_what_the_reference_refuses(smol):
    _, _, tm, tp = smol
    with pytest.raises(ValueError, match="multiple of PAGE_TOKENS"):
        odd = build_model(dataclasses.replace(tm.cfg, attn_window=40))
        ContinuousScheduler(odd, tp, EngineConfig(**_ring(device_kv="bitplane")), device="cpu")
    with pytest.raises(ValueError, match="at least one"):
        tiny = build_model(dataclasses.replace(tm.cfg, attn_window=8))
        ContinuousScheduler(tiny, tp, EngineConfig(**_ring()), device="cpu")
    sched = ContinuousScheduler(tm, tp, EngineConfig(**_ring(max_ctx=192)), device="cpu")
    assert sched.backend.max_prefill_bucket() == 32


@pytest.mark.parametrize("models_name", ["smol", "mixtral"])
def test_bitplane_device_bytes_equal_controller_kv_read_ring(request, models_name):
    """:468 [ring-1]: under a mixed ladder, eviction thrash and small
    engine windows, the device path's bytes equal the controller's
    plane-scaled kv_read exactly.  The reference's own last assertion
    (device bytes strictly below the dense path's logical reads) fails on
    the smollm trace: there the ring's ladder saves no device bytes, 140,288
    against 140,288 (a known reference failure, ROADMAP §3), and the port
    reproduces those numbers."""
    models = request.getfixturevalue(models_name)
    # the reference's case as it stands: the default codec, no pin
    kw = _ring(device_kv="bitplane", ladder=PrecisionLadder([(1, 16), (-1, 4)]),
               max_stored_bytes=10 * 1024, engine=MemCtlConfig(lanes=2, step_cycles=512),
               weight_stream="resident", codec=None)
    port, ref = _both(models, kw, [_prompt(80), _prompt(80, 3)], 16)
    rep = port[0].report()
    assert rep["kv_evictions"] > 0
    dev = sum(t.controller.stats.kind_device_bytes("kv_read") for t in port[0].backend.tiers)
    assert rep["device_bytes_read"] == dev > 0
    assert rep["device_bytes_read"] == rep["kv_read_device_bytes"]
    # the Mixtral trace parts from the reference's at a tie (module docstring)
    _assert_same(port, ref, parts=models_name == "mixtral")
    if models_name == "smol":
        assert rep["device_bytes_read"] == rep["kv_fetch_logical"] == 140288


@pytest.mark.parametrize("models_name", ["smol", "mixtral"])
def test_ring_bitplane_head_reclaims_rows_at_full_precision(request, models_name):
    """:548: the moment the next append would land in a ranked page's first
    device row, that page's plane-map entry falls back to full precision.
    The reference's case at window 32 (prompt 40, page 1 reclaimed at ln
    48), and at Mixtral's window 64 (prompt 72, page 3 at ln 112)."""
    models = request.getfixturevalue(models_name)
    _, _, tm, tp = models
    w = tm.cfg.attn_window
    wp = w // PAGE_TOKENS
    cfg = EngineConfig(max_batch=1, max_ctx=2 * w + 32, backend="ring", store_layers=1,
                       device_kv="bitplane", ladder=PrecisionLadder([(-1, 4)]), codec="lz4")
    sched = ContinuousScheduler(tm, tp, cfg, device="cpu")
    sched.submit(Request(rid=0, prompt=_prompt(w + 8), max_new_tokens=w))
    # the page at device column wp - 1 (ring rows w - 16 .. w - 1) is
    # reclaimed when the head reaches row w - 16, at ln = 2w - 16
    reclaim = 2 * w - PAGE_TOKENS
    while int(sched._lens[0]) < reclaim - 1:
        sched.step()
    assert int(sched.backend.cache["planes"][0, wp - 1]) == 4
    sched.step()
    assert int(sched._lens[0]) == reclaim
    assert int(sched.backend.cache["planes"][0, wp - 1]) == 16
    sched.run_until_drained()


def test_fused_decode_matches_rung_ring(models):
    """:576 ("ring", 1): the fused kernel's plain version serves the rung
    path's tokens under a mixed ladder, pages filling mid-stream (on the
    Mixtral trace up to a tie: the two merge their partials in another
    order), and the reference's."""
    runs = {}
    for kernel in ("fused", "rung"):
        kw = _ring(device_kv="bitplane", ladder=PrecisionLadder([(1, 16), (-1, 4)]),
                   decode_kernel=kernel)
        runs[kernel] = _serve(models, kw, [_prompt(80), _prompt(37, 5)], 20, "port")
    _tokens_agree_or_tie(runs["fused"], runs["rung"])
    ref = _serve(models, _ring(device_kv="bitplane", ladder=PrecisionLadder([(1, 16), (-1, 4)])),
                 [_prompt(80), _prompt(37, 5)], 20, "reference")
    _assert_same(runs["fused"], ref)


def test_ring_weight_stream_tokens_bit_identical(models):
    """:721: streamed compressed weights leave the ring's tokens and KV
    counters as they are."""
    prompts = [_prompt(20), _prompt(41, 5)]
    res = {mode: _serve(models, _ring(weight_stream=mode), prompts, 10, "port")
           for mode in ("resident", "compressed")}
    assert ([r.output for r in res["resident"][1]]
            == [r.output for r in res["compressed"][1]])
    rc = res["compressed"][0].report()
    assert rc["weights"]["bandwidth_saving"] > 0.0
    assert rc["weights"]["passes_fetched"] >= rc["weights"]["passes_consumed"]
    ref = _serve(models, _ring(weight_stream="compressed"), prompts, 10, "reference")
    assert rc["weights"] == ref[0].report()["weights"]


# ---------------------------------------------------------------------------
# test_prefix_sharing.py: ring cases
# ---------------------------------------------------------------------------


def test_ring_sharing_on_matches_off_and_the_reference(models):
    """:120 ("ring", 1): prompts inside the window register and share; the
    tokens with sharing on equal off and the reference's, and the prefix
    report equals the reference's."""
    shared = _prompt(PAGE_TOKENS, 7)
    waves = [[np.concatenate([shared, _prompt(6, 100)])],
             [np.concatenate([shared, _prompt(9, 200)]),
              np.concatenate([shared, _prompt(11, 300)])]]
    on, ref = _both(models, _ring(prefix_sharing=True), None, 8, waves=waves)
    off = _serve(models, _ring(prefix_sharing=False), None, 8, "port", waves=waves)
    assert [r.output for r in on[1]] == [r.output for r in off[1]]
    px = on[0].report()["prefix"]
    assert px["enabled"] and px["requests_matched"] > 0, px
    assert px["bytes_deduplicated"] > 0
    assert px == ref[0].report()["prefix"]
    _assert_same(on, ref)


def test_ring_prompt_longer_than_window_never_registers(models):
    """:169: a prompt whose prefix reaches past the live window is never
    registered, so a later identical prompt prefills cold."""
    w = models[2].cfg.attn_window
    long_shared = _prompt(w + PAGE_TOKENS, 7)
    waves = [[np.concatenate([long_shared, _prompt(5, 100)])],
             [np.concatenate([long_shared, _prompt(7, 200)])]]
    on, ref = _both(models, _ring(prefix_sharing=True, max_ctx=2 * w + 32), None, 8, waves=waves)
    off = _serve(models, _ring(prefix_sharing=False, max_ctx=2 * w + 32), None, 8, "port",
                 waves=waves)
    assert [r.output for r in on[1]] == [r.output for r in off[1]]
    px = on[0].report()["prefix"]
    assert px["requests_matched"] == 0
    assert px["index_entries"] == 0
    _assert_same(on, ref)


# ---------------------------------------------------------------------------
# The ring's kernels: flash attention with key positions, the paged
# kernels' ring mask
# ---------------------------------------------------------------------------

#: one call's output against the reference's: within this many bf16 steps
#: of each row's largest magnitude (float32 sums in another order, p
#: rounded to bf16 at other maxima: tests/test_torch_flash.py)
BF16_STEPS = 2


def _ring_positions(rng, b, w, end):
    """A ring of w slots after ``end`` tokens: slot p % w holds position p
    for the last min(end, w) positions, the rest unfilled (-1)."""
    pos = np.full((b, w), -1, np.int32)
    for i in range(b):
        for p in range(max(0, end[i] - w), end[i]):
            pos[i, p % w] = p
    return pos


@pytest.mark.parametrize("b,w,c,hp,hkv,hd,ends,window", [
    (1, 64, 16, 6, 2, 16, (100,), 64),       # Mixtral SMOKE's chunk, a full ring
    (2, 32, 32, 6, 2, 16, (40, 20), 32),     # the ring_model fixture; one ring part-filled
    (1, 128, 64, 8, 2, 128, (300,), 128),    # head dim 128, as Mixtral-8x7B
    (2, 64, 48, 4, 4, 32, (64, 7), 40),      # a window shorter than the ring
])
def test_plain_flash_with_key_positions_matches_model_flash(b, w, c, hp, hkv, hd, ends, window):
    """The ring chunk's call, [ring] ++ [chunk] with every key at its own
    position, against the reference's jnp ``flash_attention(kv_pos=...)``
    (``models/attention.py``), within BF16_STEPS."""
    from repro.models.attention import flash_attention as j_flash
    from repro.models.attention import head_map_static as j_head_map
    from repro_torch.kernels.flash_attention import ops as FO

    import jax.numpy as jnp

    rng = np.random.default_rng(w + c + hd)
    ends = np.asarray(ends, np.int32)
    ring = _ring_positions(rng, b, w, ends)
    q_pos = ends[:, None] + np.arange(c, dtype=np.int32)[None]
    kv_pos = np.concatenate([ring, q_pos], axis=1)
    valid = ends + c - 3  # the chunk's last 3 tokens are pad

    def bf16(shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)

    q, k, v = bf16((b, c, hp, hd)), bf16((b, w + c, hkv, hd)), bf16((b, w + c, hkv, hd))
    want = j_flash(q, k, v, j_head_map(hp, hp, hkv), q_pos=jnp.asarray(q_pos),
                   kv_valid=jnp.asarray(valid), window=window, kv_pos=jnp.asarray(kv_pos))
    t = lambda a: params_from_jax(np.asarray(a), "cpu")  # noqa: E731
    got = FO.flash_attention(t(q), t(k), t(v), q_pos=t(q_pos), kv_valid=t(valid),
                             window=window, kv_pos=t(kv_pos))
    want, got = np.asarray(want).astype(np.float32), got.float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30))) - 7)
    assert (np.abs(got - want) / step).max() <= BF16_STEPS


def test_plain_flash_key_positions_in_index_order_are_the_index_path():
    """kv_pos = arange(Skv) is the index path itself, bit for bit."""
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator().manual_seed(3)
    q = torch.randn(2, 24, 4, 16, generator=gen).to(torch.bfloat16)
    k = torch.randn(2, 80, 2, 16, generator=gen).to(torch.bfloat16)
    v = torch.randn(2, 80, 2, 16, generator=gen).to(torch.bfloat16)
    pos = 40 + torch.arange(24)[None].expand(2, 24)
    args = dict(q_pos=pos, kv_valid=torch.tensor([64, 80]), window=30, chunk=32)
    plain = FR.flash_attention_ref(q, k, v, **args)
    ring = FR.flash_attention_ref(q, k, v, kv_pos=torch.arange(80)[None].expand(2, 80), **args)
    assert torch.equal(plain, ring)


@pytest.mark.parametrize("kernel", ["fused", "rung"])
def test_plain_paged_attention_over_a_ring_matches_reference(kernel):
    """Decode over a bit-plane ring: the ring's positions and the window
    fold into the mask both kernels take, as the reference's
    ``batched_ladder_paged_attention(kv_pos=, window=)`` folds them (its
    Pallas kernels in interpret mode), atol 2e-2 as
    ``tests/test_torch_kernels.py``."""
    import ml_dtypes

    import jax.numpy as jnp
    from repro.kernels.paged_attention.ops import batched_ladder_paged_attention as j_attention
    from repro.kernels.paged_attention.ops import pack_kv_planes as j_pack
    from repro_torch.kernels.paged_attention import ops as O

    b, w, hkv, rep, hd = 3, 64, 2, 3, 16
    rng = np.random.default_rng(11)
    ln = np.array([150, 40, 64], np.int32)  # wrapped, part-filled, just full
    kv_pos = _ring_positions(rng, b, w, ln + 1)
    q = rng.standard_normal((b, 1, hkv * rep, hd)).astype(ml_dtypes.bfloat16)
    k = rng.standard_normal((b, w, hkv, hd)).astype(ml_dtypes.bfloat16)
    v = rng.standard_normal((b, w, hkv, hd)).astype(ml_dtypes.bfloat16)
    pp = rng.choice([4, 8, 16], (b, w // 16)).astype(np.int32)
    q_pos = ln[:, None]
    want = np.asarray(j_attention(
        jnp.asarray(q), j_pack(jnp.asarray(k)), j_pack(jnp.asarray(v)), jnp.asarray(pp),
        jnp.asarray(ln + 1), keeps=(4, 8, 16), q_pos=jnp.asarray(q_pos),
        kv_pos=jnp.asarray(kv_pos), window=48, kernel=kernel), np.float32)
    t = lambda a: params_from_jax(a, "cpu")  # noqa: E731
    got = O.batched_ladder_paged_attention(
        t(q), O.pack_kv_planes(t(k)), O.pack_kv_planes(t(v)), t(pp), t(ln + 1),
        keeps=(4, 8, 16), q_pos=t(q_pos), kv_pos=t(kv_pos), window=48, kernel=kernel,
    ).float().numpy()
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=0)
    assert np.any(got != 0)
