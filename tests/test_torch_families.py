"""The port's dense and MoE families beyond SmolLM and Mixtral against the
JAX reference, on the CPU: Yi-9B, Yi-34B (also with its q heads padded
8 -> 16, as the FULL config pads 56 to 64), Nemotron-4-15B (the squared
ReLU MLP) and DeepSeek-MoE-16B (fine-grained experts beside two shared
ones), each at its SMOKE width with the reference's ``PRNGKey(0)``
weights carried across bit for bit.  The Yi cases run here; the same
tests run on Nemotron-4 and DeepSeek in
``tests/test_torch_families_relu2_moe.py`` (the two files keep each under
a minute and a half serial).

Held to the reference: the plain forward, each layer of it from the
reference's input, and the whole-prompt prefill's caches (every element
within one bf16 step, at most 2% differing: XLA's float32 ``rsqrt`` and
``exp`` differ from torch's in the last bit; Nemotron's whole forward is
compared with XLA's rsqrt and q/k/v projections supplied, as
``XLA_PROJECTIONS`` says, and every case's within one bf16 step of each
token row's largest magnitude), the
prefill's logits and a teacher-forced decode step's (within 5e-2), and on
a short serving trace the greedy tokens and every integer counter of
``report()`` exactly but the compressed-size bytes (``VALUE_BYTES``, held
within 0.1%): Yi-9B on dense device KV (its SMOKE head_dim, 12, takes no
bit-plane layout), the others on bit-plane KV.  DeepSeek may
part from the reference only at an exact bf16 logit tie, recorded on both
sides (``_tokens_agree_or_tie``), as the Mixtral ring cases do.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.core.quantization import PrecisionLadder as JLadder
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model
from repro.models.model import prepare_decode_cache as j_prepare
from repro.serving import ContinuousScheduler as JScheduler
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import Request as JRequest

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.models import build_model
from repro_torch.models import attention as TA
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import embed_apply, layer_slice, mlp_apply
from repro_torch.models.model import prepare_decode_cache
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request

torch.set_num_threads(1)

#: case -> (arch, config changes, device KV layout)
CASES = {
    "yi-9b": ("yi-9b", {}, "dense"),
    "yi-34b": ("yi-34b", {}, "bitplane"),
    "yi-34b-pad16": ("yi-34b", {"pad_heads_to": 16}, "bitplane"),
    "nemotron-4-15b": ("nemotron-4-15b", {}, "bitplane"),
    "deepseek-moe-16b": ("deepseek-moe-16b", {}, "bitplane"),
}
#: the cases whose greedy tokens may part from the reference's at a tie
PARTS = {"deepseek-moe-16b"}
FORWARD_DIFF_SHARE = 0.02
#: Nemotron's plain forward through both layers is compared with XLA's
#: float32 rsqrt (``XLA_RSQRT``) and XLA's q, k and v projections
#: (``XLA_PROJECTIONS``) supplied to the port.  XLA's CPU rsqrt is the
#: hardware's approximate reciprocal square root (vrsqrtps) refined by two
#: Newton steps, off the correctly rounded value by one float32 ulp on 15%
#: of inputs, and no torch operation reproduces it; the projections are
#: bf16 products summed in float32 in XLA's dot order, which torch's CPU
#: matmul does not follow, so the first layer's q, k and v round a bf16
#: step apart on a few elements, and a one-ulp change of one weight moves
#: 39-55% of the reference's own output on every family here
#: (``test_xla_rsqrt_parts_from_torch_and_one_ulp_moves_the_reference``).
#: Of the stack's elements, 15.6% differ with torch's rsqrt and
#: projections, 5.1% with XLA's rsqrt alone, 0.18% with both supplied (one
#: bf16 step at most), held to FORWARD_DIFF_SHARE as every case.  The
#: attention itself, the flash forward, needs nothing supplied: XLA's
#: supplied in its place leaves the share as it was.  Layer by layer, from
#: the reference's input, every case holds FORWARD_DIFF_SHARE with the
#: rsqrt alone (``test_each_layer_matches_reference_given_its_rsqrt``)
XLA_RSQRT = {"nemotron-4-15b"}
XLA_PROJECTIONS = {"nemotron-4-15b"}
LOGITS_ATOL = 5e-2
RUNGS = [(1, 16), (1, 8), (-1, 4)]
PROMPT_LENS = [37, 20, 55]
MAX_NEW = [6, 9, 5]
#: report keys that are wall-clock times or the reference's jit counts
UNTIMED = {"prefill_s", "decode_s", "decode_tok_per_s", "prefill_compiles"}
#: counters that follow the stored blobs' compressed sizes, so every bit of
#: the stored K/V; every other counter follows the lengths, the pages and
#: the schedule
VALUE_BYTES = {"kv_stored_bytes", "kv_evicted_bytes", "kv_peak_stored_bytes",
               "kv_resident_stored_bytes", "kv_fetch_physical"}
#: their bound: 11 of 133,587 stored bytes apart measured (Nemotron SMOKE)
VALUE_BYTES_REL = 1e-3




def make_case(name: str) -> tuple:
    """(name, reference model, its params, port model, the params carried
    across, device KV layout) of one CASES entry."""
    arch, change, device_kv = CASES[name]
    jcfg = dataclasses.replace(j_get_config(arch, smoke=True), **change)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_config(arch, smoke=True), **change))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return name, jm, jp, tm, tp, device_kv


# the Yi cases here; Nemotron-4 and DeepSeek in
# tests/test_torch_families_relu2_moe.py, which runs these tests on them
@pytest.fixture(scope="module", params=["yi-9b", "yi-34b", "yi-34b-pad16"])
def case(request):
    return make_case(request.param)


def _steps_and_share(want, got):
    want = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    return diff.max() / step, np.mean(diff > 0)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _row_steps(want, got):
    """The largest difference in bf16 steps of each token row's largest
    magnitude."""
    want = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max(-1, keepdims=True))) - 7)
    return float((np.abs(got - want) / step).max())


def _supply_xla_rsqrt(monkeypatch):
    xla_rsqrt = jax.jit(jax.lax.rsqrt)
    monkeypatch.setattr(torch, "rsqrt", lambda t: torch.from_numpy(
        np.asarray(xla_rsqrt(t.float().numpy())).copy()))


def _supply_xla_projections(monkeypatch):
    """The attention sub-layer's q, k and v projections (bf16 products summed
    in float32) taken from XLA's dot, the rest (rope on q and k) the
    port's."""
    dots = jax.jit(lambda x, wq, wk, wv: tuple(jnp.einsum("bsd,dhk->bshk", x, w)
                                               for w in (wq, wk, wv)))

    def bf16(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    def project_qkv(params, x, cfg, pos):
        q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
                   for a in dots(bf16(x), *(bf16(params[w]) for w in ("wq", "wk", "wv"))))
        cos, sin = TA.rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        return TA.apply_rope(q, cos, sin), TA.apply_rope(k, cos, sin), v

    monkeypatch.setattr(TA, "project_qkv", project_qkv)


def test_plain_forward_matches_reference(case, monkeypatch):
    name, jm, jp, tm, tp, _ = case
    toks = _tokens(tm.cfg, 2, 40, 1)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    if name in XLA_RSQRT:
        _supply_xla_rsqrt(monkeypatch)
    if name in XLA_PROJECTIONS:
        _supply_xla_projections(monkeypatch)
    # compiled without remat, as the reference's prefill runs it: XLA's
    # fusions set the rounding points the port copies (ROADMAP §3), and the
    # training graph's rematerialisation fuses otherwise
    xj = jax.jit(lambda p, t, q: JT.run_stack(p, jm.cfg, JT.embed_apply(p["embed"], t), q,
                                              remat=False)[0])(
        jp, jnp.asarray(toks), jnp.asarray(pos))
    xt = TT.run_stack(tp, tm.cfg, embed_apply(tp["embed"], torch.from_numpy(toks).long()),
                      torch.from_numpy(pos.copy()))
    steps, share = _steps_and_share(xj, xt.float().numpy())
    assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (steps, share)
    assert _row_steps(xj, xt.float().numpy()) <= 1


def test_each_layer_matches_reference_given_its_rsqrt(case, monkeypatch):
    """Each layer alone from the reference's own input: every element within
    one bf16 step and at most FORWARD_DIFF_SHARE of them differing, with the
    norms' float32 rsqrt taken from XLA (its CPU rsqrt is a hardware
    approximation refined by Newton steps, which torch cannot reproduce;
    XLA_RSQRT).  The rest of each layer is the port's own."""
    _, jm, jp, tm, tp, _ = case
    toks = _tokens(tm.cfg, 2, 40, 1)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    _supply_xla_rsqrt(monkeypatch)
    one_layer = jax.jit(lambda p, x, q: JT.run_stack(p, jm.cfg, x, q, remat=False)[0])
    x = JT.embed_apply(jp["embed"], jnp.asarray(toks))
    for i in range(tm.cfg.n_layers):
        jp_i = dict(jp, layers=jax.tree_util.tree_map(lambda a: a[i:i + 1], jp["layers"]))
        want = one_layer(jp_i, x, jnp.asarray(pos))
        got, _ = TT.block_apply(layer_slice(tp["layers"], i),
                                torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16),
                                tm.cfg, pos=torch.from_numpy(pos.copy()))
        steps, share = _steps_and_share(want, got.float().numpy())
        assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (i, steps, share)
        x = want


def test_xla_rsqrt_parts_from_torch_and_one_ulp_moves_the_reference():
    """Why Nemotron's whole forward is compared with XLA's rsqrt and
    projections supplied (XLA_PROJECTIONS):
    XLA's float32 rsqrt on the CPU is off the correctly rounded value by
    one ulp on over 5% of inputs and parts from torch's on over 20%, and
    the reference's own plain forward moves in over 20% of its elements
    when one weight of its first layer moves one bf16 ulp."""
    x = np.random.default_rng(0).uniform(0.01, 100, 100_000).astype(np.float32)
    xla = np.asarray(jax.jit(jax.lax.rsqrt)(x))
    exact = torch.rsqrt(torch.from_numpy(x).double()).float().numpy()
    ulps = np.abs(xla.view(np.int32).astype(np.int64) - exact.view(np.int32))
    assert ulps.max() == 1 and np.mean(ulps == 1) > 0.05
    assert np.mean(xla != torch.rsqrt(torch.from_numpy(x)).numpy()) > 0.2

    _, jm, jp, _, _, _ = make_case("nemotron-4-15b")
    toks = jnp.asarray(_tokens(jm.cfg, 2, 40, 1))
    pos = jnp.asarray(np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40)))
    forward = jax.jit(lambda p: JT.run_stack(p, jm.cfg, JT.embed_apply(p["embed"], toks), pos,
                                             remat=False)[0])
    wq = np.asarray(jp["layers"]["attn"]["wq"]).copy()
    wq.view(np.uint16)[0, 0, 0, 0] += 1
    nudged = dict(jp, layers=dict(jp["layers"], attn=dict(jp["layers"]["attn"],
                                                          wq=jnp.asarray(wq))))
    assert np.mean(np.asarray(forward(jp)) != np.asarray(forward(nudged))) > 0.2


@pytest.fixture(scope="module")
def prefilled(case):
    _, jm, jp, tm, tp, _ = case
    toks = _tokens(tm.cfg, 2, 33, 2)
    jl, jc = jax.jit(jm.prefill)(jp, {"tokens": jnp.asarray(toks)})
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks)})
    return toks, (jl, jc), (tl, tc)


def test_prefill_logits_and_cache_match_reference(case, prefilled):
    _, _, _, tm, _, _ = case
    toks, (jl, jc), (tl, tc) = prefilled
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)
    assert sorted(tc) == sorted(jc) == ["k", "len", "v"]
    assert int(tc["len"]) == int(jc["len"]) == toks.shape[1]
    for name in ("k", "v"):
        assert tuple(tc[name].shape) == jc[name].shape == (
            tm.cfg.n_layers, 2, toks.shape[1], tm.cfg.n_kv_heads, tm.cfg.head_dim)
        steps, share = _steps_and_share(jc[name], tc[name].float().numpy())
        assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (name, steps, share)


def test_teacher_forced_decode_logits(case, prefilled):
    """The reference's prefill cache, carried across and padded on both
    sides, then one decode step of the same tokens: logits within
    LOGITS_ATOL."""
    _, jm, jp, tm, tp, _ = case
    toks, (_, jc), _ = prefilled
    jc = j_prepare(jm.cfg, jc, 48)
    tc = prepare_decode_cache(tm.cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jc), "cpu"), 48)
    tok = toks[:, -1]
    lj, _ = jax.jit(jm.decode)(jp, jnp.asarray(tok), jc)
    lt, tc = tm.decode(tp, torch.from_numpy(tok), tc)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, rtol=0)
    assert int(tc["len"]) == toks.shape[1] + 1


@pytest.mark.parametrize("kernel", ["fused", "rung"])
def test_teacher_forced_bitplane_decode_logits(case, kernel):
    """The same bit-plane cache (the reference's chunked prefill of two
    slots, carried across bit for bit), the same tokens and the same mixed
    plane map: one decode step's logits within LOGITS_ATOL (the bit-plane
    cases).  Carrying the cache keeps the chunks' own rounding out of the
    comparison: XLA's float32 exp moves a few cached keys a bf16 step
    (ROADMAP §3), which the serving trace holds apart."""
    _, jm, jp, tm, tp, device_kv = case
    if device_kv != "bitplane":
        pytest.skip("dense device KV: head_dim 12 takes no bit-plane layout")
    b, s = 2, 64
    jc = JT.bitplane_cache_from_dense(jm.init_cache(b, s))
    prompt = _tokens(tm.cfg, 1, 40, 3)
    for slot, n in ((0, 40), (1, 24)):
        jc["len"] = jnp.int32(0)
        _, jc = jax.jit(jm.prefill_chunk)(jp, jnp.asarray(prompt[:, :n]), jc, jnp.int32(slot),
                                          jnp.int32(0), jnp.int32(n - 1))
    tc = params_from_jax(jax.tree_util.tree_map(np.asarray, jc), "cpu")
    lens = np.array([40, 24], np.int32)
    planes = np.full((b, s // 16), 16, np.int32)
    planes[0, :2] = [8, 4]
    planes[1, :1] = [8]
    keeps = (4, 8, 16)
    jc.update(len=jnp.asarray(lens), planes=jnp.asarray(planes))
    tc.update(len=torch.from_numpy(lens), planes=torch.from_numpy(planes))
    tok = np.array([7, 300], np.int32) % tm.cfg.vocab
    lj, _ = jax.jit(lambda p, t, c: jm.decode(p, t, c, keeps=keeps, decode_kernel=kernel))(
        jp, jnp.asarray(tok), jc)
    lt, _ = tm.decode(tp, torch.from_numpy(tok).long(), tc, keeps=keeps, decode_kernel=kernel)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("act", ["relu2", "gelu", "swiglu"])
def test_mlp_apply_matches_reference_bit_for_bit(act):
    """Each MLP at the reference's rounding points: bf16 products, the
    activation's every operation rounded as XLA rounds it."""
    d, ff = 64, 96
    j = JL.mlp_params(jax.random.PRNGKey(4), d, ff, act, jnp.bfloat16)
    t = params_from_jax(jax.tree_util.tree_map(np.asarray, j), "cpu")
    assert sorted(t) == (["w_gate", "w_in", "w_out"] if act == "swiglu" else ["w_in", "w_out"])
    x = np.random.default_rng(5).standard_normal((3, 11, d)).astype(np.float32)
    want = jax.jit(lambda p, x: JL.mlp_apply(p, x, act))(j, jnp.asarray(x).astype(jnp.bfloat16))
    got = mlp_apply(t, torch.from_numpy(x).to(torch.bfloat16), act)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def _bf16_step(row) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)


class _Rows:
    """Records the decode logits row that produced each (request, output
    index): a step's row for a slot produces output ``len(output) + 1``."""

    def __init__(self, sched, fn):
        self.sched, self.fn, self.rows = sched, fn, {}

    def __call__(self, params, token, cache, *args, **kw):
        logits, cache = self.fn(params, token, cache, *args, **kw)
        host = np.asarray(logits, np.float32)
        for i, slot in enumerate(self.sched._slots):
            if slot is not None and not slot.prefilling:
                self.rows[(slot.req.rid, len(slot.req.output) + 1)] = host[i]
        return logits, cache


class _Decoding:
    """The port's model with its ``decode`` recorded."""

    def __init__(self, model, rows):
        self._model, self.decode = model, rows

    def __getattr__(self, name):
        return getattr(self._model, name)


def _engine(device_kv):
    return dict(max_batch=2, max_ctx=64, device_kv=device_kv, decode_kernel="fused",
                backend="paged", codec="lz4", store_layers=2,
                max_stored_bytes=6 * 1024)


@pytest.fixture(scope="module")
def served(case):
    name, jm, jp, tm, tp, device_kv = case
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, tm.cfg.vocab, n).astype(np.int32) for n in PROMPT_LENS]
    kw = _engine(device_kv)
    out = {}
    for side in ("port", "reference"):
        if side == "port":
            sched = ContinuousScheduler(tm, tp, EngineConfig(ladder=PrecisionLadder(RUNGS), **kw),
                                        device="cpu")
            rows = _Rows(sched, tm.decode)
            sched.model = _Decoding(tm, rows)
            req = Request
        else:
            sched = JScheduler(jm, jp, JEngineConfig(ladder=JLadder(RUNGS), **kw))
            rows = _Rows(sched, sched._decode)
            sched._decode = rows
            req = JRequest
        reqs = [req(rid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
        assert all(r.done and len(r.output) == r.max_new_tokens for r in reqs)
        out[side] = (sched, reqs, rows.rows)
    return name, out["port"], out["reference"]


def _tokens_agree_or_tie(a, b) -> bool:
    """True when the two runs' tokens agree; where a request's tokens part,
    assert the parting is a tie in both runs' recorded rows and return
    False."""
    same = True
    for ra, rb in zip(a[1], b[1]):
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


def test_greedy_tokens_equal(served):
    name, port, ref = served
    agree = _tokens_agree_or_tie(port, ref)
    assert agree or name in PARTS, "tokens part from the reference's"


def test_report_counters_equal(served):
    """Every integer counter of ``report()`` exactly (the evictions the
    byte budget forces among them), but those that follow the stored
    blobs' compressed sizes (VALUE_BYTES): the chunked prefill's attention
    rounds a few cached keys and values one bf16 step apart from the
    reference's (XLA's float32 exp, ROADMAP §3), and a page's compressed
    size follows every bit of it, so those are held within
    VALUE_BYTES_REL of the reference's (exactly where they agree), on
    every case, DeepSeek's too: a parting at a tie changes the few tokens
    after it, not the schedule."""
    name, port, ref = served
    _tokens_agree_or_tie(port, ref)

    def counters(rep):
        return {k: v for k, v in rep.items()
                if isinstance(v, int) and not isinstance(v, bool) and k not in UNTIMED}

    tp, tr = counters(port[0].report()), counters(ref[0].report())
    assert tp.keys() == tr.keys()
    for k in tp:
        if k not in VALUE_BYTES:
            assert tp[k] == tr[k], (k, tp[k], tr[k])
        else:
            assert abs(tp[k] - tr[k]) <= VALUE_BYTES_REL * tr[k], (k, tp[k], tr[k])
    assert tp["kv_evictions"] > 0  # the budget really evicted


def test_device_bytes_are_the_controllers_plane_scaled_reads(served):
    _, port, _ = served
    if port[0].backend.cfg.device_kv != "bitplane":
        pytest.skip("dense device KV reads every plane")
    rep = port[0].report()
    assert rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0
