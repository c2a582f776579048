"""The port's MoE family (Mixtral) against the JAX reference, on the CPU:
``moe_apply`` (dropless and capacity-dropping), the Mixtral SMOKE plain
forward, the parameters' round trip through ``convert.py``, and the dense
and ring conversions of ``prepare_decode_cache``.

``moe_apply`` has the reference's router, stable sort, capacity rule and
bf16 rounding points; its bf16 expert products sum in another order than
XLA's, so an output can round one bf16 step apart at a near-tie: every
element within one step of its token's largest, at most 0.5% differing.  The plain forward is
held as the dense one is
(``tests/test_torch_serving.py``): every element within one bf16 step of
the reference, and at most 2% of elements differing at all (XLA's float32
``rsqrt`` in the norms differs from torch's in the last bit).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model
from repro.models.model import prepare_decode_cache as j_prepare

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import embed_apply
from repro_torch.models.model import prepare_decode_cache

torch.set_num_threads(1)

FORWARD_DIFF_SHARE = 0.02


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("mixtral-8x7b", smoke=True)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("mixtral-8x7b", smoke=True))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _layer(models, i):
    _, jp, _, tp = models
    return (jax.tree_util.tree_map(lambda a: a[i], jp["layers"]["moe"]),
            {k: v[i] for k, v in tp["layers"]["moe"].items()})


@pytest.mark.parametrize("inference,b,s", [(True, 3, 24), (True, 1, 1), (False, 2, 64)])
def test_moe_apply_matches_reference(models, inference, b, s):
    """Dropless (inference, one token a row as in decode) and with the
    training capacity, where experts overflow and drop assignments."""
    jm, _, tm, _ = models
    cfg = tm.cfg
    jl, tl = _layer(models, 1)
    rng = np.random.default_rng(s)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    if not inference:  # a shared direction skews the routing past capacity
        x += 3 * rng.standard_normal(cfg.d_model).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want, aux_j = jax.jit(lambda p, x: JM.moe_apply(p, x, jm.cfg, inference=inference))(jl, xj)
    got, aux_t = TM.moe_apply(tl, torch.from_numpy(x).to(torch.bfloat16), cfg,
                              inference=inference)
    want, got = np.asarray(want, np.float32), got.float().numpy()
    # one bf16 step at each token's largest magnitude
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30))) - 7)
    assert np.all(np.abs(got - want) <= step), np.abs(got - want).max()
    assert np.mean(got != want) <= 0.005
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-6)
    c = TM.capacity(s, cfg, inference)
    assert c == JM.capacity(s, jm.cfg, inference)
    if not inference:  # the case drops: some expert takes more than c
        probs = torch.softmax((torch.from_numpy(x).to(torch.bfloat16) @ tl["router"]).float(), -1)
        counts = torch.nn.functional.one_hot(probs.topk(cfg.moe_top_k, -1).indices,
                                             cfg.n_experts).sum((1, 2))
        assert int(counts.max()) > c


def test_capacity_rule(models):
    _, _, tm, _ = models
    cfg = tm.cfg
    assert TM.capacity(100, cfg, inference=True) == 100
    big = 1 << 21  # n_tokens * experts > 2^22: 2x the mean load
    assert TM.capacity(big, cfg, inference=True) == JM.capacity(big, cfg, inference=True)
    assert TM.capacity(64, cfg) == JM.capacity(64, cfg) == 40


def test_plain_forward_matches_reference(models):
    jm, jp, tm, tp = models
    toks = (np.arange(40, dtype=np.int32)[None] * 13) % 512
    pos = np.arange(40, dtype=np.int32)[None]
    xj, _, _ = JT.run_stack(jp, jm.cfg, JT.embed_apply(jp["embed"], jnp.asarray(toks)),
                            jnp.asarray(pos))
    xt = TT.run_stack(tp, tm.cfg, embed_apply(tp["embed"], torch.from_numpy(toks).long()),
                      torch.from_numpy(pos))
    want, got = np.asarray(xj, np.float32), xt.float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= step, (diff.max(), step)
    assert np.mean(diff > 0) <= FORWARD_DIFF_SHARE, np.mean(diff > 0)


def test_params_round_trip_through_convert(models):
    """Every MoE leaf (router, w_gate, w_in, w_out) crosses bit for bit, in
    the reference's stacked layout, and the port's own init draws the same
    tree of shapes and dtypes."""
    _, jp, tm, tp = models
    moe = tp["layers"]["moe"]
    assert sorted(moe) == ["router", "w_gate", "w_in", "w_out"]
    for name, t in moe.items():
        j = np.asarray(jp["layers"]["moe"][name])
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == j.shape
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), j.view(np.int16))
    own = tm.init(device="cpu")
    flat = lambda tree: {k: (tuple(v.shape), v.dtype) for k, v in tree.items()}  # noqa: E731
    assert flat(own["layers"]["moe"]) == flat(moe)
    assert "mlp" not in own["layers"]


@pytest.mark.parametrize("window", [0, 16, 64])
def test_prepare_decode_cache_matches_reference(window):
    """A whole-prompt prefill cache made ready for decode: padded (full
    attention) or folded into a ring of the window (the last window
    prefill tokens at slots pos % window, their positions beside them)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True), attn_window=window)
    jcfg = dataclasses.replace(j_get_config("mixtral-8x7b", smoke=True), attn_window=window)
    rng = np.random.default_rng(window)
    shape = (2, 3, 40, 2, 16)
    k = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)
    jc = {"k": k, "v": v, "len": jnp.int32(40)}
    want = j_prepare(jcfg, jc, 96)
    got = prepare_decode_cache(cfg, params_from_jax(jax.tree_util.tree_map(np.asarray, jc),
                                                    "cpu"), 96)
    assert sorted(got) == sorted(want)
    for name in want:
        if name == "len":
            assert int(got[name]) == int(want[name])
            continue
        np.testing.assert_array_equal(got[name].float().numpy(),
                                      np.asarray(want[name]).astype(np.float32))
