"""The port's VLM family (LLaVA-NeXT-34B SMOKE: the Yi-34B backbone with
precomputed patch embeddings projected and prepended) against the JAX
reference, on the CPU, with the reference's ``PRNGKey(0)`` weights carried
across bit for bit and the patches and tokens drawn from a numpy seed.

Held to the reference: the whole-prompt prefill's logits (within 5e-2)
and caches (every element within one bf16 step, at most 2% differing,
as the dense family's), ``prepare_decode_cache`` bit for bit, and 8
greedy ``serve_step`` tokens after the prefill step; also with the q
heads padded 8 -> 16, as the FULL config pads 56 to 64.  A row's tokens
may part from the reference's only at a near-tie, both sides' logits
recorded: with the heads padded, one row of the trace parts at one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import TRAIN_4K
from repro.configs.base import get_config as j_get_config
from repro.launch.steps import make_prefill_step as j_prefill_step
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model
from repro.models.model import prepare_decode_cache as j_prepare
from repro.models.model import text_len as j_text_len

from repro_torch.configs import get_config
from repro_torch.launch import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.models.frontends import VISION_DIM, fake_patches
from repro_torch.models.model import demo_batch, prepare_decode_cache, text_len

torch.set_num_threads(1)

FORWARD_DIFF_SHARE = 0.02
LOGITS_ATOL = 5e-2
B, TEXT, STEPS = 2, 24, 8


@pytest.fixture(scope="module", params=[0, 16], ids=["heads-8", "pad16"])
def models(request):
    jcfg = dataclasses.replace(j_get_config("llava-next-34b", smoke=True),
                               pad_heads_to=request.param)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(dataclasses.replace(get_config("llava-next-34b", smoke=True),
                                         pad_heads_to=request.param))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _batch(cfg):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab, (B, TEXT)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.n_patches, VISION_DIM)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "patches": jnp.asarray(patches).astype(jnp.bfloat16)},
            {"tokens": torch.from_numpy(tokens),
             "patches": torch.from_numpy(patches).to(torch.bfloat16)})


@pytest.fixture(scope="module")
def prefilled(models):
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    return jb, tb, jax.jit(jm.prefill)(jp, jb), tm.prefill(tp, tb)


def _steps_and_share(want, got):
    want = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    return diff.max() / step, np.mean(diff > 0)


def test_prefill_logits_match_reference(prefilled):
    _, _, (jl, _), (tl, _) = prefilled
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["k", "v"])
def test_prefill_cache_matches_reference(models, prefilled, name):
    """The cache covers the patches and the text: n_patches + TEXT rows."""
    _, _, tm, _ = models
    _, _, (_, jc), (_, tc) = prefilled
    n = tm.cfg.n_patches + TEXT
    assert int(tc["len"]) == int(jc["len"]) == n
    assert tuple(tc[name].shape) == jc[name].shape == (
        tm.cfg.n_layers, B, n, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    steps, share = _steps_and_share(jc[name], tc[name].float().numpy())
    assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (steps, share)


def test_embed_inputs_prepends_projected_patches(models):
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    xj, pj = jax.jit(lambda p, b: JT.embed_inputs(p, jm.cfg, b))(jp, jb)
    xt, pt = TT.embed_inputs(tp, tm.cfg, tb)
    np.testing.assert_array_equal(xt.view(torch.int16).numpy(), np.asarray(xj).view(np.int16))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))


def test_prepare_decode_cache_matches_reference(models, prefilled):
    jm, _, tm, _ = models
    _, _, (_, jc), _ = prefilled
    want = j_prepare(jm.cfg, jc, 64)
    got = prepare_decode_cache(tm.cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jc), "cpu"), 64)
    assert sorted(got) == sorted(want)
    for name in ("k", "v"):
        np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                      np.asarray(want[name]).view(np.int16))
    assert int(got["len"]) == int(want["len"])


def _bf16_step(row) -> float:
    return 2.0 ** (np.floor(np.log2(np.abs(row).max())) - 7)


def greedy_steps(jm, jp, tm, tp, jb, tb, n, steps):
    """``make_prefill_step`` then ``steps`` greedy steps on each side, each
    on its own cache padded to ``n``: the port through ``make_serve_step``
    (its logits read from ``decode`` on a copy of the cache first), the
    reference through ``decode`` and argmax, as its ``serve_step``.
    Returns each side's tokens (steps + 1, B) and logits rows."""
    jtok, jc = jax.jit(j_prefill_step(jm))(jp, jb)
    jc = j_prepare(jm.cfg, jc, n)
    ttok, tc = make_prefill_step(tm)(tp, tb)
    tc = prepare_decode_cache(tm.cfg, tc, n)
    j_decode, t_step = jax.jit(jm.decode), make_serve_step(tm)
    jout, tout, jrows, trows = [np.asarray(jtok)], [ttok.numpy()], [], []
    for _ in range(steps):
        logits, jc = j_decode(jp, jtok, jc)
        jtok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        jrows.append(np.asarray(logits))
        copy = {k: v.clone() for k, v in tc.items()}
        trows.append(tm.decode(tp, ttok, copy)[0].numpy())
        ttok, tc = t_step(tp, ttok, tc)
        jout.append(np.asarray(jtok))
        tout.append(ttok.numpy())
    return np.stack(jout), np.stack(tout), jrows, trows, tc


def assert_tokens_equal_or_tie(jout, tout, jrows, trows):
    """Each batch row's greedy tokens equal the reference's, or part at
    a step where both sides' logits hold the two tokens within one bf16
    step of each other (a near-tie that the last bit of a sum decides);
    the prefill's token must agree."""
    np.testing.assert_array_equal(tout[0], jout[0])
    for b in range(jout.shape[1]):
        j = next((i for i in range(1, len(jout)) if jout[i, b] != tout[i, b]), None)
        if j is None:
            continue
        ta, tb = jout[j, b], tout[j, b]
        for rows in (jrows, trows):
            row = rows[j - 1][b]
            assert abs(row[ta] - row[tb]) <= _bf16_step(row), (b, j, row[ta], row[tb])


def test_greedy_serve_steps_equal_reference(models):
    """``make_prefill_step`` then STEPS greedy ``make_serve_step`` steps
    on each side, each on its own cache: the same tokens (or a parting at
    a near-tie, ``assert_tokens_equal_or_tie``)."""
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    n = tm.cfg.n_patches + TEXT + STEPS
    jout, tout, jrows, trows, tc = greedy_steps(jm, jp, tm, tp, jb, tb, n, STEPS)
    assert_tokens_equal_or_tie(jout, tout, jrows, trows)
    assert int(tc["len"]) == tm.cfg.n_patches + TEXT + STEPS


def test_params_round_trip_and_own_init(models):
    """``patch_proj`` (VISION_DIM, d) crosses bit for bit; the port's own
    init draws the reference's tree of shapes and dtypes."""
    _, jp, tm, tp = models
    np.testing.assert_array_equal(tp["patch_proj"].view(torch.int16).numpy(),
                                  np.asarray(jp["patch_proj"]).view(np.int16))
    assert tuple(tp["patch_proj"].shape) == (VISION_DIM, tm.cfg.d_model)
    own = tm.init(device="cpu")

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = (tuple(v.shape), str(v.dtype))
        return out

    assert flat(own) == flat(tp)


def test_text_len_and_demo_batch(models):
    """The reference's shape helpers: the text budget of a cell and a
    runnable batch with unit-scale patches."""
    jm, _, tm, _ = models
    assert text_len(tm.cfg, TRAIN_4K) == j_text_len(jm.cfg, TRAIN_4K) == 4096 - tm.cfg.n_patches
    assert text_len(tm.cfg, 4096) == 4096 - tm.cfg.n_patches
    with pytest.raises(ValueError, match="too short"):
        text_len(tm.cfg, tm.cfg.n_patches)
    batch = demo_batch(tm.cfg, torch.Generator().manual_seed(0), 3, 10)
    assert tuple(batch["tokens"].shape) == (3, 10) and batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < tm.cfg.vocab and batch["labels"] is batch["tokens"]
    assert tuple(batch["patches"].shape) == (3, tm.cfg.n_patches, VISION_DIM)
    assert batch["patches"].dtype == torch.bfloat16
    again = fake_patches(torch.Generator().manual_seed(0), tm.cfg, 3)
    assert again.dtype == torch.bfloat16 and 0.8 < float(again.float().std()) < 1.2


def test_scheduler_refuses_the_vlm_family(models):
    """As the reference: continuous batching serves the dense-cache
    families; the VLM runs through the step functions."""
    from repro_torch.serving import ContinuousScheduler, EngineConfig

    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="dense-cache families, got 'vlm'"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64), device="cpu")
