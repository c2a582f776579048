"""The port's enc-dec family (Whisper-tiny SMOKE) against the JAX
reference, on the CPU, with the reference's ``PRNGKey(0)`` weights carried
across bit for bit and the frames and tokens drawn from a numpy seed.

Held to the reference: the encoder's output, the whole-prompt prefill's
logits (within 5e-2) and its four caches, the cross attention's
``cross_k``/``cross_v`` among them (every element within one bf16 step,
at most 2% differing), ``prepare_decode_cache`` bit for bit, 8 greedy
``serve_step`` tokens (or a parting at a near-tie, both sides' logits
recorded, as in ``tests/test_torch_vlm.py``), the bidirectional decode
attention, the tanh GELU over every normal bf16 input bit for bit, and the
sinusoidal positions.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import PREFILL_32K
from repro.configs.base import get_config as j_get_config
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models.model import build_model as j_build_model
from repro.models.model import prepare_decode_cache as j_prepare
from repro.models.model import text_len as j_text_len

from repro_torch.configs import get_config
from repro_torch.models import attention as TA
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from repro_torch.models.convert import params_from_jax
from repro_torch.models.frontends import fake_frames
from repro_torch.models.layers import gelu_tanh, sinusoidal_positions
from repro_torch.models.model import demo_batch, prepare_decode_cache, text_len

from test_torch_vlm import assert_tokens_equal_or_tie, greedy_steps

torch.set_num_threads(1)

FORWARD_DIFF_SHARE = 0.02
LOGITS_ATOL = 5e-2
B, FRAMES, TEXT, STEPS = 2, 48, 20, 8


@pytest.fixture(scope="module")
def models():
    jm = j_build_model(j_get_config("whisper-tiny", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("whisper-tiny", smoke=True))
    return jm, jp, tm, params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _batch(cfg, text=TEXT):
    rng = np.random.default_rng(9)
    tokens = rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)
    frames = rng.standard_normal((B, FRAMES, cfg.d_model)).astype(np.float32)
    return ({"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames).astype(jnp.bfloat16)},
            {"tokens": torch.from_numpy(tokens),
             "frames": torch.from_numpy(frames).to(torch.bfloat16)})


def _steps_and_share(want, got):
    want = np.asarray(want, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    return diff.max() / step, np.mean(diff > 0)


@pytest.fixture(scope="module")
def prefilled(models):
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    return jax.jit(jm.prefill)(jp, jb), tm.prefill(tp, tb)


def test_encoder_matches_reference(models):
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    want = jax.jit(lambda p, f: JE.encode(p, jm.cfg, f))(jp, jb["frames"])
    got = TE.encode(tp, tm.cfg, tb["frames"])
    steps, share = _steps_and_share(want, got.float().numpy())
    assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (steps, share)


def test_prefill_logits_match_reference(prefilled):
    (jl, _), (tl, _) = prefilled
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGITS_ATOL, rtol=0)


@pytest.mark.parametrize("name", ["self_k", "self_v", "cross_k", "cross_v"])
def test_prefill_cache_matches_reference(models, prefilled, name):
    _, _, tm, _ = models
    (_, jc), (_, tc) = prefilled
    assert sorted(tc) == sorted(jc)
    assert int(tc["len"]) == int(jc["len"]) == TEXT
    rows = TEXT if name.startswith("self") else FRAMES
    assert tuple(tc[name].shape) == jc[name].shape == (
        tm.cfg.n_layers, B, rows, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    steps, share = _steps_and_share(jc[name], tc[name].float().numpy())
    assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (steps, share)


def test_prepare_decode_cache_matches_reference(models, prefilled):
    """The decoder's self-attention rows padded, the cross rows as they
    are."""
    jm, _, tm, _ = models
    (_, jc), _ = prefilled
    want = j_prepare(jm.cfg, jc, 40)
    got = prepare_decode_cache(tm.cfg, params_from_jax(
        jax.tree_util.tree_map(np.asarray, jc), "cpu"), 40)
    assert sorted(got) == sorted(want)
    for name in ("self_k", "self_v", "cross_k", "cross_v"):
        assert tuple(got[name].shape) == want[name].shape
        np.testing.assert_array_equal(got[name].view(torch.int16).numpy(),
                                      np.asarray(want[name]).view(np.int16))
    assert got["self_k"].shape[2] == 40 and got["cross_k"].shape[2] == FRAMES


def test_greedy_serve_steps_equal_reference(models):
    jm, jp, tm, tp = models
    jb, tb = _batch(tm.cfg)
    jout, tout, jrows, trows, tc = greedy_steps(jm, jp, tm, tp, jb, tb, TEXT + STEPS, STEPS)
    assert_tokens_equal_or_tie(jout, tout, jrows, trows)
    assert int(tc["len"]) == TEXT + STEPS


def test_decode_overrunning_the_cache_raises(models, prefilled):
    """A prefill cache has no room for the next token until padded (the
    reference's dynamic_update_slice would clamp the write silently)."""
    _, _, tm, tp = models
    _, (_, tc) = prefilled
    cache = {k: v.clone() for k, v in tc.items()}
    with pytest.raises(ValueError, match="prepare_decode_cache"):
        tm.decode(tp, torch.zeros(B, dtype=torch.int64), cache)


@pytest.mark.parametrize("bidirectional", [True, False])
def test_decode_attention_bidirectional_matches_reference(bidirectional):
    """One query over a cache: bidirectional sees every valid key, causal
    only those at or before its position."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, 30, 2, 16)).astype(np.float32)
    q_pos = np.array([[5], [20]], np.int32)
    bf = jnp.bfloat16
    want = JA.decode_attention(jnp.asarray(q).astype(bf), jnp.asarray(k).astype(bf),
                               jnp.asarray(v).astype(bf), q_pos=jnp.asarray(q_pos),
                               kv_valid=27, bidirectional=bidirectional)
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)]
    got = TA.decode_attention(*t, q_pos=torch.from_numpy(q_pos), kv_valid=27,
                              bidirectional=bidirectional)
    steps, share = _steps_and_share(want, got.float().numpy())
    assert steps <= 1 and share <= FORWARD_DIFF_SHARE, (steps, share)
    if bidirectional:  # row 0 at position 5 sees keys past it
        causal = TA.decode_attention(*t, q_pos=torch.from_numpy(q_pos), kv_valid=27)
        assert not torch.equal(causal[0], got[0])


def test_gelu_matches_xla_on_every_normal_bf16_input():
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(np.int16)
    x = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    x = x[torch.isfinite(x) & (x.float().abs() > 1e-37)]  # XLA flushes subnormals
    want = jax.jit(jax.nn.gelu)(jnp.asarray(x.view(torch.int16).numpy()).view(jnp.bfloat16))
    np.testing.assert_array_equal(gelu_tanh(x).view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


@pytest.mark.parametrize("s,d", [(1500, 384), (40, 64)])
def test_sinusoidal_positions_match_reference(s, d):
    """float32 throughout; XLA's sin and cos of large angles differ from
    torch's in the last bits (1.2e-4 at position 1,499)."""
    want = np.asarray(JL.sinusoidal_positions(s, d))
    got = sinusoidal_positions(s, d).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)


def test_params_round_trip_and_own_init(models):
    """Both stacks cross bit for bit; the port's own init draws the
    reference's tree of shapes and dtypes (GELU MLPs: w_in, w_out)."""
    _, jp, tm, tp = models

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = v
        return out

    j, t = flat(jax.tree_util.tree_map(np.asarray, jp)), flat(tp)
    assert sorted(j) == sorted(t)
    assert any(k.startswith("enc_layers/") for k in t) and "dec_layers/cross_attn/wq" in t
    for k in j:
        np.testing.assert_array_equal(t[k].view(torch.int16).numpy(), j[k].view(np.int16))
    own = flat(tm.init(device="cpu"))
    assert {k: (tuple(v.shape), v.dtype) for k, v in own.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in t.items()}
    assert "dec_layers/mlp/w_gate" not in own


def test_text_len_demo_batch_frames_and_loss(models):
    jm, jp, tm, tp = models
    assert text_len(tm.cfg, PREFILL_32K) == j_text_len(jm.cfg, PREFILL_32K) == 32768 - 1500
    batch = demo_batch(tm.cfg, torch.Generator().manual_seed(1), 2, 12)
    assert tuple(batch["frames"].shape) == (2, tm.cfg.enc_seq, tm.cfg.d_model)
    frames = fake_frames(torch.Generator().manual_seed(1), tm.cfg, 2)
    assert frames.dtype == torch.bfloat16
    with pytest.raises(NotImplementedError, match="training slice"):
        tm.loss(tp, batch)


def test_scheduler_refuses_the_encdec_family(models):
    """As the reference: continuous batching serves the dense-cache
    families; Whisper runs through the step functions."""
    from repro_torch.serving import ContinuousScheduler, EngineConfig

    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="dense-cache families, got 'encdec'"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64), device="cpu")
