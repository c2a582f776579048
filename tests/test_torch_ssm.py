"""The PyTorch port's SSM (Mamba2) slice against the JAX reference, on the
CPU.

Inputs come from seeded numpy generators and go through both packages:
the SSD scan (the reference's Pallas kernel in interpret mode and its jnp
``ssd_scan``), the Mamba2 block's pieces with the reference's
``PRNGKey(0)`` weights carried across by ``params_from_jax``, and the
``mamba2-1.3b`` smoke config through the prefill and serve step functions.

Tolerances, each with its reason:
- SSD scan: float32 on both sides, sums in another order; the reference's
  own kernel test holds atol 1e-3 (``tests/test_kernels.py``).
- Block pieces and logits: the same bf16 rounding points on both sides, but
  XLA's float32 exp, log1p and rsqrt differ from torch's in the last bit on
  the CPU and the matrix products sum in another order, so a bf16 value can
  round one step apart.  Each element stays within one bf16 step of the
  largest magnitude, and at most BF16_DIFF_SHARE of elements differ at all.
  The smoke model's prefill logits are held to the same cap: on the
  machine this was written on, none of them differ.
- SSM state (float32 on both sides, from the same bf16 inputs): XLA's
  float32 exp and log1p (softplus) differ from torch's in the last bit and
  the scan sums in another order.  Each element stays within
  STATE_RTOL of the largest |state|: measured 3.6e-7 for one block and
  6.5e-6 after the smoke model's two layers, and a wrong decay or a
  dropped chunk moves the state by a tenth of it or more.
- Greedy tokens: equal.  Random weights leave top-2 logit gaps as small as
  one bf16 step, so a machine whose XLA rounds one such logit the other way
  may flip a tie; a token may differ only where the reference's own logits
  of the two tokens are within one bf16 step, and then that prompt's
  trajectories part, which is allowed for at most one prompt (on the
  machine this was written on, every token matched).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.kernels.ssd.ops import ssd as j_ssd_pallas
from repro.kernels.ssd.ref import ssd_ref as j_ssd_ref
from repro.launch.steps import make_prefill_step as j_make_prefill_step
from repro.launch.steps import make_serve_step as j_make_serve_step
from repro.models import layers as JL
from repro.models import ssm as JS
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.kernels.ssd import kernel as SK
from repro_torch.kernels.ssd import ops as SO
from repro_torch.kernels.ssd import ref as SR
from repro_torch.launch import make_prefill_step, make_serve_step
from repro_torch.models import build_model
from repro_torch.models import layers as TL
from repro_torch.models import ssm as TS
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import layer_slice
from repro_torch.models.model import HybridModel
from repro_torch.serving import ContinuousScheduler, EngineConfig

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

SSD_ATOL = 1e-3
BF16_DIFF_SHARE = 0.02
STATE_RTOL = 1e-4
GREEDY_STEPS = 8


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t).astype(np.float32)


def _t(a) -> torch.Tensor:
    """A JAX or numpy array -> a torch tensor of the same bits (bf16 kept)."""
    return params_from_jax(np.asarray(a), "cpu")


def _assert_bf16_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    # one bf16 step at the largest magnitude (bf16 keeps 8 significant
    # bits): the most a single flipped rounding moves a value
    step = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    diff = np.abs(got - want)
    assert diff.max() <= step, (diff.max(), step)
    assert np.mean(diff > 0) <= BF16_DIFF_SHARE, np.mean(diff > 0)


def _assert_state_close(got, want):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=STATE_RTOL * np.abs(want).max())


# ------------------------------------------------------------------ SSD scan


def _ssd_inputs(rng, b, l, h, p, n):
    """The reference kernel test's inputs: unit-normal xdt, b, c and h0,
    da = -|N(0.05, 0.05)|."""
    xdt = rng.normal(0, 1, (b, l, h, p)).astype(np.float32)
    da = -np.abs(rng.normal(0.05, 0.05, (b, l, h))).astype(np.float32)
    b_h = rng.normal(0, 1, (b, l, h, n)).astype(np.float32)
    c_h = rng.normal(0, 1, (b, l, h, n)).astype(np.float32)
    h0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32)
    return xdt, da, b_h, c_h, h0


@pytest.mark.parametrize("chunk", [64, 128])
@pytest.mark.parametrize("l", [256, 192, 200, 45])
def test_ssd_matches_reference_kernel_and_scan(chunk, l):
    """The port's ``ops.ssd`` (its plain version on the CPU) against the
    reference's Pallas ``ssd`` in interpret mode and its ``ssd_scan``, at
    the reference test's shapes with h0; 200 is ragged against both chunks
    and 45 is below one chunk."""
    rng = np.random.default_rng(l * 1000 + chunk)
    ins = _ssd_inputs(rng, 2, l, 4, 32, 16)
    y, hf = SO.ssd(*map(torch.from_numpy, ins), chunk=chunk)
    y_k, h_k = j_ssd_pallas(*map(jnp.asarray, ins[:4]), h0=jnp.asarray(ins[4]), chunk=chunk)
    y_r, h_r = j_ssd_ref(*map(jnp.asarray, ins[:4]), h0=jnp.asarray(ins[4]), chunk=chunk)
    for want_y, want_h in ((y_k, h_k), (y_r, h_r)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SSD_ATOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_h), atol=SSD_ATOL)


def test_ssd_ref_matches_sequential_recurrence():
    """The chunked plain version against the token-by-token recurrence
    (arXiv:2405.21060), zero initial state, a ragged L."""
    rng = np.random.default_rng(9)
    b, l, h, p, n = 1, 70, 2, 8, 4
    xdt, da, b_h, c_h, _ = _ssd_inputs(rng, b, l, h, p, n)
    y, h_final = SR.ssd_ref(*map(torch.from_numpy, (xdt, da, b_h, c_h)), chunk=16)
    state = np.zeros((b, h, n, p), np.float32)
    ys = np.zeros((b, l, h, p), np.float32)
    for t in range(l):
        state = state * np.exp(da[:, t])[:, :, None, None] + np.einsum(
            "bhn,bhp->bhnp", b_h[:, t], xdt[:, t])
        ys[:, t] = np.einsum("bhn,bhnp->bhp", c_h[:, t], state)
    # the reference's own recurrence test holds atol 2e-3: float32, the
    # chunked form sums in another order than the token loop
    np.testing.assert_allclose(y.numpy(), ys, atol=2e-3)
    np.testing.assert_allclose(h_final.numpy(), state, atol=2e-3)


def test_ssd_never_exponentiates_the_masked_half():
    """Large realistic decay (dt·A near -1.6, a chunk's cumsum near -400):
    exp(cum_i - cum_j) for j > i would overflow; the outputs stay finite
    and equal the reference's."""
    rng = np.random.default_rng(3)
    xdt, _, b_h, c_h, h0 = _ssd_inputs(rng, 1, 256, 2, 8, 4)
    da = -rng.uniform(1.0, 1.6, (1, 256, 2)).astype(np.float32)
    y, hf = SO.ssd(*map(torch.from_numpy, (xdt, da, b_h, c_h, h0)), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(hf).all()
    y_r, h_r = j_ssd_ref(*map(jnp.asarray, (xdt, da, b_h, c_h)), h0=jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), atol=SSD_ATOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(h_r), atol=SSD_ATOL)


def test_ssd_wrapper_takes_cuda_tensors_only():
    t = torch.zeros((1, 4, 1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.ssd(t, torch.zeros((1, 4, 1)), t, t, torch.zeros((1, 1, 4, 4)), chunk=4)
    meta = torch.zeros((1, 4, 1, 4), device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        SO.ssd(meta, torch.zeros((1, 4, 1), device="meta"), meta, meta, chunk=4)


# -------------------------------------------------------- Mamba2 block parts


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("mamba2-1.3b", smoke=True)
    jm = j_build_model(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config("mamba2-1.3b", smoke=True))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray(rng.normal(0, scale, shape).astype(np.float32)).astype(jnp.bfloat16)


def test_params_from_jax_carries_the_stacked_ssm_tree_bit_for_bit(models):
    jm, jp, tm, tp = models
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == 16
    for path, leaf in flat_j:
        got = tp
        for key in path:
            got = got[key.key]
        leaf = np.asarray(leaf)
        assert tuple(got.shape) == leaf.shape
        if leaf.dtype == np.float32:
            assert got.dtype == torch.float32
            assert np.array_equal(got.numpy().view(np.int32), leaf.view(np.int32))
        else:
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(), leaf.view(np.int16))
    assert tp["layers"]["ssm"]["a_log"].shape == (2, 4)  # the vmap'd layer axis


def test_port_init_copies_the_reference_decay_and_dt_draws(models):
    """``ssm_params`` draws a_log and dt_bias from default_rng(0), the same
    for every layer, on both sides; d_skip is ones."""
    jm, jp, tm, _ = models
    own = tm.init(device="cpu")
    for name in ("a_log", "dt_bias", "d_skip"):
        assert torch.equal(own["layers"]["ssm"][name],
                           torch.from_numpy(np.array(jp["layers"]["ssm"][name])))
    assert own["layers"]["ssm"]["wz"].dtype == torch.bfloat16
    assert own["embed"]["table"].shape == (512, 64)


def test_gated_rmsnorm_matches_reference(models):
    rng = np.random.default_rng(1)
    scale = _bf16(rng, (128,)) + 1
    x, z = _bf16(rng, (3, 17, 128), 2.0), _bf16(rng, (3, 17, 128), 2.0)
    want = JL.gated_rmsnorm(x, z, {"scale": scale})
    got = TL.gated_rmsnorm(_t(x), _t(z), {"scale": _t(scale)})
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, want)


def test_causal_conv_and_conv_step_match_reference(models):
    _, jp, _, tp = models
    rng = np.random.default_rng(2)
    k_j = jp["layers"]["ssm"]["conv_x"][0]
    k_t = tp["layers"]["ssm"]["conv_x"][0]
    u = _bf16(rng, (2, 23, 128), 2.0)
    got = TS._causal_conv(_t(u), k_t)
    assert got.dtype == torch.bfloat16
    _assert_bf16_close(got, jax.jit(JS._causal_conv)(u, k_j))
    tail, u_t = _bf16(rng, (2, 3, 128), 2.0), _bf16(rng, (2, 128), 2.0)
    out_j, tail_j = jax.jit(JS._conv_step)(u_t, tail, k_j)
    out_t, tail_t = TS._conv_step(_t(u_t), _t(tail), k_t)
    _assert_bf16_close(out_t, out_j)
    assert np.array_equal(_np(tail_t), _np(tail_j))


@pytest.mark.parametrize("with_initial", [False, True])
def test_ssm_apply_matches_reference(models, with_initial):
    """The whole block over a 45-token sequence (two chunks of 32, the
    second ragged), fresh or continuing from a cache."""
    jm, jp, tm, tp = models
    cfg = tm.cfg
    rng = np.random.default_rng(4)
    lp_j = jax.tree_util.tree_map(lambda t: t[0], jp["layers"]["ssm"])
    lp_t = layer_slice(tp["layers"]["ssm"], 0)
    x = _bf16(rng, (2, 45, cfg.d_model))
    init_j = init_t = None
    if with_initial:
        init_j = {
            "state": jnp.asarray(rng.normal(0, 0.5, (2, 4, 16, 32)).astype(np.float32)),
            "conv_x": _bf16(rng, (2, 3, 128)),
            "conv_b": _bf16(rng, (2, 3, 16)),
            "conv_c": _bf16(rng, (2, 3, 16)),
        }
        init_t = {k: _t(v) for k, v in init_j.items()}
    out_j, cache_j = jax.jit(lambda p, x, i: JS.ssm_apply(p, x, jm.cfg, initial=i))(
        lp_j, x, init_j)
    out_t, cache_t = TS.ssm_apply(lp_t, _t(x), cfg, initial=init_t)
    _assert_bf16_close(out_t, out_j)
    for key in ("conv_x", "conv_b", "conv_c"):
        _assert_bf16_close(cache_t[key], cache_j[key])
    _assert_state_close(cache_t["state"], cache_j["state"])


def test_ssm_apply_short_sequence_keeps_the_conv_tail(models):
    """Two tokens after a cache: the conv tail reaches back into it."""
    _, _, tm, tp = models
    lp = layer_slice(tp["layers"]["ssm"], 0)
    init = TS.ssm_init_cache(tm.cfg, 2, "cpu")
    init["conv_x"] = torch.randn(init["conv_x"].shape).to(torch.bfloat16)
    x = torch.randn((2, 2, tm.cfg.d_model)).to(torch.bfloat16)
    _, cache = TS.ssm_apply(lp, x, tm.cfg, initial=init)
    xr = x @ lp["wx"]
    assert torch.equal(cache["conv_x"], torch.cat([init["conv_x"][:, 2:], xr], dim=1))


# -------------------------------------------------------- the whole slice


def _prompts(b=3, l=40):
    return np.random.default_rng(0).integers(0, 512, (b, l)).astype(np.int32)


@pytest.fixture(scope="module")
def served(models):
    """Both packages through their prefill and serve steps, greedy, each
    feeding back its own tokens; the reference's logits at every step."""
    jm, jp, tm, tp = models
    prompts = _prompts()
    j_pre, j_srv = jax.jit(j_make_prefill_step(jm)), jax.jit(j_make_serve_step(jm))
    j_pre_logits, j_dec_logits = jax.jit(jm.prefill), jax.jit(jm.decode)
    t_pre, t_srv = make_prefill_step(tm), make_serve_step(tm)
    batch_j, batch_t = {"tokens": jnp.asarray(prompts)}, {"tokens": torch.from_numpy(prompts)}
    tok_j, cache_j = j_pre(jp, batch_j)
    tok_t, cache_t = t_pre(tp, batch_t)
    pre_logits_j = np.asarray(j_pre_logits(jp, batch_j)[0])
    out = {"pre_logits_j": pre_logits_j, "pre_logits_t": tm.prefill(tp, batch_t)[0],
           "cache_j": cache_j, "cache_t": cache_t,
           "tokens_j": [np.asarray(tok_j)], "tokens_t": [tok_t.numpy()],
           "logits_j": [pre_logits_j]}
    for _ in range(GREEDY_STEPS):
        out["logits_j"].append(np.asarray(j_dec_logits(jp, tok_j, cache_j)[0]))
        tok_j, cache_j = j_srv(jp, tok_j, cache_j)
        tok_t, cache_t = t_srv(tp, tok_t, cache_t)
        assert tok_t.dtype == torch.int32
        out["tokens_j"].append(np.asarray(tok_j))
        out["tokens_t"].append(tok_t.numpy())
    return out


def test_smoke_prefill_logits_and_cache_match_reference(served):
    _assert_bf16_close(served["pre_logits_t"], served["pre_logits_j"])
    cj, ct = served["cache_j"], served["cache_t"]
    assert int(ct["len"]) == int(cj["len"]) == 40
    for key in ("conv_x", "conv_b", "conv_c"):
        assert ct["layers"][key].dtype == torch.bfloat16
        _assert_bf16_close(ct["layers"][key], cj["layers"][key])
    _assert_state_close(ct["layers"]["state"], cj["layers"]["state"])


def test_smoke_greedy_tokens_match_reference(served):
    """Prefill then 8 serve steps on 3 prompts: equal greedy tokens, with
    the one exception the module docstring states (a reference near-tie)."""
    toks_j = np.stack(served["tokens_j"], axis=1)  # (B, 1 + steps)
    toks_t = np.stack(served["tokens_t"], axis=1)
    logits = np.stack(served["logits_j"], axis=1)  # (B, 1 + steps, V)
    parted = 0
    for row in range(toks_j.shape[0]):
        for s in range(toks_j.shape[1]):
            a, b = toks_j[row, s], toks_t[row, s]
            if a == b:
                continue
            lg = logits[row, s]
            step = 2.0 ** (np.floor(np.log2(np.abs(lg).max())) - 7)
            assert lg[a] - lg[b] <= step, (row, s, lg[a], lg[b])
            parted += 1
            break
    assert parted <= 1, (toks_j, toks_t)


def test_port_prefill_decode_consistency(models):
    """decode(prefill(prompt[:-1]), prompt[-1]) logits == prefill(prompt):
    the reference's consistency test (``tests/test_models.py``), on the
    port: the scan's h_final and conv tails are what decode continues from."""
    _, _, tm, tp = models
    tokens = torch.from_numpy(_prompts(2, 64))
    full, _ = tm.prefill(tp, {"tokens": tokens})
    _, cache = tm.prefill(tp, {"tokens": tokens[:, :-1]})
    step, _ = tm.decode(tp, tokens[:, -1], cache)
    # the reference's own tolerance (``tests/test_models.py``): the step and
    # the scan put their bf16 roundings at different points
    np.testing.assert_allclose(step.numpy(), full.numpy(), atol=0.05, rtol=0.02)


def test_logits_cover_the_padded_vocab_unmasked():
    """Like the reference, the SSM head takes logits over the padded
    vocabulary with no mask (full width: 50280 -> 50432)."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", smoke=True), vocab=500,
                              pad_vocab_to=256)
    model = build_model(cfg)
    params = model.init(device="cpu")
    logits, _ = model.prefill(params, {"tokens": torch.zeros((1, 5), dtype=torch.int32)})
    assert logits.shape == (1, 512) and torch.isfinite(logits).all()
    assert get_config("mamba2-1.3b").vocab_padded == 50432


# ------------------------------------------------------- configs and surface


@pytest.mark.parametrize("smoke", [False, True])
def test_config_equals_reference(smoke):
    got = dataclasses.asdict(get_config("mamba2-1.3b", smoke=smoke))
    want = dataclasses.asdict(j_get_config("mamba2-1.3b", smoke=smoke))
    assert got == want


def test_init_without_a_device_needs_a_gpu(models):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, _, tm, _ = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tm.init(device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tm.init_cache(2)


def test_init_refuses_a_device_other_than_the_generators(models):
    _, _, tm, _ = models
    with pytest.raises(ValueError, match="differs from the generator"):
        tm.init(torch.Generator(), device="cuda")
    own = tm.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(own["embed"]["table"], tm.init(device="cpu")["embed"]["table"])


def test_scheduler_refuses_the_ssm_family(models):
    _, _, tm, tp = models
    with pytest.raises(NotImplementedError, match="family-specific"):
        ContinuousScheduler(tm, tp, EngineConfig(max_ctx=64), device="cpu")


def test_hybrid_family_builds_a_hybrid_model(models):
    """The SSM config under the hybrid family builds the ported hybrid model
    (tests/test_torch_hybrid.py holds it to the reference)."""
    _, _, tm, _ = models
    assert isinstance(build_model(dataclasses.replace(tm.cfg, family="hybrid")), HybridModel)
