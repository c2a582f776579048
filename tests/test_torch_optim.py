"""The port's optimiser, gradient utilities, training step and data pipeline
against the JAX reference's, on the CPU.

Bounds.  AdamW from the same gradients and the same optimiser state
(carried across bit for bit, ``models.convert.opt_state_from_jax``): the
gradient norm and the learning rate are float32 arithmetic held to 2e-6
relative (XLA sums the squares in another order, and its float32 ``pow``,
``sqrt`` and ``cos`` may differ from torch's in the last bit); the clip
scale then differs in its last bit, so the moments are held to 1e-5
relative or 1e-5 of each leaf's largest magnitude (a moment where
gradients of opposite sign cancel keeps the absolute difference, not the
relative one; 3.4e-6 relative measured on the second moments); the bf16
parameters within one bf16 step (or 1e-6 of the leaf's largest
magnitude, where an update cancels a weight to near zero), and equal in
all but 0.1% of elements (0.016% measured).  The training
step (SmolLM-135M SMOKE, three AdamW steps from the reference's weights,
two micro-batches) holds the first step's loss to 1e-4 relative, the
later steps' to 1e-3 (their weights have parted by bf16 roundings where
the updates differ; 1.8e-4 measured), and each parameter's update (new
minus initial) to 10% in relative Frobenius norm and a cosine of 0.995
(5.9% and 0.9983 measured, on wk): the gradients match within about 1%
(``tests/test_torch_training.py``), Adam's early steps are nearly
sign(g) x lr, so a gradient near zero that parts in sign moves its
element by a whole step, and a step of 3e-3 is about one bf16 step of a
weight near 1, so each update is itself quantised.  Data and tokens: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import ShardedLoader as JLoader
from repro.data import synthetic_corpus as j_corpus
from repro.data.tokenizer import ByteTokenizer as JTokenizer
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.model import build_model as j_build_model
from repro.optim import adamw as JA
from repro.optim import grad_utils as JG

from repro_torch.configs import get_config
from repro_torch.data import ByteTokenizer, DataConfig, ShardedLoader, synthetic_corpus
from repro_torch.launch import make_train_step
from repro_torch.models import build_model
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.optim import adamw as TA
from repro_torch.optim import grad_utils as TG
from repro_torch.tree import leaves_with_paths

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

F32_RTOL = 2e-6
MOMENT_OF_MAX = 1e-5
BF16_DIFF_SHARE = 1e-3
STEP_LOSS_RTOL = 1e-4
LATER_LOSS_RTOL = 1e-3
UPDATE_FROBENIUS = 0.1
UPDATE_COSINE = 0.995


def _named(tree) -> dict:
    return {"/".join(p): leaf for p, leaf in leaves_with_paths(tree)}


def _np(tree) -> dict:
    return {k: np.asarray(v, np.float32) for k, v in _named(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _t(tree):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def smollm():
    jm = j_build_model(j_get_config("smollm-135m", smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, build_model(get_config("smollm-135m", smoke=True)), _t(jp)


def _grads(jp, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(0, 0.05, p.shape).astype(np.float32)).astype(p.dtype),
        jp)


def _bf16_close(got: dict, want: dict):
    for name, w in want.items():
        g = got[name].float().numpy()
        step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
        # an update that cancels a weight to near zero keeps the float32
        # difference of the operands, not one of the result
        assert (np.abs(g - w) <= np.maximum(step, 1e-6 * np.abs(w).max())).all(), name
        assert (g != w).mean() <= BF16_DIFF_SHARE, (name, (g != w).mean())


@pytest.mark.parametrize("steps", [1, 4])
def test_adamw_update_matches_reference(smollm, steps):
    """One and several updates from the same gradients (clipping active at
    clip_norm 1, warmup 2 and a cosine tail): params, moments, grad_norm
    and lr."""
    _, jp, _, tp = smollm
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=1.0)
    jcfg, tcfg = JA.AdamWConfig(**cfg), TA.AdamWConfig(**cfg)
    js = JA.adamw_init(jp)
    ts = opt_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    for i in range(steps):
        g = _grads(jp, i)
        jp, js, jm_ = JA.adamw_update(g, js, jp, jcfg)
        tp, ts, tm_ = TA.adamw_update(_t(g), ts, tp, tcfg)
        assert float(tm_["grad_norm"]) > 1.0  # clipping acts
        for key in ("grad_norm", "lr"):
            assert abs(float(tm_[key]) - float(jm_[key])) <= F32_RTOL * abs(float(jm_[key]))
    assert int(ts["step"]) == int(js["step"]) == steps
    for part in ("m", "v"):
        want, got = _np(js[part]), _named(ts[part])
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w, rtol=MOMENT_OF_MAX,
                                       atol=MOMENT_OF_MAX * float(np.abs(w).max()),
                                       err_msg=f"{part} {name}")
    _bf16_close(_named(tp), _np(jp))


def test_schedule_and_clipping_match_reference():
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        want = float(JA.schedule(JA.AdamWConfig(**cfg), jnp.int32(s)))
        got = float(TA.schedule(TA.AdamWConfig(**cfg), torch.tensor(s, dtype=torch.int32)))
        assert abs(got - want) <= F32_RTOL * max(abs(want), 1e-6), s
    rng = np.random.default_rng(2)
    tree = {"a": rng.normal(0, 3, (64,)).astype(np.float32),
            "b": {"c": rng.normal(0, 1, (8, 8)).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = {"a": torch.from_numpy(tree["a"]), "b": {"c": torch.from_numpy(tree["b"]["c"])}}
    for max_norm in (1.0, 1e6):
        (jc, jn), (tc, tn) = JG.clip_by_global_norm(jt, max_norm), TG.clip_by_global_norm(tt, max_norm)
        assert abs(float(tn) - float(jn)) <= F32_RTOL * float(jn)
        np.testing.assert_allclose(tc["b"]["c"].numpy(), np.asarray(jc["b"]["c"]), rtol=F32_RTOL)
    assert abs(float(TG.global_norm(TG.clip_by_global_norm(tt, 1.0)[0])) - 1.0) <= 1e-5


def test_ef_int8_matches_reference():
    rng = np.random.default_rng(5)
    g = rng.normal(0, 1, (300,)).astype(np.float32)
    err = rng.normal(0, 0.01, (300,)).astype(np.float32)
    jq, js_, je = JG.compress_int8(jnp.asarray(g), jnp.asarray(err))
    tq, ts_, te = TG.compress_int8(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert float(ts_) == float(js_)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(TG.decompress_int8(tq, ts_).numpy(),
                                  np.asarray(JG.decompress_int8(jq, js_)))
    tree = {"w": torch.from_numpy(g), "b": torch.from_numpy(err)}
    q, s, e = TG.ef_compress_tree(tree, TG.ef_init(tree))
    assert q["w"].dtype == torch.int8 and set(s) == {"w", "b"} and e["b"].dtype == torch.float32
    # the residual carries: the mean of 50 reconstructions converges
    e, acc = torch.zeros(300), torch.zeros(300)
    for _ in range(50):
        q1, s1, e = TG.compress_int8(torch.from_numpy(g), e)
        acc = acc + TG.decompress_int8(q1, s1)
    np.testing.assert_allclose((acc / 50).numpy(), g, atol=1e-2)


def test_accumulate_grads_matches_reference_and_full_batch():
    """Two micro-batches: the float32 sums scaled by 1/2 equal the
    reference's scan, and the full batch's loss and gradients within
    float32 rounding (a mean over the batch)."""
    rng = np.random.default_rng(6)
    w = rng.normal(0, 1, (8, 4)).astype(np.float32)
    batch = {"x": rng.normal(0, 1, (12, 8)).astype(np.float32),
             "y": rng.normal(0, 1, (12, 4)).astype(np.float32)}

    def jloss(p, b):
        return jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    def tloss(p, b):
        return torch.mean((b["x"] @ p["w"] - b["y"]) ** 2)

    jb = jax.tree_util.tree_map(jnp.asarray, batch)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jl, jg = JG.accumulate_grads(jloss, {"w": jnp.asarray(w)}, jb, 2)
    tl, tg = TG.accumulate_grads(tloss, {"w": torch.from_numpy(w)}, tb, 2)
    assert abs(float(tl) - float(jl)) <= 1e-6 * float(jl)
    np.testing.assert_allclose(tg["w"].numpy(), np.asarray(jg["w"]), rtol=1e-5, atol=1e-7)
    fl, fg = TG.accumulate_grads(tloss, {"w": torch.from_numpy(w)}, tb, 1)
    assert abs(float(tl) - float(fl)) <= 1e-5 * float(fl)
    np.testing.assert_allclose(tg["w"].numpy(), fg["w"].numpy(), rtol=1e-4, atol=1e-6)
    with pytest.raises(ValueError, match="n_micro"):
        TG.accumulate_grads(tloss, {"w": torch.from_numpy(w)}, tb, 5)


def test_accumulate_model_grads_matches_reference(smollm):
    """SmolLM SMOKE's loss through accumulate_grads at n_micro 2: the loss and
    every gradient leaf against the reference's."""
    jm, jp, tm, tp = smollm
    rng = np.random.default_rng(7)
    toks = rng.integers(0, tm.cfg.vocab, (4, 16)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jl, jg = JG.accumulate_grads(jm.loss, jp, jax.tree_util.tree_map(jnp.asarray, batch), 2)
    tl, tg = TG.accumulate_grads(tm.loss, tp, {k: torch.from_numpy(v) for k, v in batch.items()}, 2)
    assert abs(float(tl) - float(jl)) <= STEP_LOSS_RTOL * float(jl)
    want, got = _np(jg), _named(tg)
    for name, w in want.items():
        g = got[name].numpy()
        assert got[name].dtype == torch.float32
        assert np.linalg.norm(g - w) <= 3e-2 * np.linalg.norm(w), name


def test_make_train_step_matches_reference(smollm):
    """Three steps of make_train_step (two micro-batches, warmup 1): the
    losses and each parameter's accumulated update against the
    reference's."""
    jm, jp, tm, tp = smollm
    jcfg = JA.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    tcfg = TA.AdamWConfig(lr=3e-3, warmup_steps=1, total_steps=10)
    jstep, tstep = j_make_train_step(jm, jcfg, n_micro=2), make_train_step(tm, tcfg, n_micro=2)
    js, ts = JA.adamw_init(jp), TA.adamw_init(tp)
    loader = ShardedLoader(DataConfig(vocab=tm.cfg.vocab, seq_len=16, global_batch=4))
    j0, t0 = _np(jp), {k: v.float().numpy() for k, v in _named(tp).items()}
    jparams, tparams = jp, tp
    for i in range(3):
        b = loader.batch_at(i)
        jparams, js, jmet = jstep(jparams, js, jax.tree_util.tree_map(jnp.asarray, b))
        tparams, ts, tmet = tstep(tparams, ts, {k: torch.from_numpy(v) for k, v in b.items()})
        # the first step from the same weights; later ones from weights
        # whose bf16 roundings parted where the updates did
        rtol = STEP_LOSS_RTOL if i == 0 else LATER_LOSS_RTOL
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= rtol * float(jmet["loss"]), i
        assert abs(float(tmet["lr"]) - float(jmet["lr"])) <= F32_RTOL * float(jmet["lr"])
    want, got = _np(jparams), _named(tparams)
    for name, w in want.items():
        du_w = w - j0[name]
        du_g = got[name].float().numpy() - t0[name]
        assert np.linalg.norm(du_g - du_w) <= UPDATE_FROBENIUS * np.linalg.norm(du_w), name
        cos = float((du_g * du_w).sum()) / float(np.linalg.norm(du_g) * np.linalg.norm(du_w))
        assert cos >= UPDATE_COSINE, (name, cos)


# ---------------------------------------------------------------------------
# Data and tokenizer: copies of the reference's NumPy code
# ---------------------------------------------------------------------------


def test_corpus_and_loader_are_the_reference_bit_for_bit():
    kw = dict(vocab=1000, seq_len=64, global_batch=8, n_hosts=2, seed=3)
    jc, tc = j_corpus(JDataConfig(**kw), 100_000), synthetic_corpus(DataConfig(**kw), 100_000)
    np.testing.assert_array_equal(tc, jc)
    for host in (0, 1):
        jl = JLoader(JDataConfig(**kw), host=host, corpus=jc)
        tl = ShardedLoader(DataConfig(**kw), host=host, corpus=tc)
        for step in (0, 3, 17):
            jb, tb = jl.batch_at(step), tl.batch_at(step)
            for key in ("tokens", "labels"):
                assert tb[key].dtype == jb[key].dtype
                np.testing.assert_array_equal(tb[key], jb[key])
    # state is one integer, and restore resumes exactly
    a, b = ShardedLoader(DataConfig(**kw), corpus=tc), ShardedLoader(DataConfig(**kw), corpus=tc)
    next(a), next(a)
    b.restore(a.state())
    np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    assert a.state() == {"step": 3}


def test_default_corpus_is_the_reference():
    kw = dict(vocab=512, seq_len=32, global_batch=2, seed=1)
    jb, tb = JLoader(JDataConfig(**kw)).batch_at(5), ShardedLoader(DataConfig(**kw)).batch_at(5)
    np.testing.assert_array_equal(tb["tokens"], jb["tokens"])


@pytest.mark.parametrize("vocab", [259, 512, 64000])
def test_tokenizer_is_the_reference(vocab):
    text = "hello compression-aware memory controller é中 " * 3
    got, want = ByteTokenizer(vocab).encode(text), JTokenizer(vocab).encode(text)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    if vocab <= 512:
        assert ByteTokenizer(vocab).decode_bytes(got) == JTokenizer(vocab).decode_bytes(want)
