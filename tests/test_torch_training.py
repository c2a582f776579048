"""The port's training losses and their gradients against the JAX
reference's ``jax.value_and_grad(model.loss)``, on the CPU, at SMOKE size:
SmolLM-135M, Yi-9B, Nemotron-4-15B (squared ReLU), Mixtral-8x7B (window,
MoE), DeepSeek-MoE-16B (shared experts), LLaVA-NeXT-34B (patch prefix) and
Whisper-tiny (encoder-decoder).  Both sides run the reference's
``PRNGKey(0)`` weights, carried across bit for bit, on one batch made with
numpy from a seed (some labels -1).

Bounds.  The loss within 1e-4 relative (measured at most 6.4e-5, Whisper).
Each parameter's gradient within 3% in relative Frobenius norm and at a
cosine of 0.9995 or more (measured at most 1.4% and at least 0.9999).  Both
sides round at the same points in the forward (bf16 products and stored
activations, float32 norms and softmaxes), and the attention backward is
the reference's custom VJP on both sides (p and ds rounded to bf16); XLA's
autodiff of the rest rounds its bf16 cotangents where torch autograd does
(every bf16 op's gradient in bf16), but the float32 ``exp``, ``rsqrt`` and
sums differ in the last bits, which flips bf16 roundings of activations
and cotangents, and a gradient summed over the batch and the sequence
collects those flips.  The MoE layers run the training capacity (drops),
whose routes are held to the reference's on a trace with drops.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs.base import get_config as j_get_config
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models.model import build_model as j_build_model

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.models.convert import params_from_jax
from repro_torch.tree import leaves_with_paths

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

LOSS_RTOL = 1e-4
GRAD_FROBENIUS = 3e-2
GRAD_COSINE = 0.9995
ARCHS = ("smollm-135m", "yi-9b", "nemotron-4-15b", "mixtral-8x7b", "deepseek-moe-16b",
         "llava-next-34b", "whisper-tiny")


def _batch(cfg, b=2, s=24, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    out["labels"][0, :3] = -1
    if cfg.family == "vlm":
        out["patches"] = rng.normal(0, 1, (b, cfg.n_patches, 1024)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(0, 1, (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _both(batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for k in ("patches", "frames"):
        if k in jb:
            jb[k] = jb[k].astype(jnp.bfloat16)
    return jb, {k: params_from_jax(np.asarray(v), "cpu") for k, v in jb.items()}


def _named(tree) -> dict:
    return {"/".join(p): leaf for p, leaf in leaves_with_paths(tree)}


def _grad_errors(got: dict, want: dict) -> dict:
    out = {}
    for name, w in want.items():
        g = got[name].float().numpy()
        w = np.asarray(w, np.float32)
        nw = float(np.linalg.norm(w))
        out[name] = (float(np.linalg.norm(g - w)) / max(nw, 1e-30),
                     float((g * w).sum()) / max(float(np.linalg.norm(g)) * nw, 1e-30))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    jm = j_build_model(j_get_config(arch, smoke=True))
    jp = jm.init(jax.random.PRNGKey(0))
    tm = build_model(get_config(arch, smoke=True))
    jb, tb = _both(_batch(tm.cfg))
    jl, jg = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    for leaf in _named(tp).values():
        leaf.requires_grad_()
    loss = tm.loss(tp, tb)
    loss.backward()
    assert loss.dtype == torch.float32 and loss.dim() == 0
    loss = float(loss.detach())
    assert abs(loss - float(jl)) <= LOSS_RTOL * abs(float(jl)), (loss, float(jl))
    want = _named(jax.tree_util.tree_map(np.asarray, jg))
    got = {name: leaf.grad for name, leaf in _named(tp).items()}
    assert set(got) == set(want) and all(g is not None for g in got.values())
    for name, (frob, cos) in _grad_errors(got, want).items():
        assert frob <= GRAD_FROBENIUS and cos >= GRAD_COSINE, (name, frob, cos)


def test_chunked_ce_matches_reference():
    """Chunked cross-entropy with a ragged last chunk, a padded vocabulary
    and ignored labels: the value bit for bit in float32 up to summation
    order, the gradient of x and of the head."""
    rng = np.random.default_rng(3)
    b, s, d, vpad, vocab = 2, 37, 32, 80, 70
    x = jnp.asarray(rng.normal(0, 1, (b, s, d)).astype(np.float32)).astype(jnp.bfloat16)
    w = jnp.asarray(rng.normal(0, 0.2, (vpad, d)).astype(np.float32)).astype(jnp.bfloat16)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labels[1, 5:9] = -1
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: JT.chunked_ce(x, w, jnp.asarray(labels), vocab, chunk=16),
        argnums=(0, 1))(x, w)
    tx, tw = (params_from_jax(np.asarray(a), "cpu").requires_grad_() for a in (x, w))
    got = TT.chunked_ce(tx, tw, torch.from_numpy(labels), vocab, chunk=16)
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-6 * abs(float(want))
    for name, g, r in (("x", tx.grad, gx), ("head", tw.grad, gw)):
        r = np.asarray(r, np.float32)
        step = 2.0 ** (np.floor(np.log2(np.abs(r).max())) - 7)
        assert float(np.abs(g.float().numpy() - r).max()) <= step, name


def test_moe_training_capacity_drops_like_reference():
    """The MoE layer at the training capacity (inference=False) on a trace
    long enough to drop: the same capacity, the same dropped assignments
    (capacity order within an expert is token order, ties to the lower
    expert id), outputs within one bf16 step and the load-balance loss in
    float32."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b", smoke=True), capacity_factor=0.5)
    jcfg = dataclasses.replace(j_get_config("mixtral-8x7b", smoke=True), capacity_factor=0.5)
    jp = JMOE.moe_params(jax.random.PRNGKey(1), jcfg, jnp.bfloat16)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(4)
    x = jnp.asarray(rng.normal(0, 1, (2, 64, cfg.d_model)).astype(np.float32)).astype(jnp.bfloat16)
    want, jaux = JMOE.moe_apply(jp, x, jcfg, inference=False)
    got, taux = TMOE.moe_apply(tp, params_from_jax(np.asarray(x), "cpu"), cfg, inference=False)
    c = TMOE.capacity(64, cfg)
    assert c == JMOE.capacity(64, jcfg) and c < 64 * cfg.moe_top_k // cfg.n_experts
    # drops happened: some token's routed terms are missing from its output
    w, g = np.asarray(want, np.float32), got.float().numpy()
    step = 2.0 ** (np.floor(np.log2(np.abs(w).max())) - 7)
    assert float(np.abs(g - w).max()) <= step
    assert (np.abs(w).sum(-1) == 0).any(), "expected tokens dropped by every expert"
    assert abs(float(taux) - float(jaux)) <= 1e-6 * abs(float(jaux))


def test_moe_training_gradients_flow_through_routes():
    """The router, every expert weight and the input take gradients through
    the dispatch (sort, gather, scatter) at the training capacity."""
    cfg = get_config("deepseek-moe-16b", smoke=True)
    tp = TMOE.moe_params(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    for t in _named(tp).values():
        t.requires_grad_()
    x = torch.randn((2, 32, cfg.d_model), generator=torch.Generator().manual_seed(1))
    x = x.to(torch.bfloat16).requires_grad_()
    out, aux = TMOE.moe_apply(tp, x, cfg, inference=False)
    (out.float().square().mean() + aux).backward()
    for name, t in _named(tp).items():
        assert t.grad is not None and float(t.grad.float().abs().sum()) > 0, name
    assert float(x.grad.float().abs().sum()) > 0


def test_remat_changes_memory_not_numbers():
    """The loss and gradients with ``remat`` equal those without, bit for
    bit (the rematerialised segments recompute the same operations)."""
    cfg = get_config("smollm-135m", smoke=True)
    runs = []
    for remat in (True, False):
        m = build_model(dataclasses.replace(cfg, remat=remat))
        p = m.init(torch.Generator().manual_seed(0))
        for t in _named(p).values():
            t.requires_grad_()
        _, tb = _both(_batch(cfg, seed=5))
        loss = m.loss(p, tb)
        loss.backward()
        runs.append((loss.detach(), {k: t.grad for k, t in _named(p).items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for name, g in runs[0][1].items():
        assert torch.equal(g, runs[1][1][name]), name


@pytest.mark.parametrize("arch,family", [("mamba2-1.3b", "ssm"), ("zamba2-7b", "hybrid")])
def test_ssm_and_hybrid_losses_raise_for_the_next_slice(arch, family):
    m = build_model(get_config(arch, smoke=True))
    assert m.cfg.family == family
    with pytest.raises(NotImplementedError, match="SSD-backward training slice") as e:
        m.loss({}, {"tokens": torch.zeros((1, 4), dtype=torch.int32)})
    assert "ROADMAP queue 1" in str(e.value) and "item" not in str(e.value)
