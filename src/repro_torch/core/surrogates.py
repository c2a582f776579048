"""Statistically matched surrogate data (DESIGN.md §5 honesty ledger).

Real LLaMA/Mixtral checkpoints and WikiText/BookSum are unavailable offline,
so the compression experiments run on surrogates whose *relevant statistics*
match published LLM data:

* Weights: per-tensor zero-mean Gaussian mixtures with layer-dependent scale
  and a sparse set of outlier columns (the well-documented activation-outlier
  structure).  What matters for bit-plane compression is the exponent
  distribution: for N(0, sigma) in BF16 the exponent concentrates on ~6-8
  values regardless of sigma, which is exactly why trained-checkpoint
  exponent planes compress ~1.3x while naive byte streams barely do.

* KV cache: per-channel mean/scale structure with strong cross-token
  correlation (KIVI/KVQuant observation the paper builds on).  Channel j of
  token t is  mu_j + rho * (x_{t-1,j} - mu_j) + eps — an AR(1) process per
  channel, with per-channel sigma_j drawn log-normal and a heavy-tailed
  subset of high-variance channels.  rho is calibrated (see
  benchmarks/fig7_kv_clustering.py) so the *baseline* ZSTD ratio lands in the
  paper's 1.2-1.33 band before any clustering numbers are read off.

KV tensors are additionally produced by running the repo's own models
(tests/benchmarks use both sources and report them separately).

The port imports no NumPy bf16 extension package: a bf16 surrogate is
rounded from float32 by torch (round to nearest even, as the reference's
extension type rounds) and returned as
its raw ``uint16`` bit patterns, and an fp8 surrogate as its ``uint8``
patterns — the form the host-side store takes (``core.bitplane``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.bitplane import BF16, FP8_E4M3, FloatSpec

#: the surrogates' default storage type (values come back as uint16 bits)
BFLOAT16 = "bfloat16"


def _cast(x: np.ndarray, dtype) -> np.ndarray:
    """float32 ``x`` in the storage type ``dtype``: bf16 as uint16 bit
    patterns (torch rounds to nearest even), any NumPy dtype by ``astype``."""
    if dtype == BFLOAT16:
        t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
        return t.view(torch.int16).numpy().view(np.uint16)
    return x.astype(dtype)


def gaussian_weights(
    shape: tuple,
    seed: int = 0,
    sigma: float = 0.02,
    outlier_frac: float = 0.005,
    outlier_scale: float = 8.0,
    dtype=BFLOAT16,
) -> np.ndarray:
    """Trained-transformer-like weight surrogate.

    sigma ~ 0.02 matches typical initialisation-plus-training scales of
    attention/MLP matrices; a small fraction of columns carries ~8x larger
    scale (outlier channels).
    """
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, sigma, size=shape).astype(np.float32)
    if w.ndim >= 2 and outlier_frac > 0:
        n_cols = shape[-1]
        n_out = max(1, int(n_cols * outlier_frac))
        cols = rng.choice(n_cols, size=n_out, replace=False)
        w[..., cols] *= outlier_scale
    return _cast(w, dtype)


def quantized_weights_int4(shape: tuple, seed: int = 0) -> np.ndarray:
    """GPTQ-like INT4 surrogate: near-uniform 4-bit codes (already lossy-
    compressed, hence ~incompressible — paper Table III INT4 rows)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0.0, 1.0, size=shape)
    # GPTQ grids are per-group symmetric; codes cluster mildly around center.
    codes = np.clip(np.round(w / w.std() * 2.2) + 8, 0, 15).astype(np.uint8)
    return codes


def quantized_weights_fp8(shape: tuple, seed: int = 0) -> np.ndarray:
    """AutoFP8-like surrogate: per-channel-rescaled BF16 Gaussian cast to
    e4m3, returned as ``uint8`` bit patterns.  AutoFP8 scales each channel
    so its max lands near the e4m3 max (448), spreading values across the
    full exponent range — which is why the paper's FP8 lossless ratios
    collapse to ~1.09 (the redundancy the exponent planes carried in BF16 is
    consumed by the lossy step)."""
    w = gaussian_weights(shape, seed=seed, dtype=np.float32)
    colmax = np.abs(w).max(axis=0, keepdims=True) + 1e-12
    w = w / colmax * 448.0
    # |w| <= 448, the e4m3 maximum: no value reaches torch's saturation or
    # the reference's NaN on overflow, so both round alike (to nearest even)
    t = torch.from_numpy(np.ascontiguousarray(w, np.float32)).to(torch.float8_e4m3fn)
    return t.view(torch.uint8).numpy()


def ar1_kv_cache(
    tokens: int,
    channels: int,
    rho: float = 0.88,
    seed: int = 0,
    outlier_frac: float = 0.01,
    dtype=BFLOAT16,
) -> np.ndarray:
    """AR(1)-per-channel KV surrogate (tokens, channels).

    Per-channel scale sigma_j ~ LogNormal, per-channel mean mu_j ~ N(0, 0.5),
    a few high-magnitude outlier channels, cross-token correlation rho.
    """
    rng = np.random.default_rng(seed)
    sigma = np.exp(rng.normal(-1.0, 0.7, size=channels)).astype(np.float32)
    mu = rng.normal(0.0, 0.5, size=channels).astype(np.float32)
    n_out = max(1, int(channels * outlier_frac))
    out_cols = rng.choice(channels, size=n_out, replace=False)
    sigma[out_cols] *= 10.0
    mu[out_cols] *= 6.0
    eps_scale = sigma * np.sqrt(1.0 - rho**2)
    x = np.empty((tokens, channels), np.float32)
    x[0] = mu + sigma * rng.normal(size=channels)
    for t in range(1, tokens):
        x[t] = mu + rho * (x[t - 1] - mu) + eps_scale * rng.normal(size=channels)
    return _cast(x, dtype)


def logmag_kv_cache(
    tokens: int,
    channels: int,
    rho: float = 0.995,
    sign_flip: float = 0.01,
    spread: float = 2.0,
    stable_frac: float = 0.25,
    m_std: float = 1.0,
    rope_frac: float = 0.0,
    seed: int = 0,
    dtype=BFLOAT16,
) -> np.ndarray:
    """Primary KV surrogate: AR(1) in *log magnitude* per channel.

    |x[t,j]| = exp(m_j + s_j * z[t,j]) with z AR(1)(rho); signs are
    channel-persistent with occasional flips; ``stable_frac`` of channels are
    near-constant ("sink"/positional channels).  Unlike a value-space AR, the
    exponent field wanders per token (breaking naive token-major matching,
    matching the paper's weak Table I baselines) while adjacent tokens stay
    within a small exponent delta (what clustering + delta exploits).

    Calibration (see benchmarks/fig7): per-layer rho in [0.97, 0.999] makes
    the bit-plane-only baseline land in the paper's 1.21-1.33 ZSTD band and
    clustering+delta in the 1.8-2.1 band, with single-layer peaks ~2.3-2.7.
    """
    rng = np.random.default_rng(seed)
    # m_std controls ACROSS-channel scale diversity: the paper's real-KV
    # regime has high global exponent entropy (weak token-major baseline)
    # yet low within-channel exponent deltas (strong clustered ratio).
    m = rng.normal(-1.0, m_std, channels).astype(np.float32)
    s = np.abs(rng.normal(0.0, spread, channels)).astype(np.float32) + 0.5
    if stable_frac > 0:
        k = max(1, int(channels * stable_frac))
        idx = rng.choice(channels, k, replace=False)
        s[idx] *= 0.05
    z = rng.normal(size=channels).astype(np.float32)
    sign = np.where(rng.random(channels) < 0.5, -1.0, 1.0).astype(np.float32)
    innov = np.sqrt(1.0 - rho**2)
    # RoPE-modulated channels: rotary keys oscillate per token at channel-
    # dependent frequencies, which destroys token-major byte matches (weak
    # naive/bit-plane-only baselines, as on real KV) while channel grouping
    # still sees a narrow magnitude envelope.
    n_rope = int(channels * rope_frac)
    rope_idx = rng.choice(channels, n_rope, replace=False) if n_rope else np.empty(0, int)
    omega = np.exp(rng.uniform(np.log(0.01), np.log(1.5), n_rope)).astype(np.float32)
    phi = rng.uniform(0, 2 * np.pi, n_rope).astype(np.float32)
    x = np.empty((tokens, channels), np.float32)
    for t in range(tokens):
        z = rho * z + innov * rng.normal(size=channels).astype(np.float32)
        flip = rng.random(channels) < sign_flip
        sign = np.where(flip, -sign, sign)
        row = sign * np.exp(m + s * z)
        if n_rope:
            row[rope_idx] = row[rope_idx] * np.cos(omega * t + phi)
        x[t] = row
    return _cast(x, dtype)


def layer_kv_suite(
    n_layers: int = 32,
    tokens: int = 2048,
    channels: int = 1024,
    seed: int = 0,
    task: str = "wikitext",
) -> list[np.ndarray]:
    """Per-layer KV surrogates emulating the 32-layer LLaMA-8B sweep (Fig. 7).

    Layer-to-layer token correlation varies: early layers are more positional
    (very stable), middle layers noisiest, late layers intermediate — the
    same U-shape reported in KV-quantization studies.  ``task`` shifts the
    overall stability (long-document summarisation shows higher cross-token
    similarity than wikitext in the paper).
    """
    base = 0.008 if task == "wikitext" else 0.005  # 1-rho at the noisy end
    out = []
    for layer in range(n_layers):
        u = layer / max(1, n_layers - 1)
        # U-shaped noise profile: stable at both ends, noisy mid-stack.
        noise = base * (0.15 + 3.4 * u * (1.0 - u))
        rho = 1.0 - noise
        stable = 0.32 - 0.18 * u
        out.append(
            logmag_kv_cache(
                tokens,
                channels,
                rho=rho,
                stable_frac=stable,
                rope_frac=0.5,  # calibration: baseline ZSTD in 1.2–1.4
                seed=seed * 1000 + layer,
            )
        )
    return out


def spec_for_precision(precision: str) -> FloatSpec:
    return {"bf16": BF16, "fp8": FP8_E4M3}[precision]
