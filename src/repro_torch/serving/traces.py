"""Trace generation for the multi-tenant load harness (a copy of the
reference's ``serving/traces.py``).

Production traffic is not a single synchronized wave: requests arrive over
time, in heterogeneous classes, with shared structure (the same system
prompt in front of thousands of chat turns).  This module builds
deterministic synthetic traces with exactly those properties so admission,
shedding, eviction and prefix-sharing policies can be evaluated against
TTFT/TPOT SLOs instead of against a benchmark wave:

* **Request classes.**  ``chat`` — a shared system prompt (page-aligned,
  the prefix-sharing headline case) plus a short per-user suffix and a
  short decode; ``longdoc`` — a long unique prompt with a few output
  tokens (summarization-shaped: prefill-heavy, decode-light); ``agentic``
  — a shared tool preamble with a longer decode (tool-call loops:
  decode-heavy).  Each class draws its system prompt deterministically
  from the trace seed, so two runs of the same seed share bit-identical
  prefixes and different seeds share nothing.

* **Arrival processes.**  ``poisson`` — memoryless steady load;
  ``diurnal`` — a sinusoid-modulated Poisson (daily peak/trough, the
  capacity-planning case); ``bursty`` — Poisson batch arrivals (thundering
  herds, the shedding case).  Arrivals are in scheduler *steps* — the
  deterministic clock every report quotes.

Everything is a plain ``numpy.random.Generator`` draw from an explicit
seed: a trace is reproducible from ``(kind, classes, rate, seed)`` alone.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serving.kv_cache import PAGE_TOKENS
from repro_torch.serving.scheduler import Request

#: vocabulary the synthetic prompts draw from (well under every smoke
#: model's vocab size)
_VOCAB = 500


@dataclasses.dataclass(frozen=True)
class RequestClass:
    """One tenant archetype in a trace mix."""

    name: str
    #: shared prefix length in tokens (page-aligned; 0 = no shared prefix).
    #: All requests of this class in one trace share the SAME prefix.
    shared_prefix: int
    #: unique per-request suffix length range [lo, hi] (>= 1: a prompt is
    #: never pure shared prefix, so divergence always exists)
    suffix: tuple
    #: decode length range [lo, hi]
    new_tokens: tuple
    #: relative share of traffic this class contributes
    weight: float = 1.0


#: the reference's default mix: chat with shared system prompts, long-doc
#: summarization, agentic tool loops
DEFAULT_CLASSES = (
    RequestClass("chat", shared_prefix=6 * PAGE_TOKENS, suffix=(4, 24),
                 new_tokens=(8, 24), weight=0.6),
    RequestClass("longdoc", shared_prefix=0, suffix=(160, 224),
                 new_tokens=(4, 8), weight=0.2),
    RequestClass("agentic", shared_prefix=4 * PAGE_TOKENS, suffix=(8, 32),
                 new_tokens=(24, 48), weight=0.2),
)


@dataclasses.dataclass
class TraceItem:
    """One request plus its arrival time and provenance."""

    arrival_step: int
    request: Request
    klass: str


def poisson_arrivals(rng: np.random.Generator, n: int,
                     rate: float) -> np.ndarray:
    """Arrival steps of ``n`` requests at ``rate`` requests/step
    (memoryless: exponential inter-arrival gaps)."""
    gaps = rng.exponential(1.0 / max(rate, 1e-9), size=n)
    return np.floor(np.cumsum(gaps)).astype(np.int64)


def diurnal_arrivals(rng: np.random.Generator, n: int, rate: float,
                     period: int = 256, depth: float = 0.8) -> np.ndarray:
    """Sinusoid-modulated Poisson: instantaneous rate swings between
    ``rate*(1-depth)`` (trough) and ``rate*(1+depth)`` (peak) over
    ``period`` steps — accepted by thinning a faster homogeneous process,
    so the modulation is exact, not binned."""
    peak = rate * (1.0 + depth)
    out: List[int] = []
    t = 0.0
    while len(out) < n:
        t += rng.exponential(1.0 / max(peak, 1e-9))
        lam = rate * (1.0 + depth * np.sin(2 * np.pi * t / period))
        if rng.uniform() * peak <= lam:
            out.append(int(t))
    return np.asarray(out, np.int64)


def bursty_arrivals(rng: np.random.Generator, n: int, rate: float,
                    burst: int = 8) -> np.ndarray:
    """Thundering herds: bursts of ~``burst`` simultaneous requests whose
    burst *times* are Poisson at ``rate/burst`` bursts/step (same mean
    load as ``poisson``, far worse tail)."""
    out: List[int] = []
    t = 0.0
    while len(out) < n:
        t += rng.exponential(burst / max(rate, 1e-9))
        size = max(1, int(rng.poisson(burst)))
        out.extend([int(t)] * min(size, n - len(out)))
    return np.asarray(out, np.int64)


ARRIVALS = {
    "poisson": poisson_arrivals,
    "diurnal": diurnal_arrivals,
    "bursty": bursty_arrivals,
}


def _class_prefixes(classes: Sequence[RequestClass],
                    rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """One deterministic shared prefix per class (drawn BEFORE any
    per-request randomness, so the prefixes depend only on the seed and
    the class list — not on n or the arrival kind)."""
    return {
        c.name: rng.integers(0, _VOCAB, size=c.shared_prefix).astype(np.int32)
        for c in classes
    }


def make_trace(n: int, kind: str = "poisson", rate: float = 0.5,
               seed: int = 0,
               classes: Sequence[RequestClass] = DEFAULT_CLASSES,
               max_ctx: Optional[int] = None,
               rid_base: int = 0, **arrival_kw) -> List[TraceItem]:
    """Build ``n`` requests with arrival steps, sorted by arrival.

    ``max_ctx`` clamps prompt+decode so every request is admissible; rids
    are ``rid_base + i`` in arrival order.  Request ``rng_seed`` is left
    None — sampling streams come from the engine's base seed, so a trace
    replayed against two configurations compares bit-identical streams.
    """
    if kind not in ARRIVALS:
        raise ValueError(f"kind must be one of {sorted(ARRIVALS)}, "
                         f"got {kind!r}")
    rng = np.random.default_rng(seed)
    prefixes = _class_prefixes(classes, rng)
    weights = np.asarray([c.weight for c in classes], np.float64)
    weights = weights / weights.sum()
    steps = ARRIVALS[kind](rng, n, rate, **arrival_kw)
    items: List[TraceItem] = []
    for i in range(n):
        c = classes[int(rng.choice(len(classes), p=weights))]
        suffix = int(rng.integers(c.suffix[0], c.suffix[1] + 1))
        new = int(rng.integers(c.new_tokens[0], c.new_tokens[1] + 1))
        prompt = np.concatenate([
            prefixes[c.name],
            rng.integers(0, _VOCAB, size=suffix).astype(np.int32),
        ])
        if max_ctx is not None:
            room = max_ctx - len(prompt) - 1
            if room < 0:
                prompt = prompt[:max_ctx - 2]
                room = 1
            new = max(1, min(new, room))
        items.append(TraceItem(
            arrival_step=int(steps[i]),
            request=Request(rid=rid_base + i, prompt=prompt,
                            max_new_tokens=new),
            klass=c.name,
        ))
    items.sort(key=lambda it: (it.arrival_step, it.request.rid))
    return items
