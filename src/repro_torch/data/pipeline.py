"""Deterministic sharded data pipeline (the port's copy of the reference's
``data/pipeline.py``; NumPy only, so batches equal the reference's bit for
bit).

* :func:`synthetic_corpus` — Zipf-mixture token stream with long-range
  repetition structure (topic blocks that recur, locally bursty unigrams):
  enough statistical structure that a small LM trains to a non-trivial loss
  and its KV cache develops the cross-token channel correlation the paper's
  clustering exploits.
* :class:`ShardedLoader` — batch b of host h at step t is a pure function of
  (seed, t, h): restart-safe exactly-once delivery with one int64 of loader
  state (the step), the property the checkpoint layer persists.  Batches
  are NumPy int32 arrays; the caller moves them to its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    seed: int = 0
    zipf_a: float = 1.2
    n_topics: int = 64
    topic_len: int = 256


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks**-a
    return p / p.sum()


def synthetic_corpus(cfg: DataConfig, n_tokens: int, seed: int | None = None) -> np.ndarray:
    """Zipf unigrams + recurring topic blocks + local repetition bursts."""
    rng = np.random.default_rng(cfg.seed if seed is None else seed)
    base_p = _zipf_probs(cfg.vocab, cfg.zipf_a)
    # Topic templates: fixed snippets re-sampled verbatim (long-range reuse).
    topics = [
        rng.choice(cfg.vocab, size=cfg.topic_len, p=base_p) for _ in range(cfg.n_topics)
    ]
    out = np.empty(n_tokens, np.int32)
    i = 0
    while i < n_tokens:
        r = rng.random()
        if r < 0.35:  # verbatim topic recurrence
            t = topics[rng.integers(cfg.n_topics)]
            n = min(len(t), n_tokens - i)
            out[i : i + n] = t[:n]
        elif r < 0.5 and i > 64:  # local burst: copy a recent window
            span = int(rng.integers(8, 64))
            start = int(rng.integers(max(0, i - 512), i - span)) if i - 512 < i - span else i - span
            n = min(span, n_tokens - i)
            out[i : i + n] = out[start : start + n]
            n = max(n, 1)
        else:  # fresh zipf text
            n = min(int(rng.integers(32, 128)), n_tokens - i)
            out[i : i + n] = rng.choice(cfg.vocab, size=n, p=base_p)
        i += n
    return out


class ShardedLoader:
    """Stateless-deterministic loader: ``batch(step)`` is pure in
    (seed, step, host).  ``state()``/``restore()`` carry one integer."""

    def __init__(self, cfg: DataConfig, host: int = 0, corpus: np.ndarray | None = None):
        assert cfg.global_batch % cfg.n_hosts == 0
        self.cfg = cfg
        self.host = host
        self.local_batch = cfg.global_batch // cfg.n_hosts
        self._corpus = corpus
        self._step = 0

    def _corpus_tokens(self) -> np.ndarray:
        if self._corpus is None:
            self._corpus = synthetic_corpus(
                self.cfg, max(2_000_000, 4 * self.cfg.seq_len * self.cfg.global_batch)
            )
        return self._corpus

    def batch_at(self, step: int) -> dict:
        """{'tokens': (local_B, S), 'labels': (local_B, S)} int32."""
        corpus = self._corpus_tokens()
        n = len(corpus)
        s = self.cfg.seq_len
        rng = np.random.default_rng(
            (self.cfg.seed * 1_000_003 + step) * 4096 + self.host
        )
        starts = rng.integers(0, n - s - 1, size=self.local_batch)
        idx = starts[:, None] + np.arange(s + 1)[None, :]
        window = corpus[idx]
        return {
            "tokens": np.ascontiguousarray(window[:, :-1], np.int32),
            "labels": np.ascontiguousarray(window[:, 1:], np.int32),
        }

    def __next__(self) -> dict:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    def state(self) -> dict:
        return {"step": self._step}

    def restore(self, state: dict) -> None:
        self._step = int(state["step"])
