"""Data pipeline of the port: the synthetic corpus, the byte-level tokenizer
and the deterministic sharded loader (copies of the reference's NumPy
modules, ``data/``; their batches and tokens are the reference's bit for
bit)."""

from repro_torch.data.pipeline import DataConfig, ShardedLoader, synthetic_corpus  # noqa: F401
from repro_torch.data.tokenizer import ByteTokenizer  # noqa: F401
