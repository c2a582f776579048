"""Checkpointing of the port: atomic, compressed with the paper's own
bit-plane pipeline, readable by the reference (and the reference's by the
port)."""

from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    latest_step,
    load_checkpoint,
    save_checkpoint,
)
