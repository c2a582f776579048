"""Modality frontends: stubs, as in the reference's ``models/frontends.py``.

The VLM and enc-dec architectures specify the transformer backbone only:
the model takes precomputed patch or frame embeddings in place of a vision
tower or a mel-conv stack.  The backbone's projection of those embeddings
(``patch_proj`` for LLaVA, identity for Whisper frames already at
``d_model``) is part of the model.

The ``fake_*`` functions draw runnable stand-ins from an explicit
``torch.Generator``, on its device.  The reference's ``*_spec`` dry-run
shapes come with the port's dry run (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

#: stubbed vision-tower output width (CLIP-L/14-class towers emit 1024)
VISION_DIM = 1024


def _normal(shape: tuple, generator: torch.Generator) -> torch.Tensor:
    """Unit-scale N(0, 1), rounded to bf16."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=generator.device).to(torch.bfloat16)


def fake_patches(generator: torch.Generator, cfg, batch: int) -> torch.Tensor:
    """(batch, n_patches, VISION_DIM) patch embeddings (anyres tiling)."""
    return _normal((batch, cfg.n_patches, VISION_DIM), generator)


def fake_frames(generator: torch.Generator, cfg, batch: int) -> torch.Tensor:
    """(batch, enc_seq, d_model) post-conv frame embeddings: Whisper's conv
    frontend maps 30 s of 80-mel audio to 1,500 frames at ``d_model``."""
    return _normal((batch, cfg.enc_seq, cfg.d_model), generator)
