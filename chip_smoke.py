#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and ``nvcc`` (on
PATH or under ``$CUDA_HOME/bin``); without a GPU, or without the port's
sources next to it, it exits non-zero and prints no result.  It imports
nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure exits non-zero; no phase's error is caught):

1. The card's name and power limit; build the seven kernel libraries
   from ``src/repro_torch/csrc`` (paged attention, bit-plane pack/unpack,
   bit-plane matmul, the SSD scan, flash attention and its backward,
   exponent-delta encode/decode; one ``nvcc`` each, all started together)
   and report the build times and ptxas register lines.
2. Each kernel against its plain PyTorch version on the card.  Paged
   attention at the serving shapes of full-width SmolLM-135M (B=8,
   S=1024, Hkv=3, rep=3, hd=64): mixed plane counts {8, 12, 16} with
   keep-0 pages, ragged valid lengths and one row with nothing valid; and
   at Yi-9B's head shape (B=2, S=4096, Hkv=4, rep=8, hd=128): keeps {0, 4,
   8, 16}, one row with nothing valid.
   Pack and unpack bit for bit: the flat kernels at 1-, 2- and 4-byte
   containers, at one octet, a ragged last plane word, the decode token
   rows, one slot's full cache per layer and an odd length, keeps down to
   0; the KV entry points (K and V in one launch, in place) at the decode
   append (B 8, positions 0, mid, S - 1, past S and below 0, clamped),
   prefill chunks of 256 rows at offset 0, mid and the end, and the unpack
   of a layer's slot and of one slot's layer range at keep 16, 12, 8, 4
   and 0; the bit-plane matmul at the quickstart's shape and every SmolLM-135M projection; the
   SSD scan at the full-width Mamba2-1.3B prefill shape (B=4, L=1024,
   H=64, P=64, N=128, Q=256) with a nonzero initial state and realistic
   dt·A, b and c per group (G=1) as the model passes them and per head
   (G=H, the reference's contract), at a ragged L=1000, at L=37 (below one
   chunk) and at the Zamba2-7B prefill shape (B=2, L=4096, H=112, P=64,
   N=64, G=2); flash attention
   at the full-width Zamba2-7B prefill shape (B=2, L=4096, 32 heads of
   112, causal), at SmolLM-135M prefill chunks (64 rows at offsets 0, 448
   and 960, the last with its keys split and merged, and 512 rows at
   offsets 0 and 448, over 1024 slot rows, 9 q / 3 kv heads of 64), at a ragged
   L=1000, with a 64-key window and bidirectional with kv_valid < Skv.
   Exponent-delta encode and decode bit for bit at a 512-token serving
   span (4 stored layers x 2 streams x 32 pages of 192 channels), a decode
   page fill (8 pages), the quickstart's KV, fp8_e4m3 in uint8, ragged row
   counts, and decode of top-k truncations (keep 12, 8, 4); the fused
   cluster-and-encode (the KV page write's entry point) at the token-major
   views the memory tier gives it (the serving span's (layers, 2, t, C)
   transposed view, a decode page fill, a re-activated tail page,
   compress_kv's ragged (t, C), the quickstart's KV), fp8 and fp32, G 8
   and 12, C = 24, the byte path (an unaligned start, rows of no whole
   vectors, pages of one channel) and channels cut in chunks.  The bit-plane
   matmul also at the Zamba2-7B MLP up-projection (M 8 and 128 x 3584 x
   14336), every matmul shape at keep 16, 12, 8, 4, 1 and 0.
3. Serve 16 requests through ``ContinuousScheduler`` on full-width
   SmolLM-135M (random weights from a seeded ``torch.Generator``, 30
   layers) with bit-plane device KV and a precision ladder, once through
   the fused kernel and once through the rung kernel, with launch counts
   reset before and read after each run (attention, pack, unpack and
   exponent-delta kernels: one encode per page-writing span or
   re-activated page, as the backend counts them, and no decode); a
   torch.profiler window of steady decode steps (device
   kernel time against host wall time, and launches per decode step);
   the launches of one prefill chunk (exactly 30 flash launches, 30 packs
   and 30 unpacks, one each a layer) and of one ``model.decode`` step on a
   copy of the snapshot (30 packs, no unpack); a digest of each timed
   run's greedy tokens and integer counters; then one teacher-forced decode step
   from a snapshot of the serving cache, three ways (fused, rung, plain),
   whose logits must agree.  The two serving runs are held against each
   other in two untimed check runs that repeat them (the same tokens and
   counters): ``model.decode`` is wrapped (``DecodeWatch``) to keep each
   step's logits rows; at each request's first divergent token each run's
   row must agree with the plain attention's on its own cache within the
   teacher-forced bound, and rows of the two runs that consumed the same
   tokens and read the same ladder plane maps must agree within it too.
   Each run's queued page-write bytes must equal its stored logical bytes
   plus the bytes of the writes ``retire`` cancelled (``write_job_ledger``),
   and the queued bytes must be equal across the runs.  Two page-writing
   spans as the backend runs them (``slot_kv_bits``, then ``encode_span``;
   whole pages and a ragged tail page), each in a profiler window: exactly
   one device kernel, the exponent-delta encode, between the span's unpack
   and its pack, the parent's route there counted beside it.
3c. The memory tier's round trip at the serving width: the snapshot's
   device KV of enough slots for at least 512 pages (4 stored layers x 2
   streams, 192 channels) through ``put_sequence`` into a card store and a
   CPU store fed the same bits (equal blobs and controller totals), then
   ``get_sequence`` on the card at keep 16 (the device KV bit for bit), 12,
   8, 4 and the ladder's per-page keeps (each equal to the CPU store's
   read); one encode and one pack launch per put, one unpack and one
   decode launch per get.
3p. Shared-prefix pages and compressed weight streaming at the serving
   width: phase 3's model, ladder and engine config serve a 20-request
   ``make_trace`` mix (chat behind a 384-token and agentic turns behind a
   256-token shared prompt, long documents with none; submitted at their
   arrival steps, the lane engine unbounded) three ways: (a) sharing off,
   (b) on, (c) on with the weights streamed compressed.  Each run's launch
   counts are reset before and read after it (flash 30 a prefill chunk the
   run made, one unpack a prefix snapshot, one pack an adoption); (b)
   matched, skipped chunks and deduplicated bytes, its resident shared
   bytes are the shared pages', the first adoption equals the donor
   snapshot bit for bit, and (a)'s prefilled tokens less (b)'s are (b)'s
   matched tokens; (c)'s tokens and KV byte counters equal (b)'s, each
   layer's weights are charged once a pass, and (c)'s Perfetto trace
   validates with one weight event a fetch.  Where (a) and (b) part,
   check runs repeat both under a ``DecodeWatch`` and each run's row at
   every first divergence is held to the plain attention on its own cache.
3s. The sharded memory tier: phase 3's 16 requests through
   ``backend="sharded"``, fused kernel, at 3 shards (SmolLM-135M's 3 kv
   heads: the head route, each page's channels cut per shard from one
   encode) and 2 (the sequence route, whole pages dealt by page index):
   greedy tokens equal to phase 3's paged fused run, page-write bytes
   queued equal to its, the shards' stored logical bytes plus the writes
   ``retire`` cancelled equal to what was queued, launches as phase 3's.
3t. Staged decode and padded admission: the first 8 of phase 3's
   requests on phase 3's model, (a) on dense device KV with a 16-token
   staging ring, teacher-forced with the same trace's unstaged tokens
   (greedy tokens equal; every decode row within ``STAGED_ROW_STEPS``
   bf16 steps of the unstaged row; layer 0's keys and values equal bit
   for bit; every request folds at least two windows back;
   flash once a layer a prefill chunk, no paged, pack or unpack launch),
   (b) ``prefill_mode="padded"`` with bit-plane device KV, phase 3's
   ladder and the fused kernel (flash once a layer a padded prefill, one
   pack a layer a decode step and one an adoption, one encode a
   page-writing span) against a bucketed run of the same trace: tok/s and
   prefill tokens of both.
4. The paper-pipeline quickstart (``repro_torch.quickstart``) on the card,
   launch counts reset before and read after (two packs, one
   exponent-delta encode for the KV surrogate, two matmuls): its byte
   counts must equal the CPU run's and its matmul error the plain
   version's.
5. Full-width Mamba2-1.3B (48 layers, random weights from a seeded
   ``torch.Generator``) through ``make_prefill_step`` on 4 prompts of 1024
   tokens, then 32 greedy ``make_serve_step`` steps, the SSD launch count
   reset before and read after each (48 per prefill, 0 per decode step);
   prefill and decode times, a profiler window over one prefill (device
   time and the SSD kernel's share); teacher-forced prefill logits through
   the kernel against the same prefill through the plain SSD, and the
   reference's prefill/decode consistency check.
5b. Full-width Zamba2-7B (81 slots: 13 shared-attention-block calls and
   68 Mamba2 layers; random weights from a seeded ``torch.Generator``;
   the earlier phases' models freed first) through ``make_prefill_step``
   on 2 prompts of 4096 tokens (13 flash and 68 SSD launches), then the
   cache padded by ``prepare_decode_cache`` and 32 greedy
   ``make_serve_step`` steps (no flash or SSD launch: decode attention and
   the recurrent Mamba2 step); prefill and decode times, a profiler window
   over one prefill; prefill logits through both kernels against both
   plain versions (after the plain versions' own floor), decode against
   prefill, and every slot layer by layer.
7. Mixtral-8x7B at full width (d 4096, 32/8 heads of 128, 8 experts of
   d_ff 14,336, top-2, window 4,096, vocab 32,000; random weights from a
   seeded ``torch.Generator``), its depth cut from 32 layers to 4 (32 do
   not fit the card; 4 since phase 8 came, to keep the script inside its
   time), served through ``backend="ring"`` with bit-plane
   device KV and phase 3's ladder: 4 slots of an 8,192-token context, six
   greedy requests of 1,024 to 6,000 prompt tokens and 160 new ones (two
   inside the window, two crossing it while they decode, two starting
   beyond it), once through the fused and once through the rung kernel,
   launch counts reset before and read after each run (flash once a layer
   a prefill chunk: every chunk attends over the ring's old entries and
   itself with keys at their own positions; the paged kernel once a layer
   a decode step over the mask the ring's positions and the window make);
   one stored layer and the lane engine unbounded (so the store follows
   the whole window): pages retired by the window, the store's resident
   pages (at most 2 x (256 + 2) x 4), none evicted; host and device ms a decode
   step (a profiler window); from a snapshot of the fused run, one decode
   step fused, rung and plain, and one 512-token ring chunk through the
   flash kernel and its plain version, logits within 5% of the largest.
8. The remaining model families at full width, random weights from a
   seeded ``torch.Generator``, each model freed before the next; every
   sub-phase prints its seconds into the marks line.  8a: DeepSeek-MoE-16B
   (28 layers, d 2,048, 16 MHA heads of 128, 64 routed top-6 and 2 shared
   experts of d_ff 1,408, vocab 102,400; nothing cut) and 8b:
   Nemotron-4-15B (32 layers, d 6,144, 48/8 heads of 128, squared-ReLU
   d_ff 24,576, vocab 256,000; nothing cut), each served on the paged
   backend with bit-plane device KV, phase 3's ladder, lz4, 4 slots of a
   2,048-token context and the lane engine unbounded (8 requests of 256
   to 1,536 prompt tokens, and 6 of 256 to 1,024; 32 new each), fused
   then rung, as phase 7's runs are timed and counted: launches (fused
   once a layer a decode step, rung once a plane count, flash once a
   layer a prefill chunk, one encode a page-writing span), device bytes
   equal to the controller's plane-scaled reads, each layer's attention
   sub-layer on a snapshot against the plain attention, and a
   teacher-forced decode step against the plain one (DeepSeek's with its
   MoE routes pinned to the plain run's: with 64 experts a top-6
   boundary often lies within a bf16 step).  8c: LLaVA-NeXT-34B (7,168
   wide, 56 q heads padded to 64, 8 kv heads, d_ff 20,480, 2,880
   patches) at all 60 layers where 6 GiB stay free after init (else the
   deepest multiple of 4, logged): one ``make_prefill_step`` of B 2 x
   (2,880 patches + 1,024 tokens), each layer's attention sub-layer
   through the flash kernel against the plain one and its padded heads
   exactly zero before ``wo``, the cache padded to 4,096 and 32
   ``make_serve_step`` steps, decode after prefill against prefill.  8d:
   Whisper-tiny (4 + 4 layers, 384 wide, 6 heads of 64) on B 8 x (1,500
   frames + 224 tokens), every encoder, decoder and cross attention
   sub-layer of the prefill against the plain one, 64 decode steps, the
   consistency check.  8c and 8d print prefill ms (host, device), flash's
   share of the device time and decode ms a step.
9. Training at full width.  9a: the flash backward kernel against its
   plain version (dq, dk, dv within 2 bf16 steps of each one's largest
   magnitude) and the forward's lse against the plain one, at
   SmolLM-135M's training shape (B 8, L 2,048, 9/3 heads of 64, causal), a
   64-key window, Whisper-tiny's encoder (1,500 frames of a 1,536-row key
   buffer), its cross attention (224 over 1,500) and Nemotron-4-15B's
   attention heads (B 2, L 2,048, 48/8 heads of 128, causal).  9b: full-width
   SmolLM-135M through ``make_train_step`` (2 micro-batches of a
   ShardedLoader batch of 8 x 2,048): one step's loss and gradients,
   launch counts reset before and read after (flash forward and backward
   once a layer a micro-batch), against the same step through the plain
   versions (loss, global gradient norm, every leaf's cosine); a profiler
   window over one step (its device time split by kernel); 10 AdamW steps
   on the batch, the loss falling; host and device ms a step and tokens/s.  9d: ``TrainSupervisor`` and a
   ``CheckpointManager`` on a temporary directory under ``build/`` over 9b's
   model, its top layer trained: an injected ``SimulatedFailure``, one
   recovery from the last checkpoint, the batches replayed exactly once,
   every restored tree the saved one bit for bit, the saves and loads
   timed with the card's codec.  9c: Whisper-tiny through
   ``make_train_step``, 3 steps on B 8 x (1,500 frames + 224 tokens), the
   loss falling.  9e: the SSD backward kernel against its plain version
   (``ref.ssd_bwd_ref``) on the forward kernel's workspaces, at the
   Mamba2-1.3B and Zamba2-7B training micro-batches (1 x 4,096 tokens, b
   and c bf16-valued; Zamba2's with h0 and dh_final nonzero): every
   gradient's relative Frobenius error within its bound, a second call
   the same bits, the kernel's device ms against its bound.  9f:
   full-width Mamba2-1.3B (48 layers)
   and Zamba2-7B (width in full, depth cut to 25 of its 81 slots, which
   the log reckons) through ``make_train_step`` (2 micro-batches of a
   ShardedLoader batch of 2 x 4,096): one step's loss and gradients,
   launch counts reset before and read after (the SSD forward twice a
   Mamba2 layer a micro-batch under layer remat, its backward once; flash
   forward and backward once a shared-block call), against the same step
   through the plain versions (9b's bounds); a profiler window over one
   step; 3 AdamW steps at lr 1e-4, the loss falling.
6. Kernel times (CUDA events and profiler device time) beside their
   bound, the plain version's time and one PyTorch call's where one
   computes the same function (device time too for the paged rows and the
   matmul), printed as one ``{"kernels": [...]}`` line (eleven rows: every
   kernel of the port; the matmul row carries its Zamba2-7B MLP rows, cold,
   under ``shapes``; the pack row the decode append (K+V of B 8 into a
   1,024-row cache) beside the parent's route (a flat pack a stream and an
   indexed write), and under ``shapes`` a prefill chunk's append, the
   memory tier's 256-page span and a cold m = 2^24; the unpack row one
   slot's K+V (keep 16) beside the parent's route, and under ``shapes``
   phase 3c's longest ``get_sequence`` and the cold m = 2^24 at keep 16 and
   8; both with an empty kernel's device time, the launch floor; the
   exponent-delta encode row the serving span's view beside the parent's
   route (a tail cat, a reshape copy, a cluster copy, the flat encode), and
   under ``shapes`` a decode page fill, a cold 2^24 values and the flat
   entry point; the decode row its flat rows; each
   paged row its long, cold decode rows: B 8, S 4096
   at Yi-9B's head shape, every page at keep 16, 8 and 4, beside SDPA with
   ``enable_gqa`` over the dense bf16 cache; the flash row its SmolLM
   prefill chunks, 64 rows at offsets 0 and 960 and 512 rows at offset
   448 with 960 valid keys, beside SDPA over the valid keys with a boolean
   mask, named by the backend it took, and under ``serving_mix`` the
   prefill chunks of phase 3's run, each timed as the launch plan splits
   it and with its keys not split, beside the mix's bound; the SSD row the Mamba2-1.3B prefill
   shape and, under ``shapes``, the Zamba2-7B one and both again with b
   and c rounded to bf16 values as the models' are, each beside its
   tensor-core bound at the TF32 passes the kernel takes on those inputs
   (3xTF32 throughout on drawn b and c; on bf16-valued ones one pass for
   the scores and two for c.state) and its float32 CUDA-core bound).  A
   paged-attention or flash call launches the attention kernel and, when
   its keys are split, the kernel that merges the splits; an SSD call its
   three kernels (chunk states, the pass over chunks, the outputs); the
   device times cover them all.  The flash row also carries, under
   ``ring``, the kernel with key positions at phase 7's ring chunk (512
   and 4,096 queries over a 4,096-slot ring and themselves, Mixtral's
   heads; a full ring and one 3,000 slots filled) beside the plain
   version, its bound over the visible pairs and SDPA with the same mask,
   and under ``ring_dominant_keys`` four ring chunks of 512 in which one
   key dominates the queries that may see it (just inside and just past
   the window's edge, the last ring key before the wrap, an old position
   the early queries still see), each within FLASH_BF16_STEPS of plain;
   the fused paged row, under ``ring``, the kernel over a ring's mask (B 4,
   4,096 slots, Mixtral's heads) beside SDPA with that mask.  Every row
   counts its launches in phases 3p, 3s, 7 and 8 (``launches_phase_3p``,
   ``launches_phase_3s``, ``launches_phase_7``, ``launches_phase_8``).
   The flash row carries, under ``phase8_shapes``, the kernel at phase
   8's shapes (Nemotron-4's and DeepSeek's 1,024-token prefill chunks,
   LLaVA's prefill, Whisper's encoder and cross attention), each beside
   its plain version, its bound and SDPA over the same valid keys; the
   paged rows, at 8a's and 8b's decode (B 4, 2,048 slots).  Then the flash
   backward's row, at SmolLM-135M's training shape and, under ``shapes``,
   at Nemotron-4's heads, beside its plain version, its bound (five
   products over the visible pairs) and SDPA's backward alone (its
   library time) and forward and backward; last the SSD backward's row:
   9e's Mamba2-1.3B case, Zamba2-7B's under ``shapes``, beside the plain
   backward and its bound (the scores at one TF32 pass on bf16-valued b
   and c, every other product at three), its launches those of 9f's
   Mamba2 step.  Every row counts its launches in phases 3t and 9 too.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import re
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, float32 (non-tensor)
# FLOP/s and dense bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_TENSOR_FLOPS = 989e12
# dense TF32 tensor-core FLOP/s
TF32_TENSOR_FLOPS = 495e12
# TF32 passes the SSD kernel takes for each of its four products, in
# ssd_work's order (scores c.b, scores.xdt, c.state, the chunk state): on
# float32 b and c every product is 3xTF32; on bf16-valued b and c, as the
# models' are, the scores' operands are exact in TF32 (one pass) and so is
# c in c.state (two), while the decay-weighted operands of the other two
# products still split (three)
SSD_PASSES_F32 = (3, 3, 3, 3)
SSD_PASSES_BF16_BC = (1, 3, 2, 3)

SOURCES = ("paged_attention.cu", "bitplane.cu", "bitplane_matmul.cu", "ssd.cu",
           "flash_attention.cu", "exp_delta.cu", "flash_attention_bwd.cu", "ssd_bwd.cu")

B, S, HKV, REP, HD, BITS = 8, 1024, 3, 3, 64, 16
# integer report counters that came with shared-prefix pages, and the
# count of prefill shapes that came with padded admission: the phase-3
# digest leaves them out, so that it compares with trees from before them
NEW_REPORT_KEYS = ("prefill_chunks_skipped", "prefix_requests_matched",
                   "prefix_tokens_matched", "prefix_pages_matched", "prefix_bytes_deduped",
                   "prefill_compiles")
# Phase 3p's request mix: make_trace's three classes at deployment sizes on
# a 1,024-token context (name, shared prefix, suffix range, new tokens,
# weight): chat turns behind a 384-token system prompt, agentic loops
# behind a 256-token tool preamble, long documents with nothing shared
PREFIX_CLASSES = (("chat", 384, (16, 96), (16, 48), 0.6),
                  ("agentic", 256, (16, 64), (24, 64), 0.2),
                  ("longdoc", 0, (300, 600), (8, 32), 0.2))
# 20 requests: at 32 and at 24 the phase took 201 and 154 s on the card,
# past the 150 s it is given (PERF.md §6)
PREFIX_REQUESTS = 20
# each timed phase-3p run's profiler window: this many scheduler steps
# from this step on (past the last arrival, step 25; requests that waited
# for a slot may still prefill in it)
PREFIX_WINDOW = (60, 4)
# tokens of a memory-tier page
PAGE = 16
LADDER = [(4, 16), (4, 12), (-1, 8)]
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# Teacher-forced logits: fused, rung and plain sum the attention in
# different orders (page by page online, rung by rung then merged, one
# pass), so a bf16 intermediate may round one step apart in any of 30
# layers; the tolerance is 5% of the largest logit, far below the gap a
# wrong plane count or a wrong page would open.
LOGITS_RTOL_OF_MAX = 5e-2
# Phase 7's attention sub-layers on a ring snapshot, each layer fed the
# same input and its own copy of the cache: the kernels and the plain
# attention round the attention's float32 sums apart, then round it to
# bf16 and project it through wo, so a row may land a bf16 step or two
# apart at its largest magnitude; the MoE after it (top-2 expert flips)
# is left out of this comparison.
ATTN_BF16_STEPS = 2
# Bit-plane matmul against its plain version: both take exact bf16 x bf16
# products in float32; the kernel sums them in K order, the plain version
# through cuBLAS in an order of its own.
MATMUL_ATOL = MATMUL_RTOL = 1e-4
# The bit-plane matmul at the Zamba2-7B MLP up-projection (d_model 3584 ->
# d_ff 14336), at decode (M 8) and at M 128: its weight (103 MB of bf16) is
# larger than L2, and phase 6 times it cold
ZAMBA_MLP = [(8, 3584, 14336), (128, 3584, 14336)]
# Quickstart: the top-8-plane matmul's relative error on the card against
# the CPU run's (float32 norms of sums taken in another order).
QUICKSTART_REL_TOL = 1e-3
# Full-width SmolLM-135M projections (K, N): q/o, k/v, gate/in, out
PROJECTIONS = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
# Mamba2-1.3B prefill: 4 prompts of 1024 tokens (4 chunks of 256), then
# greedy decode steps
SSM_B, SSM_L, SSM_STEPS = 4, 1024, 32
# SSD kernel against its plain version, relative to max |y|: both compute
# in float32 (the kernel's products are 3xTF32: each operand split into a
# TF32 high part and its remainder, the remainder times remainder term
# dropped, about 2^-20 of a product) and sum in other orders (the kernel's
# 64-token tiles, chunk states and warp scan against torch.cumsum and
# cuBLAS), which leaves errors near 1e-5 of the largest output; a wrong
# tile, mask or state hand-over opens errors of order 1.
SSD_REL_TOL = 1e-4
# SSD shapes (B, L, H, P, N, G): the Mamba2-1.3B and Zamba2-7B prefills of
# phases 5 and 5b, b and c per group as the models pass them
SSD_MAMBA = (4, 1024, 64, 64, 128, 1)
SSD_ZAMBA = (2, 4096, 112, 64, 64, 2)
# the device kernels of one SSD call (chunk states, the pass over chunks,
# the outputs)
SSD_KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel", "ssd_output_kernel")
# Mamba2, layer by layer (each layer fed the same input hidden state, so
# nothing is amplified), in bf16 steps at the layer output's largest
# magnitude.  Kernel against plain SSD: the scan's float32 differences can
# flip a bf16 rounding of y, which the norm and the output projection
# shrink; after that two roundings remain (the projection's bf16 result
# and the residual sum), each worth up to one step, in few elements.
# One recurrent decode step from the prefill cache of L-1 tokens against
# the prefill's last token: the chunked and recurrent forms also round the
# convolution at different points (per product in prefill, once in decode,
# as in the reference), which moves the conv output by a step; that
# reaches the layer output through the skip term and the scan on top of
# the two roundings, in most elements (at most 2.0 steps measured on the
# CPU over six prompt sets of the smoke model, 1.25 at 48 layers of width
# 256).
LAYER_KERNEL_STEPS, LAYER_KERNEL_SHARE = 2, 0.02
LAYER_DECODE_STEPS = 4
# Mamba2 logits end to end, relative to max |logit|: the random-weight
# 48-layer stack amplifies float32 rounding.  On a 48-layer Mamba2 of width
# 256 on the CPU, the plain SSD against itself at Q=128 (the same function,
# summed in another order) moved the logits by 5% of max |logit|, and
# prefill against decode by 3%; the run prints the same floor at full
# width.  A wrong state hand-over or tile moves them by the order of max
# |logit| itself.
SSM_LOGITS_RTOL_OF_MAX = 0.10
# Zamba2-7B prefill: 2 prompts of 4096 tokens, then greedy decode steps
ZAMBA_B, ZAMBA_L, ZAMBA_STEPS = 2, 4096, 32
# Flash attention against its plain version, in bf16 steps at each output
# row's own largest magnitude (per batch row, query and head; a causal
# row's output shrinks with its depth, so a step at the whole output's
# largest magnitude, set by the first rows, would pass a wrong deep row):
# both take float32 scores and round p to bf16 before p·v, but at the
# running max of 64-key tiles in the kernel and of 512-key chunks in the
# plain version, and they sum in another order.  That can flip the
# output's final rounding (one step) and moves the float32 value by a
# small fraction of a step, so two steps leave one of room.  A dropped or
# mis-masked tile or a wrong scale moves a row by the order of its
# magnitude, about 128 steps.
FLASH_BF16_STEPS = 2
# Zamba2's shared block, fed the same input, through the flash kernel
# against the plain version.  Its attention sub-layer is held to
# FLASH_BF16_STEPS at each token's largest magnitude: the o-projection
# rounds once more, and the flash output's flipped roundings move its
# float32 sum by a fraction of a step.  The block output, at its largest
# magnitude (the residual stream's), rounds three more times after that,
# each worth up to one step: the residual sum, the MLP's bf16 output and
# the final sum; the MLP's response to its bf16 input's flipped roundings
# adds under one more step, hence four.
SHARED_BLOCK_STEPS = 4
# Flash cases (b, sq, skv, hp, hkv, hd, start, kv_valid, causal, window):
# the Zamba2-7B prefill first (its inputs are timed in phase 6), SmolLM
# prefill chunks into a 1024-row slot and one at the end of a 4096-row
# cache (kv_valid passed as the int a prefill chunk passes, so the plan
# splits all of them but the first over the keys below it, and merges),
# a ragged L, a window, and bidirectional with kv_valid < Skv
FLASH_CASES = (
    (ZAMBA_B, ZAMBA_L, ZAMBA_L, 32, 32, 112, 0, ZAMBA_L, True, 0),
    (1, 64, S, 9, 3, HD, 0, 64, True, 0),
    (1, 64, S, 9, 3, HD, 448, 512, True, 0),
    (1, 64, S, 9, 3, HD, 960, S, True, 0),
    (1, 64, 4 * S, 9, 3, HD, 4 * S - 64, 4 * S, True, 0),
    (1, 512, S, 9, 3, HD, 0, 512, True, 0),
    (1, 512, S, 9, 3, HD, 448, 960, True, 0),
    (ZAMBA_B, 1000, 1000, 32, 32, 112, 0, 1000, True, 0),
    (ZAMBA_B, 1024, 1024, 32, 32, 112, 0, 1024, True, 64),
    (ZAMBA_B, 256, 1024, 32, 32, 112, 0, 700, False, 0),
    # phase 8's shapes: Nemotron-4 prefill chunks (rep 6: 21 tokens a
    # block), at the start of a 2,048-row slot and at an offset (split);
    # DeepSeek's (rep 1, hd 128); LLaVA's whole prefill (64 q heads over 8
    # kv heads, 2,880 patches + 1,024 tokens); Whisper's encoder
    # (bidirectional over 1,500 frames: the last 128-key tile holds 92) and
    # its cross attention (224 queries over the 1,500 frames)
    (1, 512, 2048, 48, 8, 128, 0, 512, True, 0),
    (1, 512, 2048, 48, 8, 128, 512, 1024, True, 0),
    (1, 512, 2048, 16, 16, 128, 0, 512, True, 0),
    (2, 3904, 3904, 64, 8, 128, 0, 3904, True, 0),
    (8, 1500, 1500, 6, 6, 64, 0, 1500, False, 0),
    (8, 224, 1500, 6, 6, 64, 0, 1500, False, 0),
)
# Zamba2 logits end to end, relative to max |logit|: as for Mamba2, the
# random-weight stack (81 slots) amplifies rounding; the run prints the
# plain versions against themselves in another sum order as the floor.
HYBRID_LOGITS_RTOL_OF_MAX = 0.10


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean ms per call of ``fn(i)`` between CUDA events."""
    import torch

    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_kernels() -> None:
    """Build every kernel library at once (one nvcc per source, started
    together), then load each."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.ssd import kernel as SK

    def one(source):
        t0 = time.perf_counter()
        path, build_log = _build.build(source)
        return path, build_log, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        built = list(pool.map(one, SOURCES))
    for path, build_log, secs in built:
        log(f"phase 1: built {path.name} in {secs:.2f} s")
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    for mod in (K, BK, MK, SK, FK, EK):
        mod._library()
    FK._library_bwd()
    SK._library_bwd()
    log(f"phase 1: {len(SOURCES)} libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


# A torch.profiler window on the card loses the device records of its
# first few kernel launches, and now and then of its first few hundred
# (matched launch by launch, as below; the cause lies inside the profiler
# and is not known).  So every window opens with short sleep kernels
# (pads), which its rows leave out, and is complete when every launch
# after them has its device record and it holds as many launches of each
# expected kernel as were made.  WINDOW_LOSSES keeps how many records each
# window lost; an incomplete window is logged and kept in
# INCOMPLETE_WINDOWS, and phase 6 fails on any.  The pads took most of
# the host time of the windows (PERF.md §6), so a timing loop, which can be
# measured again, opens its first window with REPEATABLE_PAD (above the
# most records a window has lost, 927, over 683 windows of three full runs)
# and only a second one with PROFILER_PAD.  A window also closes with
# half as many pads as it opened with: the profiler now and then loses
# the records of a window's last launches as well (the two windows that
# lost records past the leading pads over PR 25's runs, 46 and 215
# records, both lost the last launch's; a window over a serving run's
# steps, which cannot be measured again, lost 523 at its end), and a lost
# record is allowed among either run of pads.  A timing loop's window,
# the common one, thus closes with 512 pads, a stateful one with 2,048.
# A window traces device activity alone (kernels, copies and the runtime
# calls that launched them, which the matching reads), not the host's
# operators, and sums its device rows itself: over a Mamba2-1.3B training
# step that cut the window's host time about threefold, with the same
# launches matched and the same device time (``ssm_train_study.py``,
# PERF.md §6).
PROFILER_PAD = 4096
REPEATABLE_PAD = 1024
INCOMPLETE_WINDOWS: list = []
WINDOW_LOSSES: list = []
# host seconds each profiler window took, from opening it to its parsed events
WINDOW_SECONDS: list = []


def profile_window(run, what: str, pad: int = PROFILER_PAD) -> tuple:
    """A torch.profiler window, device activity traced, around ``run()``
    and a synchronise, opened with ``pad`` pad kernels and closed
    with ``pad // 2``.  Each kernel launch the host traced is matched to its
    device record by correlation id; a lost record is allowed only among
    the pads (``window_fault``).  Returns the profiler, its events and the
    fault (None when complete)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(pad):
            torch.cuda._sleep(1)
        run()
        for _ in range(pad // 2):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events = prof.events()
    WINDOW_SECONDS.append(time.perf_counter() - t0)
    launches = sorted((e for e in events if e.device_type == cpu and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    recorded = {e.id for e in events if e.device_type == cuda}
    lost = [i for i, e in enumerate(launches) if e.id not in recorded]
    WINDOW_LOSSES.append(len(lost))
    return prof, events, window_fault(len(launches), lost, pad)


def window_fault(n_launches: int, lost: list, pad: int) -> str | None:
    """The fault of a window of ``n_launches`` traced launches, ``pad`` pads
    first and ``pad // 2`` last, that lost the records of the launches at
    the indices ``lost`` (ascending): None when the run between the pads
    launched something and lost none of it."""
    tail = pad // 2
    run = range(pad, n_launches - tail)
    inside = [i for i in lost if i in run]
    if run and not inside:
        return None
    return (f"{n_launches} launches traced, {len(lost)} records lost, "
            f"{len(inside)} of them the run's, the last at launch "
            f"{lost[-1] if lost else None} (the pads are 0 to {pad - 1} and "
            f"{n_launches - tail} to {n_launches - 1})")


def incomplete(what: str, fault: str) -> None:
    INCOMPLETE_WINDOWS.append((what, fault))
    log(f"profiler: the window over {what} is incomplete ({fault})")


def device_rows(run, what: str, expect: dict | None = None, repeatable: bool = False) -> list:
    """The device rows of a ``profile_window`` around ``run()``, the pad
    kernels left out: a row a kernel or copy name (``key``), its records
    (``count``) and their summed microseconds (``self_device_time_total``,
    as ``key_averages`` names them).  ``expect`` maps a kernel-name
    fragment to the launches the window must hold.  A ``repeatable`` run
    (one with no state of its own: a timing loop, a prefill, decode steps
    on a copy of the cache) opens with REPEATABLE_PAD
    pads; if its window comes back incomplete it is measured once more
    with PROFILER_PAD, and only a second incomplete window counts (the
    profiler lost records past the pads in one window of 231 in a full
    run, PERF.md §6)."""
    import torch

    for attempt in range(2 if repeatable else 1):
        pad = REPEATABLE_PAD if repeatable and attempt == 0 else PROFILER_PAD
        _, events, fault = profile_window(run, what, pad)
        by_key: dict = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.name:
                row = by_key.setdefault(e.name, types.SimpleNamespace(
                    key=e.name, count=0, self_device_time_total=0.0))
                row.count += 1
                row.self_device_time_total += e.time_range.elapsed_us()
        rows = list(by_key.values())
        got = {m: sum(e.count for e in rows if m in e.key) for m in expect or {}}
        if fault is None and got != (expect or {}):
            fault = f"launches recorded {got}, made {expect}"
        if not fault:
            return rows
        if repeatable and attempt == 0:
            log(f"profiler: the window over {what} lost records ({fault}); measured again")
    incomplete(what, fault)
    return rows


def device_sequence(run, what: str) -> list:
    """The names of the device kernels and copies of ``run()`` in the order
    they started, from a ``profile_window`` (the pad kernels left out)."""
    import torch

    _, events, fault = profile_window(run, what)
    if fault:
        incomplete(what, fault)
    done = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and "spin_kernel" not in e.name), key=lambda e: e.time_range.start)
    return [e.name for e in done]


def device_ms(fn, match: str = "", iters: int = 50, per_call: int = 1) -> float:
    """Device time per call of ``fn(i)``: the summed time of the device
    kernels whose name contains ``match`` (all of them when empty) in a
    profiler window of ``iters`` calls (``device_rows``), divided by
    ``iters``.  Unlike CUDA events around back-to-back calls, it leaves
    out the gaps in which the host was still issuing the next launch.
    With a ``match`` (``per_call`` kernels a call) the window must hold
    ``iters * per_call`` launches of it."""
    return sum(device_ms_by_kernel(fn, match, iters, per_call).values())


def device_ms_by_kernel(fn, match: str = "", iters: int = 50, per_call: int = 1) -> dict:
    """``device_ms`` split by kernel: each matching kernel's name (the
    profiler's key) to its device ms per call of ``fn(i)``."""
    fn(0)

    def run():
        for i in range(iters):
            fn(i)

    return {e.key: e.self_device_time_total / iters / 1e3
            for e in device_rows(run, match or "a plain call",
                                 {match: iters * per_call} if match else None,
                                 repeatable=True)
            if match in e.key}


def device_ms_each(calls: list, match: str, iters: int, what: str) -> list:
    """``device_ms`` of each ``(fn, per_call)`` of ``calls`` from one
    profiler window: each fn is called once before it, then ``iters``
    times in a row inside it, fn after fn.  The window's device kernels
    whose name contains ``match``, in the order they started, must number
    ``iters * per_call`` a fn, and are split in that order; each fn's time
    is its kernels' summed durations over ``iters``.  One window in place
    of one a fn (the pads' host time dominates a short fn's); as a
    ``repeatable`` window of ``device_rows``, it opens with REPEATABLE_PAD
    pads and an incomplete one is measured once more with PROFILER_PAD."""
    import torch

    for fn, _ in calls:
        fn(0)

    def run():
        for fn, _ in calls:
            for i in range(iters):
                fn(i)

    want = sum(iters * per_call for _, per_call in calls)
    for attempt in range(2):
        _, events, fault = profile_window(run, what,
                                          REPEATABLE_PAD if attempt == 0 else PROFILER_PAD)
        done = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                       and match in e.name), key=lambda e: e.time_range.start)
        if fault is None and len(done) != want:
            fault = f"{len(done)} launches of {match} recorded, {want} made"
        if not fault:
            break
        if attempt == 0:
            log(f"profiler: the window over {what} lost records ({fault}); measured again")
    else:
        incomplete(what, fault)
    out, at = [], 0
    for _, per_call in calls:
        group = done[at:at + iters * per_call]
        at += iters * per_call
        out.append(sum(e.time_range.elapsed_us() for e in group) / iters / 1e3)
    return out


def random_case(torch, dev, gen, shape=(B, S, HKV, REP, HD), choices=(0, 8, 12, 16, 16),
                valid=(1024, 700, 333, 0, 17, 1000, 512, 64)):
    """Kernel inputs: packed planes of random bf16 KV, keeps drawn from
    ``choices`` (0: a page never read), the valid lengths ``valid`` (a 0 is
    a row with nothing valid).  The default is the serving shape: keeps {8,
    12, 16} with keep-0 pages, ragged lengths, row 3 with nothing valid."""
    from repro_torch.kernels.paged_attention.ref import pack_kv_ref

    b, s, hkv, rep, hd = shape

    def randn(*sh):
        return torch.randn(sh, generator=gen, device=dev).to(torch.bfloat16)

    q = randn(b, hkv, rep, hd)
    kp = pack_kv_ref(randn(b, s, hkv, hd))
    vp = pack_kv_ref(randn(b, s, hkv, hd))
    choice = torch.tensor(choices, device=dev, dtype=torch.int32)
    keeps = choice[torch.randint(0, len(choices), (b, s // 16), generator=gen, device=dev)]
    lens = torch.tensor(valid, device=dev)
    tok_keep = keeps.repeat_interleave(16, dim=1)
    ok = torch.arange(s, device=dev)[None] < lens[:, None]
    mask = (ok & (tok_keep > 0)).to(torch.int8).contiguous()
    return q, kp, vp, keeps.contiguous(), mask, tok_keep


# Phase 2's second paged-attention case: Yi-9B's head shape (Hkv 4, rep 8,
# hd 128; src/repro/configs/yi_9b.py) at B 2, S 4096, keeps {0, 4, 8, 16},
# row 1 with nothing valid
YI_HEADS = (4, 8, 128)
YI_CASE = ((2, 4096) + YI_HEADS, (0, 4, 8, 16), (4096, 0))


def check_rung_partials(torch, got, want) -> None:
    """Unnormalised rung partials (o, m, l) against the plain version.  o is
    compared after dividing by l: p is rounded to bf16 at the running max
    in the kernel and at the final max in the plain version, so o's terms
    differ by up to 2**-8 relative, which a sum that cancels turns into a
    large relative error of o itself but not of o / l."""
    (o_k, m_k, l_k), (o_r, m_r, l_r) = got, want
    torch.testing.assert_close(m_k, m_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(l_k, l_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(o_k / l_k.clamp(min=1e-30)[..., None],
                               o_r / l_r.clamp(min=1e-30)[..., None],
                               atol=KERNEL_ATOL, rtol=KERNEL_RTOL)


def check_kernels(torch, dev) -> dict:
    """Both paged-attention kernels against their plain versions at the
    serving shape and at YI_CASE (tolerances KERNEL_ATOL / RTOL); the rows
    with nothing valid must come out exactly 0."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {"paged_attention_fused": 0.0, "paged_attention_rung": 0.0}
    cases = [("serving", random_case(torch, dev, gen), 3, (8, 12, 16)),
             ("yi-9b heads", random_case(torch, dev, gen, *YI_CASE), 1, (4, 8, 16))]
    for what, case, empty, rungs in cases:
        fused, rung = check_paged_case(torch, case, empty, rungs)
        errs["paged_attention_fused"] = max(errs["paged_attention_fused"], fused)
        errs["paged_attention_rung"] = max(errs["paged_attention_rung"], rung)
        log(f"phase 2: paged attention ({what}, B S Hkv rep hd = "
            f"{tuple(case[0].shape[:1]) + (case[1].shape[2],) + tuple(case[0].shape[1:])}) "
            f"matches plain on the card; max abs err fused {fused:.3g}, rung {rung:.3g}")
    return errs


def check_paged_case(torch, case, empty: int, rungs) -> tuple:
    """One case through both kernels and their plain versions: fused
    output, each rung's partials (``check_rung_partials``) and their merge,
    which must also match the fused output; row ``empty`` exactly 0.
    Returns the max abs errors (fused, rung)."""
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as O
    from repro_torch.kernels.paged_attention import ref as R

    q, kp, vp, keeps, mask, tok_keep = case
    got = K.paged_attention_fused(q, kp, vp, keeps, mask)
    want = R.paged_attention_fused_ref(q, kp, vp, keeps, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    if not (torch.all(got[empty] == 0) and torch.all(want[empty] == 0)):
        raise AssertionError("fused: the row with nothing valid is not exactly 0")
    parts_k, parts_r = [], []
    for keep in rungs:
        mk = (mask * (tok_keep == keep)).to(torch.int8).contiguous()
        pk = K.paged_attention_rung(q, kp, vp, mk, keep=keep)
        pr = R.paged_attention_rung_ref(q, kp, vp, mk, keep)
        torch.cuda.synchronize()
        check_rung_partials(torch, pk, pr)
        parts_k.append(pk)
        parts_r.append(pr)
    merged_k = O.merge_rung_partials(parts_k)
    merged_r = O.merge_rung_partials(parts_r)
    torch.testing.assert_close(merged_k, merged_r, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    torch.testing.assert_close(merged_k, got, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    if not torch.all(merged_k[empty] == 0):
        raise AssertionError("rung: the row with nothing valid is not exactly 0")
    rung_err = max(
        float((merged_k - merged_r).abs().max()),
        *(float((a[0] / a[2].clamp(min=1e-30)[..., None]
                 - w[0] / w[2].clamp(min=1e-30)[..., None]).abs().max())
          for a, w in zip(parts_k, parts_r)))
    return float((got - want).abs().max()), rung_err


def int_err(got, want) -> float:
    """Largest |got - want| of two integer (or raw-bit) tensors, as int64."""
    import torch

    if got.dtype == torch.bfloat16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    return float((got.long() - want.long()).abs().max()) if got.numel() else 0.0


# The bit-plane cases of phase 2: flat containers (width in bytes, bits) and
# lengths (one octet; m/8 = 37, a ragged last plane word; the decode token
# rows, one slot's cache per layer, and a length that is a multiple of 8
# but not of the reference's 32768-value block); the decode append's
# positions (0, mid, S - 1, past S and negative, clamped as the reference
# clips; idle rows at their own position); prefill chunk offsets (0, mid,
# the end) and unpack keeps
BITPLANE_WIDTHS = ((1, 8), (2, 16), (2, 12), (4, 32))
BITPLANE_LENGTHS = (8, 8 * 37, B * HKV * HD, S * HKV * HD, 8 * 12345)
APPEND_POS = (0, S // 2, S - 1, S + 7, -3, 5, 700, 1)
CHUNK = 256
CHUNK_STARTS = (0, S // 2 - 64, S - CHUNK)
UNPACK_KEEPS = (16, 12, 8, 4, 0)


def check_bitplane_kernels(torch, dev) -> dict:
    """Pack and unpack bit for bit, the matmul within MATMUL_ATOL/RTOL,
    each against its plain version on the same CUDA inputs.  The flat
    kernels at every container and the cases above; the KV entry points,
    K and V in one launch, on the serving cache's views: the decode append
    into a layer, a prefill chunk into one slot, and the unpack of a
    layer's slot (a prefill chunk's read) and of a layer range of one slot
    (the memory tier's read) at each keep."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane import ref as BR
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.bitplane_matmul import ops as MM
    from repro_torch.kernels.bitplane_matmul import ref as MR

    gen = torch.Generator(device=dev).manual_seed(3)
    err = {"bitplane_pack": 0.0, "bitplane_unpack": 0.0}

    def held(name, what, got, want):
        e = int_err(got, want)
        err[name] = max(err[name], e)
        if got.dtype == torch.bfloat16:  # raw bits: a NaN pattern equals itself
            got, want = got.view(torch.int16), want.view(torch.int16)
        if not torch.equal(got, want):
            raise AssertionError(f"{name} differs from plain {what}: max |kernel - plain| {e}")

    for width, bits in BITPLANE_WIDTHS:
        dtype = BK.CONTAINERS[width]
        for m in BITPLANE_LENGTHS:
            u = torch.randint(0, 1 << bits, (m,), generator=gen, device=dev,
                              dtype=torch.int64).to(dtype)
            planes = BK.pack(u, bits)
            held("bitplane_pack", f"at m={m}, {bits} bits in {dtype}", planes,
                 BR.pack_ref(u, bits))
            for keep in sorted({bits, 12, 8, 4, 0} & set(range(bits + 1)), reverse=True):
                got = BK.unpack(planes[:keep].contiguous(), bits, keep, dtype)
                held("bitplane_unpack", f"at m={m}, {bits} bits in {dtype}, keep {keep}",
                     got, BR.unpack_ref(planes, bits, keep, dtype))

    def planes_like():
        return torch.randint(0, 256, (2, BITS, B, S, HKV, HD // 8), generator=gen,
                             device=dev, dtype=torch.int32).to(torch.uint8)

    def rows(c):
        return [torch.randn((B if c == 1 else 1, c, HKV, HD), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2)]

    caches = [planes_like(), planes_like()]
    plain = [c.clone() for c in caches]
    k, v = rows(1)
    pos = torch.tensor(APPEND_POS, device=dev, dtype=torch.int32)
    BK.reset_launches()
    BK.pack_kv_into(k, v, caches[0][1], caches[1][1], pos)
    BR.pack_kv_into_ref(k, v, plain[0][1], plain[1][1], pos)
    for start in CHUNK_STARTS:
        k, v = rows(CHUNK)
        BK.pack_kv_into(k, v, *(c.narrow(2, 3, 1)[0] for c in caches), start)
        BR.pack_kv_into_ref(k, v, *(c.narrow(2, 3, 1)[0] for c in plain), start)
    for c, want in zip(caches, plain):
        held("bitplane_pack", f"in the KV append at positions {APPEND_POS} and chunks "
             f"of {CHUNK} at {CHUNK_STARTS}", c, want)
    if BK.LAUNCHES["bitplane_pack"] != 1 + len(CHUNK_STARTS):
        raise AssertionError(f"pack_kv_into launched {BK.LAUNCHES}: one launch a call")
    for keep in UNPACK_KEEPS:
        for what, view in (("a layer's slot", lambda c: c.narrow(2, 3, 1)[1]),
                           ("one slot's layers", lambda c: c[:, :, 5, 100:900].movedim(1, 0))):
            views = [view(c) for c in caches]
            held("bitplane_unpack", f"of {what} at keep {keep}", BK.unpack_kv_pair(*views, keep),
                 BR.unpack_kv_pair_ref(*views, keep))
    if BK.LAUNCHES["bitplane_unpack"] != 2 * len(UNPACK_KEEPS):
        raise AssertionError(f"unpack_kv_pair launched {BK.LAUNCHES}: one launch a call")
    torch.cuda.synchronize()
    log(f"phase 2: pack/unpack match plain bit for bit (max |kernel - plain| {err}): flat "
        f"at (width, bits) {BITPLANE_WIDTHS}, m {BITPLANE_LENGTHS}, keeps down to 0; "
        f"K and V in one launch: the decode append at {APPEND_POS} (S {S}), prefill chunks "
        f"of {CHUNK} at {CHUNK_STARTS}, unpack of a slot and of a layer range at keeps "
        f"{UNPACK_KEEPS}")
    errs = dict(err)
    worst = 0.0
    for m, k, n in [(8, 1024, 1024), *ZAMBA_MLP] + [(m, k, n) for m in (8, 128)
                                                    for k, n in PROJECTIONS]:
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        planes = MM.pack_weights(w)
        for keep in (16, 12, 8, 4, 1, 0):
            got = MK.bitplane_matmul(x, planes, keep=keep)
            want = MR.bitplane_matmul_ref(x, planes, keep)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=MATMUL_ATOL, rtol=MATMUL_RTOL)
            worst = max(worst, float((got - want).abs().max()))
    errs["bitplane_matmul"] = worst
    log(f"phase 2: bit-plane kernels match plain on the card (pack/unpack "
        f"bit-exact); bitplane_matmul max abs err {worst:.3g}")
    return errs


def ssd_case(torch, dev, gen, shape=SSD_MAMBA, l=None, h0: bool = True):
    """SSD inputs at ``shape`` (B, L, H, P, N, G; L replaced by ``l`` when
    given): dt in [1e-3, 1e-1], A = -exp(a_log) with exp(a_log) in [1, 16]
    as ``ssm_params`` draws them, so dt·A reaches -1.6 and a chunk's cumsum
    some -400; unit-normal b and c per group and x·dt scaled by dt."""
    bsz, length, h, p, n, g = shape
    l = l or length
    a = -(torch.rand((h,), generator=gen, device=dev) * 15 + 1)
    dt = torch.rand((bsz, l, h), generator=gen, device=dev) * 0.099 + 1e-3
    xdt = torch.randn((bsz, l, h, p), generator=gen, device=dev) * dt[..., None]
    b = torch.randn((bsz, l, g, n), generator=gen, device=dev)
    c = torch.randn((bsz, l, g, n), generator=gen, device=dev)
    state = torch.randn((bsz, h, n, p), generator=gen, device=dev) if h0 else None
    return xdt, dt * a, b, c, state


def ssd_cases():
    """Phase 2's SSD cases (name, shape, L, h0): the Mamba2-1.3B prefill
    with b and c per group (one group), a ragged L, L below one chunk, the
    same prefill with b and c per head (G = H, the reference's contract),
    and the Zamba2-7B prefill (two groups); the first and the last are
    timed in phase 6."""
    per_head = SSD_MAMBA[:5] + (SSD_MAMBA[2],)
    return (("mamba2", SSD_MAMBA, None, True), ("ragged", SSD_MAMBA, 1000, True),
            ("short", SSD_MAMBA, 37, False), ("per-head", per_head, None, True),
            ("zamba2", SSD_ZAMBA, None, True))


def check_ssd_kernel(torch, dev) -> dict:
    """The SSD kernel against its plain version on the same CUDA inputs,
    within SSD_REL_TOL of max |y| (and of max |h_final|), at
    ``ssd_cases``.  Returns {name: (max abs err, inputs)} for the Mamba2
    and Zamba2 prefill shapes."""
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.kernels.ssd import ref as SR

    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for name, shape, l, h0 in ssd_cases():
        case = ssd_case(torch, dev, gen, shape, l, h0)
        y, hf = SO.ssd(*case, chunk=256)
        y_r, hf_r = SR.ssd_ref(*case, chunk=256)
        torch.cuda.synchronize()
        err_y = float((y - y_r).abs().max())
        err_h = float((hf - hf_r).abs().max())
        rel_y = err_y / float(y_r.abs().max())
        rel_h = err_h / float(hf_r.abs().max())
        log(f"phase 2: ssd {name} B L H P N G = {shape[:1] + (l or shape[1],) + shape[2:]} "
            f"h0={h0}: max abs err y {err_y:.3g} (rel {rel_y:.3g}), h_final {err_h:.3g} "
            f"(rel {rel_h:.3g}), tolerance {SSD_REL_TOL} of max")
        if not (rel_y <= SSD_REL_TOL and rel_h <= SSD_REL_TOL):
            raise AssertionError(f"ssd kernel differs from plain at {name}")
        if name in ("mamba2", "zamba2"):
            out[name] = (max(err_y, err_h), case)
        del y, hf, y_r, hf_r
    return out


def check_flash_kernel(torch, dev) -> tuple:
    """The flash kernel against its plain version on the same CUDA inputs
    at FLASH_CASES, within FLASH_BF16_STEPS at each output row's largest
    magnitude.  Returns (max abs err at the Zamba2-7B prefill shape, its
    inputs)."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=dev).manual_seed(6)
    first = None
    for b, sq, skv, hp, hkv, hd, start, valid, causal, window in FLASH_CASES:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v = randn(b, sq, hp, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
        pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq)
        pos = pos.contiguous()
        kv_valid = torch.full((b,), valid, dtype=torch.int32, device=dev)
        got = FO.flash_attention(q, k, v, q_pos=pos, kv_valid=valid, causal=causal,
                                 window=window)
        want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=kv_valid,
                                      causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        steps = row_bf16_steps(got, want)
        log(f"phase 2: flash_attention B={b} Sq={sq} Skv={skv} Hp={hp} Hkv={hkv} hd={hd} "
            f"start={start} kv_valid={valid} causal={causal} window={window}: max abs "
            f"err {err:.4g}; {steps:.2f} bf16 steps at its row's max |out| (tolerance "
            f"{FLASH_BF16_STEPS}); {err / bf16_step(want):.2f} steps at the whole "
            f"output's max |out| {float(want.float().abs().max()):.4g}")
        if not (torch.isfinite(got.float()).all() and steps <= FLASH_BF16_STEPS):
            raise AssertionError(f"flash kernel differs from plain at {(b, sq, skv, hp, hd)}")
        if first is None:
            first = (err, (q, k, v, pos, kv_valid))
    return first


# Exponent-delta cases (rows, G, bits): a 512-token serving span (4 stored
# layers x 2 streams x 32 pages, 192 channels each; its inputs are timed in
# phase 6), a decode page fill (8 pages), the quickstart's KV (32 groups of
# 256 channels), fp8_e4m3 in uint8, a ragged row count, the reference's
# shorter groups, a group the kernel takes at run time, and fp32
EXP_DELTA_SPAN_ROWS = 256 * 192
EXP_DELTA_CASES = (
    (EXP_DELTA_SPAN_ROWS, 16, 16), (8 * 192, 16, 16), (32 * 256, 16, 16),
    (EXP_DELTA_SPAN_ROWS, 16, 8), (7 * 24, 16, 16), (300, 8, 16), (64, 4, 8),
    (100, 12, 16), (96, 16, 32),
)
EXP_DELTA_FIELDS = {16: (7, 0xFF), 8: (3, 0xF), 32: (23, 0xFF)}
# The fused cluster-and-encode (the KV page write's entry point) at the views
# the memory tier gives it, (kind, tensor shape, group, bits): the serving
# span as slot_kv_bits returns it ((layers, 2, t, C), the transpose of a
# (2, layers, t, C) unpack) and a decode page fill, one re-activated tail
# page, compress_kv's ragged (t, C), the quickstart's KV, fp8_e4m3 in uint8,
# fp32, G 8 and 12, C = 24 at an aligned and at an unaligned start, rows
# that are no whole vectors inside wider ones and one channel's 2-byte rows
# with a ragged tail (the byte path), one channel of whole groups (the
# direct path, as the flat rows take it), and channels cut in chunks
EXP_DELTA_VIEWS = (
    ("span", (2, 4, 512, 192), 16, 16), ("span", (2, 4, 16, 192), 16, 16),
    ("reactivated", (2, 1, 9, 192), 16, 16), ("tokens", (37, 192), 16, 16),
    ("tokens", (512, 256), 16, 16), ("span", (2, 4, 40, 192), 16, 8),
    ("tokens", (37, 96), 16, 32), ("span", (2, 2, 70, 192), 8, 16),
    ("span", (2, 2, 70, 192), 12, 16), ("tokens", (45, 24), 16, 16),
    ("offset", (45, 24), 16, 16), ("wide", (33, 20), 16, 16),
    ("tokens", (33, 1000), 16, 16), ("tokens", (48, 1), 16, 16),
    ("tokens", (35, 1), 16, 16),
)


def encode_view(u, kind: str, shape: tuple):
    """The view ``kind`` of raw bits ``u`` (flat, at least one value more
    than ``shape`` holds; for "wide" shape[0] * (shape[1] + 8)): the tensor
    itself, the (layers, 2, t, C) transpose of (2, layers, t, C), one stream
    of one layer of that, a (t, C) one value past an aligned start, or the C
    channels after the first 3 of a (t, C + 8) row."""
    n = math.prod(shape)
    if kind == "wide":
        return u[: shape[0] * (shape[1] + 8)].view(shape[0], shape[1] + 8)[:, 3 : 3 + shape[1]]
    if kind == "offset":
        return u[1 : n + 1].view(shape)
    v = u[:n].view(shape)
    if kind in ("span", "reactivated"):
        v = v.transpose(0, 1)
    return v[0, 1] if kind == "reactivated" else v


def check_exp_delta_kernels(torch, dev) -> tuple:
    """Encode and decode bit for bit against their plain versions on the
    same CUDA inputs: the flat entry points at EXP_DELTA_CASES (random bits;
    the span also as bf16 KV with spread exponents), the round trip, and
    decode of top-k plane truncations of the span's encoded values (through
    the pack and unpack kernels); the fused cluster-and-encode at
    EXP_DELTA_VIEWS (random bits; the serving span also as that bf16 KV).
    Returns the largest |kernel - plain| (as int64) of encode (values and
    bases) and of decode over every case, which must be 0, the span's bf16
    KV bits as (rows, 16) and the serving span view of them (timed in phase
    6)."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.exp_delta import ref as ER

    def err(got, want) -> int:
        return int((got.long() - want.long()).abs().max())

    gen = torch.Generator(device=dev).manual_seed(7)
    span = (torch.randn((EXP_DELTA_SPAN_ROWS, 16), generator=gen, device=dev)
            * torch.exp(2 * torch.randn((EXP_DELTA_SPAN_ROWS, 1), generator=gen,
                                        device=dev)))
    span = span.to(torch.bfloat16).view(torch.int16)
    cases = [(span, 16)]
    for rows, g, bits in EXP_DELTA_CASES:
        u = torch.randint(0, 1 << bits, (rows, g), generator=gen, device=dev,
                          dtype=torch.int64)
        cases.append((ER._narrow(u, BK.CONTAINERS[bits // 8]), bits))
    errs = {"exp_delta_encode": 0, "exp_delta_decode": 0}
    for u, bits in cases:
        man, mask = EXP_DELTA_FIELDS[bits]
        enc, base = EK.encode(u, man, mask)
        enc_r, base_r = ER.encode_ref(u, man, mask)
        back = EK.decode(enc, base, man, mask)
        e_enc = max(err(enc, enc_r), err(base, base_r))
        e_dec = err(back, ER.decode_ref(enc, base, man, mask))
        errs["exp_delta_encode"] = max(errs["exp_delta_encode"], e_enc)
        errs["exp_delta_decode"] = max(errs["exp_delta_decode"], e_dec)
        if e_enc or e_dec:
            raise AssertionError(f"exp_delta differs from plain at {tuple(u.shape)}, {bits} "
                                 f"bits: encode by {e_enc}, decode by {e_dec}")
        if not torch.equal(back, u):
            raise AssertionError(f"exp_delta decode(encode(u)) != u at {tuple(u.shape)}")
    man, mask = EXP_DELTA_FIELDS[16]
    enc, base = EK.encode(span, man, mask)
    planes = BK.pack(enc.reshape(-1), 16)
    for keep in (12, 8, 4):
        trunc = BK.unpack(planes[:keep].contiguous(), 16, keep, torch.int16).reshape(enc.shape)
        e_dec = err(EK.decode(trunc, base, man, mask), ER.decode_ref(trunc, base, man, mask))
        errs["exp_delta_decode"] = max(errs["exp_delta_decode"], e_dec)
        if e_dec:
            raise AssertionError(f"exp_delta_decode differs from plain by {e_dec} at keep {keep}")
    span_view = encode_view(span.reshape(-1), "span", EXP_DELTA_VIEWS[0][1])
    views = [(span_view, "span", EXP_DELTA_VIEWS[0][1], 16, 16)]
    for kind, shape, g, bits in EXP_DELTA_VIEWS:
        n = shape[0] * (shape[1] + 8) if kind == "wide" else math.prod(shape) + 1
        u = torch.randint(0, 1 << bits, (n,), generator=gen, device=dev, dtype=torch.int64)
        u = ER._narrow(u, BK.CONTAINERS[bits // 8])
        views.append((encode_view(u, kind, shape), kind, shape, g, bits))
    for view, kind, shape, g, bits in views:
        man, mask = EXP_DELTA_FIELDS[bits]
        enc, base = EK.cluster_encode(view, g, man, mask)
        enc_r, base_r = ER.cluster_encode_ref(view, g, man, mask)
        if enc.shape != enc_r.shape or base.shape != base_r.shape:
            raise AssertionError(f"cluster_encode at {kind} {shape}: shapes {tuple(enc.shape)}, "
                                 f"{tuple(base.shape)} != {tuple(enc_r.shape)}, "
                                 f"{tuple(base_r.shape)}")
        e_enc = max(err(enc, enc_r), err(base, base_r))
        errs["exp_delta_encode"] = max(errs["exp_delta_encode"], e_enc)
        if e_enc:
            raise AssertionError(f"cluster_encode differs from plain by {e_enc} at {kind} "
                                 f"{shape}, G {g}, {bits} bits")
    log(f"phase 2: exp_delta encode/decode match plain bit for bit (max |kernel - plain| "
        f"{errs}) at {[tuple(u.shape) + (b,) for u, b in cases]} (rows, G, bits), at "
        f"keep 12, 8, 4, and the fused cluster-and-encode at "
        f"{[(k, sh, g, b) for _, k, sh, g, b in views]} (view, shape, G, bits)")
    return errs, span, span_view


def make_requests(n: int = 16):
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(0)
    return [Request(rid=i, prompt=rng.integers(0, 49152, int(rng.integers(100, 601))).astype(np.int32),
                    max_new_tokens=int(rng.integers(32, 65))) for i in range(n)]


def engine_config(kernel: str):
    from repro_torch.core.quantization import PrecisionLadder
    from repro_torch.serving import EngineConfig

    return EngineConfig(max_batch=B, max_ctx=S, ladder=PrecisionLadder(LADDER),
                        codec="lz4", device_kv="bitplane", decode_kernel=kernel,
                        backend="paged")


@contextlib.contextmanager
def write_job_ledger():
    """During one serving run, the page-write jobs queued (the ``KV_WRITE``
    and ``BACKGROUND`` jobs that store a page; eviction write-backs carry
    no store call and are left out) and, by job class, the jobs and
    logical bytes that ``retire`` cancelled, counted by wrapping the job
    queue's ``push`` and ``cancel_seq`` (class attributes, restored on
    exit).  Decode fetches are sized at service time, so a cancelled one
    counts 0 bytes."""
    from repro_torch.memctl.queue import JobClass, PriorityJobQueue

    writes = (JobClass.KV_WRITE, JobClass.BACKGROUND)
    ledger = {"submitted_write_bytes": 0, "cancelled_write_bytes": 0, "cancelled": {}}
    push, cancel = PriorityJobQueue.push, PriorityJobQueue.cancel_seq

    def counted_push(self, job):
        if job.klass in writes and job.fn is not None:
            ledger["submitted_write_bytes"] += job.nbytes
        push(self, job)

    def counted_cancel(self, seq_id):
        for q in self._queues.values():
            for job in q:
                if job.seq_id != seq_id:
                    continue
                n = ledger["cancelled"].setdefault(job.klass.name, [0, 0])
                n[0] += 1
                n[1] += job.nbytes
                if job.klass in writes and job.fn is not None:
                    ledger["cancelled_write_bytes"] += job.nbytes
        return cancel(self, seq_id)

    PriorityJobQueue.push, PriorityJobQueue.cancel_seq = counted_push, counted_cancel
    try:
        yield ledger
    finally:
        PriorityJobQueue.push, PriorityJobQueue.cancel_seq = push, cancel


class DecodeWatch:
    """Records the decode steps of one phase-3 check run (a repeat of a
    timed serving run, so that no work of the check falls inside the timed
    run's clock) without a hook in the port: ``model.decode`` is wrapped by
    an instance attribute (removed on exit) that calls the model's own
    method, then reads which (request, output index) each logits row
    produces from the scheduler's slots.  The row a decode step computes for
    a slot produces output index ``len(output) + 1``: the token it consumes
    (``pending``) is appended as ``output[len(output)]`` when the step
    commits.

    It keeps each step's logits on the card (126 steps of (8, 49152)
    float32 at the phase's sizes, ~200 MB), the ladder plane map and
    lengths the step read, and the row map.  At each request's first
    divergent output (``first``: request -> output index, from the timed
    runs) it replays the step through the plain attention, on the run's own
    kernel route and a copy of the cache (its length set back by the one
    token the step added; launch counts saved and restored), and keeps the
    plain row."""

    def __init__(self, torch, model, sched, first: dict):
        self.torch, self.model, self.sched, self.first = torch, model, sched, first
        self.orig = model.decode
        self.logits: list = []  # the logits of each decode call
        self.maps: list = []    # the plane map and lengths each call read
        self.rows: dict = {}    # (rid, j) -> (call, row)
        self.plain: dict = {}   # (rid, j) at a first divergence -> the plain row

    def __enter__(self):
        self.model.decode = self.decode
        return self

    def __exit__(self, *exc):
        del self.model.decode

    def decode(self, params, token, cache, keeps=None, decode_kernel="fused"):
        plane_map = (cache["planes"].clone(), cache["len"].clone())
        logits, cache = self.orig(params, token, cache, keeps=keeps,
                                  decode_kernel=decode_kernel)
        live = [(i, s.req.rid, len(s.req.output) + 1)
                for i, s in enumerate(self.sched._slots)
                if s is not None and not s.prefilling]
        for i, rid, j in live:
            self.rows[(rid, j)] = (len(self.logits), i)
        at = [(i, rid, j) for i, rid, j in live if self.first.get(rid) == j]
        if at:
            plain = self._plain(params, token, cache, keeps, decode_kernel)
            for i, rid, j in at:
                self.plain[(rid, j)] = plain[i]
        self.logits.append(logits)
        self.maps.append(plane_map)
        return logits, cache

    def _plain(self, params, token, cache, keeps, decode_kernel):
        """This step's logits again, through ``plain_attention()``, on a
        copy of the cache."""
        c = {k: v.clone() for k, v in cache.items()}
        c["len"] = cache["len"] - 1
        with uncounted(), plain_attention():
            plain, _ = self.orig(params, token, c, keeps=keeps, decode_kernel=decode_kernel)
        return plain


def first_divergences(fused_reqs, rung_reqs) -> dict:
    """Request -> the first output index at which the two timed runs'
    greedy tokens differ (requests that agree throughout are left out)."""
    first = {}
    for fr, rr in zip(fused_reqs, rung_reqs):
        j = next((n for n, (a, b) in enumerate(zip(fr.output, rr.output)) if a != b), None)
        if j is not None:
            first[fr.rid] = j
    return first


def check_repeat(kernel: str, timed, check) -> None:
    """A check run must repeat its timed run: the same greedy tokens and
    the same counters (the serving path's control flow follows modeled
    time, not the clock), so that what it checks is what the timed run
    computed."""
    (t_reqs, t_rep), (c_reqs, c_rep) = timed, check
    keys = ("decode_steps", "kv_logical_bytes", "device_bytes_read", "kv_fetch_logical",
            "engine_jobs_cancelled")
    if [r.output for r in t_reqs] != [r.output for r in c_reqs] \
            or any(t_rep[key] != c_rep[key] for key in keys):
        raise AssertionError(f"{kernel}: the check run did not repeat the timed run: "
                             f"{[(key, t_rep[key], c_rep[key]) for key in keys]}")


def check_fused_against_rung(torch, fused_reqs, rung_reqs, first, fw, rw,
                             names=("fused", "rung"), phase="phase 3") -> None:
    """Phase 3's check of the two serving runs, from their check runs'
    watches (``names`` the two runs, ``phase`` the log lines' prefix; phase
    3p holds its sharing-off and sharing-on runs to it the same way).  Up to each request's first divergent output both fed the same
    tokens.  At every first divergence each run's row must lie within
    LOGITS_RTOL_OF_MAX of its largest logit of the plain attention's row on
    that run's own cache (the teacher-forced bound): the kernel and its
    plain version read the same inputs.  Where the two runs also read the
    same ladder plane map at every step so far (the ladder re-ranks pages
    from the keys, which the two kernels round apart, so a rank can flip at
    a tie and the runs then read different planes), every row with equal
    history must agree across the runs within the same bound; under it a
    greedy token can flip only where the top-2 gap is below twice the
    bound: a near-tie.  A larger difference is a kernel fault and fails the
    run."""
    keys = [(r.rid, j) for r in fused_reqs
            for j in range(1, min(first.get(r.rid, len(r.output) - 1), len(r.output) - 1) + 1)]
    missing = [key for key in keys if key not in fw.rows or key not in rw.rows]
    missing += [(rid, j) for rid, j in first.items()
                if (rid, j) not in fw.plain or (rid, j) not in rw.plain]
    if missing:
        raise AssertionError(f"no recorded decode row for (request, output) {missing[:8]} "
                             f"(prefill tokens differ, or the watch missed the step)")
    at_f, at_r = [fw.rows[key] for key in keys], [rw.rows[key] for key in keys]
    f = torch.stack([fw.logits[c][i] for c, i in at_f])
    r = torch.stack([rw.logits[c][i] for c, i in at_r])
    # did the two runs read the same plane map for this slot (the pages up
    # to and with the one this step's token lands in)?
    fp = torch.stack([fw.maps[c][0][i] for c, i in at_f])
    rp = torch.stack([rw.maps[c][0][i] for c, i in at_r])
    fl = torch.stack([fw.maps[c][1][i] for c, i in at_f])
    rl = torch.stack([rw.maps[c][1][i] for c, i in at_r])
    pages = torch.arange(fp.shape[1], device=fp.device)
    map_diff = ((fp != rp) & (pages[None] * 16 <= rl[:, None])).any(1) | (fl != rl)
    # top-2 gaps from topk; top tokens from argmax, as the greedy sampler
    # takes them (logits are bf16 products: exact ties occur, and topk may
    # break them otherwise)
    tf, tr = f.topk(2, dim=-1), r.topk(2, dim=-1)
    stats = torch.stack([
        (r - f).abs().amax(-1), torch.maximum(r.abs().amax(-1), f.abs().amax(-1)),
        tf.values[:, 0] - tf.values[:, 1], tr.values[:, 0] - tr.values[:, 1],
        map_diff.float()], dim=1).cpu().tolist()
    rec = dict(zip(keys, stats))
    div = sorted(first.items())
    row = {key: n for n, key in enumerate(keys)}
    pf = torch.stack([fw.plain[key] for key in div])
    pr = torch.stack([rw.plain[key] for key in div])
    fd, rd = f[[row[key] for key in div]], r[[row[key] for key in div]]
    vs_plain = torch.stack([
        (fd - pf).abs().amax(-1), torch.maximum(fd.abs().amax(-1), pf.abs().amax(-1)),
        (rd - pr).abs().amax(-1), torch.maximum(rd.abs().amax(-1), pr.abs().amax(-1)),
        pf.argmax(-1).float(), pr.argmax(-1).float()], dim=1).cpu().tolist()

    nf, nr = names
    split, faults = {}, []
    for rid, j in keys:  # in output order per request
        if rec[(rid, j)][4] and rid not in split:
            split[rid] = j
    outputs = {fr.rid: (fr.output, rr.output) for fr, rr in zip(fused_reqs, rung_reqs)}
    worst_plain = 0.0
    for (rid, j), (d_fp, s_fp, d_rp, s_rp, top_pf, top_pr) in zip(div, vs_plain):
        d, scale, gap_f, gap_r, _ = rec[(rid, j)]
        fo, ro = outputs[rid]
        moved = [name for name, tok, top in ((nf, fo[j], top_pf), (nr, ro[j], top_pr))
                 if tok != int(top)]
        worst_plain = max(worst_plain, d_fp / s_fp, d_rp / s_rp)
        log(f"{phase} divergence: request {rid} at output {j}/{len(fo)}: tokens {nf} {fo[j]} "
            f"{nr} {ro[j]}, plain on each run's cache {int(top_pf)} / {int(top_pr)} (left its "
            f"plain top: {', '.join(moved) or 'neither'}); top-2 gap {nf} {gap_f:.5f} {nr} "
            f"{gap_r:.5f}; max|{nf}-{nr}| {d:.5f} (tolerance {LOGITS_RTOL_OF_MAX * scale:.5f}), "
            f"max|{nf}-plain| {d_fp:.5f} ({LOGITS_RTOL_OF_MAX * s_fp:.5f}), max|{nr}-plain| "
            f"{d_rp:.5f} ({LOGITS_RTOL_OF_MAX * s_rp:.5f}); plane maps "
            + (f"differ since output {split[rid]}" if rid in split else "equal at every step"))
        if d_fp > LOGITS_RTOL_OF_MAX * s_fp or d_rp > LOGITS_RTOL_OF_MAX * s_rp:
            faults.append(("kernel vs plain", rid, j, d_fp, d_rp))
    clean = [key for key in keys if key[0] not in split or key[1] < split[key[0]]]
    worst = max((rec[key][0] / rec[key][1] for key in clean), default=0.0)
    faults += [(f"{nf} vs {nr}", *key, rec[key][0], LOGITS_RTOL_OF_MAX * rec[key][1])
               for key in clean if rec[key][0] > LOGITS_RTOL_OF_MAX * rec[key][1]]
    prefix = [first.get(fr.rid, len(fr.output)) for fr in fused_reqs]
    log(f"{phase}: first divergent output per request (agreeing prefix lengths) {prefix}; "
        f"{sum(rid not in split for rid in first)} first divergences on equal plane maps, "
        f"{sum(rid in split for rid in first)} after the maps split; {len(clean)} of "
        f"{len(keys)} decode rows with equal history read equal plane maps, max "
        f"|{nf}-{nr}| / max|logit| over them {worst:.5f}; at the {len(div)} first "
        f"divergences max |kernel-plain| / max|logit| {worst_plain:.5f} (bound "
        f"{LOGITS_RTOL_OF_MAX})")
    if faults:
        raise AssertionError(f"rows differ beyond the bound (check, request, output, diff, "
                             f"diff or tol): {faults}")


def check_write_drift(fused, rung) -> None:
    """The two runs' stored logical bytes may differ only by the page
    writes that ``retire`` cancelled: each run's stored kv_write bytes plus
    its cancelled write bytes must equal the write bytes it queued, and
    the queued bytes (set by the requests' lengths alone) must be equal."""
    for name, (rep, ledger) in (("fused", fused), ("rung", rung)):
        log(f"phase 3 [{name}]: engine_jobs_cancelled {rep['engine_jobs_cancelled']}, "
            f"cancelled by class (jobs, logical bytes) {ledger['cancelled']}; write bytes "
            f"queued {ledger['submitted_write_bytes']} = stored kv_logical_bytes "
            f"{rep['kv_logical_bytes']} + cancelled {ledger['cancelled_write_bytes']}")
        if rep["kv_logical_bytes"] + ledger["cancelled_write_bytes"] \
                != ledger["submitted_write_bytes"]:
            raise AssertionError(f"{name}: queued page writes are neither stored nor cancelled")
    (f_rep, f_led), (r_rep, r_led) = fused, rung
    if f_led["submitted_write_bytes"] != r_led["submitted_write_bytes"]:
        raise AssertionError("the two runs queued different page-write bytes")
    log(f"phase 3: kv_logical_bytes differ by "
        f"{f_rep['kv_logical_bytes'] - r_rep['kv_logical_bytes']}, cancelled write bytes by "
        f"{r_led['cancelled_write_bytes'] - f_led['cancelled_write_bytes']}: "
        f"kv_logical_bytes + cancelled write bytes equal "
        f"({f_rep['kv_logical_bytes'] + f_led['cancelled_write_bytes']})")


def serve(torch, model, params, kernel: str, first=None) -> tuple:
    """One main-path run: launch counts reset just before, read just after.
    With ``first`` (request -> first divergent output of the two timed
    runs) it is a check run, which repeats the timed run under a
    ``DecodeWatch`` and a ``write_job_ledger`` (returned; None for a timed
    run)."""
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config(kernel))
    reqs = make_requests()
    for m in launch_modules():
        m.reset_launches()
    watch = ledger = None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if first is not None:
            ledger = stack.enter_context(write_job_ledger())
            watch = stack.enter_context(DecodeWatch(torch, model, sched, first))
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    rep = {**sched.report(), "engine_jobs_cancelled": sched.stats["engine_jobs_cancelled"]}
    encodes = sched.backend.page_encodes
    if not all(r.done and not r.truncated and len(r.output) == r.max_new_tokens
               for r in reqs):
        raise AssertionError(f"{kernel}: not every request completed")
    steps = rep["decode_steps"]
    n_layers = model.cfg.n_layers
    if kernel == "fused":
        if launches["paged_attention_fused"] != n_layers * steps:
            raise AssertionError(f"fused launches {launches} != {n_layers} x {steps} steps")
        if launches["paged_attention_rung"] != 0:
            raise AssertionError(f"fused run launched the rung kernel: {launches}")
    elif launches["paged_attention_rung"] <= 0 or launches["paged_attention_fused"] != 0:
        raise AssertionError(f"rung run launches {launches}")
    if launches["bitplane_pack"] <= 0 or launches["bitplane_unpack"] <= 0:
        raise AssertionError(f"{kernel}: the KV planes did not go through the "
                             f"pack and unpack kernels: {launches}")
    if not launches["exp_delta_encode"] == sum(encodes.values()) > 0:
        raise AssertionError(f"{kernel}: exp_delta_encode launches "
                             f"{launches['exp_delta_encode']} != the backend's page "
                             f"transforms {encodes}")
    if launches["exp_delta_decode"] != 0:
        raise AssertionError(f"{kernel}: serving decoded stored pages: {launches}")
    if launches["flash_attention"] != n_layers * rep["prefill_chunks"]:
        raise AssertionError(f"{kernel}: flash launches {launches['flash_attention']} != "
                             f"{n_layers} x {rep['prefill_chunks']} prefill chunks")
    if not rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0:
        raise AssertionError(
            f"device_bytes_read {rep['device_bytes_read']} != kv_read_device_bytes "
            f"{rep['kv_read_device_bytes']}")
    if not rep["device_bytes_read"] < rep["kv_fetch_logical"]:
        raise AssertionError("the ladder did not cut device reads below full precision")
    log(f"phase 3 [{kernel}{'' if first is None else ' check run, clock includes the check'}]: "
        f"{len(reqs)} requests, {steps} decode steps, "
        f"{rep['prefill_chunks']} prefill chunks, launches {launches}, page transforms "
        f"{encodes}, decode {rep['decode_tokens']} tok in "
        f"{rep['decode_s']:.3f} s = {rep['decode_tok_per_s']:.1f} tok/s, "
        f"prefill {rep['prefill_tokens']} tok in {rep['prefill_s']:.3f} s, "
        f"wall {wall:.2f} s, "
        f"device_bytes_read {rep['device_bytes_read']}, kv_fetch_logical "
        f"{rep['kv_fetch_logical']}, kv_stored/logical "
        f"{rep['kv_stored_bytes']}/{rep['kv_logical_bytes']}")
    return reqs, rep, launches, watch, ledger


@contextlib.contextmanager
def plain_attention():
    """Route the serving path's paged attention through the plain PyTorch
    versions on the card (the kernels' reference), for one comparison."""
    from repro_torch.kernels.paged_attention import ops as O
    from repro_torch.kernels.paged_attention import ref as R

    saved = O.paged_attention_fused, O.paged_attention_rung
    O.paged_attention_fused = lambda q, kp, vp, pk, m, bits=16, page_tokens=16: \
        R.paged_attention_fused_ref(q, kp, vp, pk, m, bits, page_tokens)
    O.paged_attention_rung = lambda q, kp, vp, m, keep, bits=16: \
        R.paged_attention_rung_ref(q, kp, vp, m, keep, bits)
    try:
        yield
    finally:
        O.paged_attention_fused, O.paged_attention_rung = saved


def snapshot(torch, model, params):
    """Serving cache after admission: 8 requests prefilled (ladder planes
    assigned) and four decode steps taken; returns (cache, next tokens,
    keeps)."""
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config("fused"))
    for r in make_requests()[:B]:
        sched.submit(r)
    for _ in range(4):
        sched.step()
    torch.cuda.synchronize()
    cache = {k: v.clone() for k, v in sched.backend.cache.items()}
    cache["len"] = torch.as_tensor(sched._lens, device=cache["planes"].device)
    tok = torch.tensor([s.pending for s in sched._slots], device=cache["planes"].device)
    return cache, tok, sched.backend.device_keeps()


def parent_span_encode(bits, group: int = 16) -> tuple:
    """The parent's transform of a page-writing span between its unpack and
    its bit-plane pack: a ragged tail page padded by a cat, the pages of
    the (..., t, C) view reshaped to (pages, 16, C) (a copy: the transposed
    view's leading dims do not merge), clustered (a second copy), then the
    flat encode of the channel-major rows (today's flat entry point: the
    same kernel's direct path, where the parent ran the first port's rows
    kernel).  The yardstick of phases 3 and 6 (its flat encode counts in
    LAUNCHES)."""
    from repro_torch.core.kv_clustering import pad_tail
    from repro_torch.kernels.exp_delta import kernel as EK

    man, mask = EXP_DELTA_FIELDS[16]
    pages = pad_tail(bits, group)
    u = pages.reshape(-1, group, pages.shape[-1]).reshape(-1, pages.shape[-1])
    grouped = u.reshape(u.shape[0] // group, group, -1).permute(0, 2, 1).contiguous()
    return EK.encode(grouped.reshape(-1, group), man, mask)


def write_span_kernels(torch, model, params) -> dict:
    """The device kernels of two page-writing spans as the backend runs
    them (``slot_kv_bits``, then ``encode_span``) on the serving cache after
    admission: whole pages of a slot (up to 512 tokens) and 12 tokens fewer
    (a ragged tail page), each in a profiler window.  Exactly one kernel,
    the exponent-delta encode, must run between the span's unpack and its
    pack; the parent's route between them (``parent_span_encode``) is
    counted beside it."""
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config("fused"))
    for r in make_requests()[:B]:
        sched.submit(r)
    for _ in range(4):
        sched.step()
    torch.cuda.synchronize()
    backend = sched.backend
    slot = max(range(B), key=lambda i: int(sched._lens[i]))
    whole = min(512, int(sched._lens[slot]) // PAGE * PAGE)
    if whole < 2 * PAGE:
        raise AssertionError(f"slot {slot} holds {sched._lens[slot]} tokens, too few for a span")
    out = {}
    for t1 in (whole, whole - 12):
        seq = device_sequence(lambda: backend.encode_span(backend.slot_kv_bits(slot, 0, t1)),  # noqa: B023
                              f"a page-writing span of {t1} tokens")
        unpack = [i for i, name in enumerate(seq) if "bitplane_unpack_kernel" in name]
        pack = [i for i, name in enumerate(seq) if "bitplane_pack_kernel" in name]
        if len(unpack) != 1 or len(pack) != 1 or unpack[0] > pack[0]:
            raise AssertionError(f"a span of {t1} tokens ran {seq}: not one unpack, then one pack")
        between = seq[unpack[0] + 1 : pack[0]]
        if len(between) != 1 or "exp_delta_encode_kernel" not in between[0]:
            raise AssertionError(f"a span of {t1} tokens ran {between} between its unpack and "
                                 f"its pack, not the one encode")
        bits = backend.slot_kv_bits(slot, 0, t1)
        parent = device_sequence(lambda: parent_span_encode(bits),  # noqa: B023
                                 f"the parent's route over a span of {t1} tokens")
        out[t1] = {"kernels": len(between), "parent_route_kernels": len(parent)}
        log(f"phase 3: a page-writing span of {t1} tokens (slot {slot}, "
            f"{backend.stored_layers()} stored layers x 2 streams) runs {seq}; between its "
            f"unpack and its pack {between}; the parent's route there ran {parent}")
    return out


def profile_decode(torch, model, params, n: int = 8) -> dict:
    """Where a steady decode step's time goes: host wall time per step
    without the profiler, then device kernel time per step (and the top
    kernels) from a torch.profiler window of as many steps.  Eight slots
    decode throughout; no request retires inside either window."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config("fused"))
    for r in make_requests()[:B]:
        sched.submit(r)
    for _ in range(3):  # admission + prefill, then two decode steps
        sched.step()
    torch.cuda.synchronize()
    K.reset_launches()
    BK.reset_launches()
    EK.reset_launches()
    t0 = time.perf_counter()
    for _ in range(n):
        sched.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    per_step = {k: v / n for k, v in {**K.LAUNCHES, **BK.LAUNCHES, **EK.LAUNCHES}.items()}
    # page fills that land in the window add an unpack, an encode and a
    # pack each, so these vary with the window
    log(f"phase 3 launches per steady decode step: {per_step}")

    def steps():
        for _ in range(n):
            sched.step()

    rows = device_rows(steps, "SmolLM decode steps")
    dev_us = [(getattr(e, "self_device_time_total", 0), e.key) for e in rows]
    busy_ms = sum(t for t, _ in dev_us) / n / 1e3
    # the parent's append made three a layer (a row index, two index_puts)
    index = {e.key[:64]: e.count / n for e in rows if "index" in e.key.lower()}
    log(f"phase 3 profile: indexing kernels per decode step (none from the plane "
        f"cache's append): {index}")
    if sum(index.values()) >= model.cfg.n_layers:
        raise AssertionError(f"{sum(index.values())} indexing kernels a decode step: the "
                             f"plane cache's append still indexes")
    top = sorted(dev_us, reverse=True)[:6]
    if busy_ms <= 0:
        log("phase 3 profile: the profiler recorded no device time (not measured)")
        return per_step
    log(f"phase 3 profile: decode step {wall_ms:.2f} ms host wall (unprofiled), "
        f"{busy_ms:.3f} ms device kernel time (profiled), device busy share "
        f"{busy_ms / wall_ms:.3f}; top kernels ms/step: "
        + "; ".join(f"{k[:48]} {t / n / 1e3:.3f}" for t, k in top))
    return per_step


def prefill_chunk_launches(torch, model, params, cache) -> dict:
    """Kernel launches of one 256-token prefill chunk into slot 0 of a copy
    of the serving cache (the model's own work; the memory tier adds its
    page-store unpacks when a page fills): one flash launch a layer."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.flash_attention import kernel as FK

    c = {k: v.clone() for k, v in cache.items()}
    dev = c["planes"].device
    tokens = (torch.arange(256, device=dev)[None] * 7) % model.cfg.vocab
    BK.reset_launches()
    FK.reset_launches()
    model.prefill_chunk(params, tokens, c, 0, 0, 255)
    torch.cuda.synchronize()
    launches = {**BK.LAUNCHES, **FK.LAUNCHES}
    n = model.cfg.n_layers
    expect_launches("a prefill chunk", launches, {"bitplane_pack": n, "bitplane_unpack": n,
                                                  "flash_attention": n})
    log(f"phase 3 launches per prefill chunk (model): {launches}")
    return launches


def expect_launches(what: str, launches: dict, expect: dict) -> None:
    """Fail unless ``launches`` holds exactly the counts of ``expect``."""
    got = {k: launches[k] for k in expect}
    if got != expect:
        raise AssertionError(f"{what} launched {got}, expected {expect}")


def decode_launches(torch, model, params, cache, tok, keeps) -> dict:
    """Kernel launches of one ``model.decode`` step on a copy of the serving
    cache: K and V of every layer packed into the plane cache in one launch
    (no index_put), nothing unpacked."""
    from repro_torch.kernels.bitplane import kernel as BK

    c = {k: v.clone() for k, v in cache.items()}
    torch.cuda.synchronize()
    BK.reset_launches()
    model.decode(params, tok, c, keeps=keeps)
    torch.cuda.synchronize()
    launches = dict(BK.LAUNCHES)
    expect_launches("a model decode step", launches,
                    {"bitplane_pack": model.cfg.n_layers, "bitplane_unpack": 0})
    log(f"phase 3 launches per model decode step: {launches}")
    return launches


def phase3_digest(reqs, rep, full: bool = False) -> str:
    """A digest of a serving run's greedy tokens and its integer counters
    (bytes, pages, steps: everything but times and rates), equal for two
    runs that generated and moved the same.  By default over the counters
    that reports had before shared-prefix pages came (``NEW_REPORT_KEYS``
    left out), so that it compares with older trees; ``full`` takes every
    integer counter."""
    import hashlib

    counters = {k: v for k, v in sorted(rep.items())
                if isinstance(v, int) and not isinstance(v, bool)
                and (full or k not in NEW_REPORT_KEYS)}
    text = json.dumps([[list(map(int, r.output)) for r in reqs], counters])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def teacher_forced(torch, model, params, cache, tok, keeps, phase: str = "phase 3") -> dict:
    """One decode step from a copy of ``cache`` through the fused kernel,
    the rung kernel and the plain attention: fused and rung logits each
    within LOGITS_RTOL_OF_MAX of the largest plain logit."""
    def run(kernel):
        c = {k: v.clone() for k, v in cache.items()}
        logits, _ = model.decode(params, tok, c, keeps=keeps, decode_kernel=kernel)
        return logits

    fused, rung = run("fused"), run("rung")
    with plain_attention():
        plain = run("fused")
    torch.cuda.synchronize()
    scale = float(plain.abs().max())
    tol = LOGITS_RTOL_OF_MAX * scale
    d_fp = float((fused - plain).abs().max())
    d_rp = float((rung - plain).abs().max())
    agree = float((fused.argmax(-1) == plain.argmax(-1)).float().mean())
    log(f"{phase} teacher-forced: max|logit| {scale:.4f}, max|fused-plain| {d_fp:.5f}, "
        f"max|rung-plain| {d_rp:.5f}, tolerance {tol:.5f}, fused/plain argmax agree {agree:.3f}")
    if not (d_fp <= tol and d_rp <= tol):
        raise AssertionError(f"{phase}: teacher-forced logits disagree across fused/rung/plain")
    return {"max_logit": scale, "fused_vs_plain": d_fp, "rung_vs_plain": d_rp,
            "argmax_agree": agree}


def memory_tier_round_trip(torch, cache, n_layers: int = 4, min_pages: int = 512) -> dict:
    """Phase 3c: the snapshot's device KV (valid rows of the first slots
    that hold at least ``min_pages`` pages over ``n_layers`` stored layers
    and both streams) through ``put_sequence`` into a card store and into
    a CPU store fed the same bits, then ``get_sequence`` back at several
    keeps.  Blobs, controller totals and reads must agree; the launches
    are one encode and one pack per put, one unpack and one decode per
    get."""
    from repro_torch.core.compressed_store import StoreConfig
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.paged_attention.ops import unpack_kv
    from repro_torch.serving.kv_cache import PAGE_TOKENS, CompressedKVStore

    dev = cache["planes"].device
    lens = [int(n) for n in cache["len"].tolist()]
    seqs, pages = {}, 0
    for slot, n in enumerate(lens):
        if pages >= min_pages:
            break
        for name, stream in (("k_planes", "k"), ("v_planes", "v")):
            pl = cache[name][:n_layers, :, slot, :n].movedim(1, 0)
            bits = unpack_kv(pl, BITS, BITS).view(torch.int16).reshape(n_layers, n, -1)
            for li in range(n_layers):
                seqs[(slot, li, stream)] = bits[li].contiguous()
        pages += 2 * n_layers * -(-n // PAGE_TOKENS)
    if pages < min_pages:
        raise AssertionError(f"the snapshot holds {pages} pages, fewer than {min_pages}")
    host_kv = {key: kv.cpu() for key, kv in seqs.items()}
    card = CompressedKVStore(config=StoreConfig(codec="lz4"))
    cpu = CompressedKVStore(config=StoreConfig(codec="lz4"))
    torch.cuda.synchronize()
    BK.reset_launches()
    EK.reset_launches()
    t0 = time.perf_counter()
    for (slot, li, stream), kv in seqs.items():
        card.put_sequence(slot, li, stream, kv)
    torch.cuda.synchronize()
    card_put = time.perf_counter() - t0
    put_launches = {**BK.LAUNCHES, **EK.LAUNCHES}
    t0 = time.perf_counter()
    for (slot, li, stream), kv in host_kv.items():
        cpu.put_sequence(slot, li, stream, kv)
    cpu_put = time.perf_counter() - t0
    n = len(seqs)
    if not (put_launches["exp_delta_encode"] == put_launches["bitplane_pack"] == n
            and put_launches["bitplane_unpack"] == put_launches["exp_delta_decode"] == 0):
        raise AssertionError(f"{n} put_sequence calls launched {put_launches}")
    for key, ct in cpu.controller._kv_pages.items():
        got = card.controller._kv_pages[key]
        if (got.segments, got.base_blob, got.valid_values) != \
                (ct.segments, ct.base_blob, ct.valid_values):
            raise AssertionError(f"page {key}: the card store's blobs differ from the CPU's")
    if not len(card.controller._kv_pages) == len(cpu.controller._kv_pages) == pages:
        raise AssertionError("the stores hold different pages")
    stored = card.footprint()["stored_bytes"]
    BK.reset_launches()
    EK.reset_launches()
    ladder = cache["planes"].cpu().tolist()
    t0 = time.perf_counter()
    for (slot, li, stream), kv in seqs.items():
        t = kv.shape[0]
        n_pages = -(-t // PAGE_TOKENS)
        for keep in (BITS, 12, 8, 4, "ladder"):
            keeps = {p: int(ladder[slot][p]) if keep == "ladder" else keep
                     for p in range(n_pages)}
            got = card.get_sequence(slot, li, stream, t, keeps, device=dev)
            want = torch.from_numpy(cpu.get_sequence(slot, li, stream, t, keeps).view("int16"))
            if not torch.equal(got.cpu(), want):
                raise AssertionError(f"{(slot, li, stream)}: the card read at keep {keep} "
                                     f"differs from the CPU store's")
            if keep == BITS and not torch.equal(got, kv):
                raise AssertionError(f"{(slot, li, stream)}: keep 16 does not read back "
                                     f"the device KV bit for bit")
    torch.cuda.synchronize()
    gets = time.perf_counter() - t0
    get_launches = {**BK.LAUNCHES, **EK.LAUNCHES}
    if not (get_launches["bitplane_unpack"] == get_launches["exp_delta_decode"] == 5 * n
            and get_launches["bitplane_pack"] == get_launches["exp_delta_encode"] == 0):
        raise AssertionError(f"{5 * n} get_sequence calls on the card launched {get_launches}")
    totals = card.controller.stats.totals
    if totals != cpu.controller.stats.totals:
        raise AssertionError(f"controller totals differ: {totals} vs "
                             f"{cpu.controller.stats.totals}")
    log(f"phase 3c: {n} sequences of slots {sorted({k[0] for k in seqs})}, {pages} pages "
        f"({pages * PAGE_TOKENS * 192 * 2} padded logical bytes) stored in {stored} B; put "
        f"{card_put / pages * 1e3:.3f} ms/page host (card store), {cpu_put / pages * 1e3:.3f} "
        f"ms/page (CPU store); {5 * n} reads from each store in {gets:.2f} s; launches of "
        f"the puts {put_launches}, of the card's gets {get_launches}; equal controller "
        f"totals {totals}")
    # the longest sequence's get unpacks its pages' planes in one launch:
    # a page is one group of 16 tokens x its channels
    get_values = max(-(-kv.shape[0] // PAGE_TOKENS) * PAGE_TOKENS * kv.shape[1]
                     for kv in seqs.values())
    return {"decode_launches": get_launches["exp_delta_decode"],
            "encode_launches": put_launches["exp_delta_encode"], "pages": pages,
            "sequences": n, "gets": 5 * n, "get_values": get_values}


# ---------------------------------------------------------------------------
# Phase 3p: shared-prefix pages and compressed weight streaming
# ---------------------------------------------------------------------------


def prefix_trace(n: int = PREFIX_REQUESTS, max_ctx: int = S, classes=PREFIX_CLASSES) -> list:
    """Phase 3p's requests: ``make_trace`` over ``classes``, Poisson
    arrivals at 0.5 a step, seed 0 (a new list of new requests each call)."""
    from repro_torch.serving import make_trace
    from repro_torch.serving.traces import RequestClass

    return make_trace(n, kind="poisson", rate=0.5, seed=0, max_ctx=max_ctx,
                      classes=[RequestClass(*c) for c in classes])


def prefix_config(base, sharing: bool, weights: str):
    """``base`` (phase 3's engine config) with sharing and weight streaming
    set, telemetry on where the weights stream (the exporters read it), and
    the lane engine unbounded in every run.  One full-width weight pass is
    212 MB of bf16; phase 3's lane window (4,096 cycles, 4 MiB a step)
    would take some 50 steps to stream one, and weight jobs outrank KV
    writes, so page writes would wait behind them for the whole run.  With
    every job of a step serviced in its own window, runs (b) and (c)
    differ by the weight jobs alone."""
    import dataclasses

    from repro_torch.memctl import MemCtlConfig
    from repro_torch.telemetry import TelemetryConfig

    return dataclasses.replace(
        base, prefix_sharing=sharing, weight_stream=weights,
        engine=MemCtlConfig(step_cycles=None),
        telemetry=TelemetryConfig() if weights == "compressed" else None)


def launch_modules() -> tuple:
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.ssd import kernel as SK

    return K, BK, FK, EK, SK


@contextlib.contextmanager
def uncounted():
    """Kernel launches made inside are left out of every LAUNCHES count."""
    mods = launch_modules()
    saved = [dict(m.LAUNCHES) for m in mods]
    try:
        yield
    finally:
        for m, counts in zip(mods, saved):
            m.LAUNCHES.update(counts)


class PrefixWatch:
    """Wraps one backend's prefix registration and adoption (instance
    attributes, removed on exit) to count the pack and unpack launches of
    each call, and checks the first adoption bit for bit: the slot's rows
    of every layer, read back through ``slot_kv_bits`` right after it, must
    equal the donor snapshot's (the read is left out of the counts)."""

    def __init__(self, torch, backend):
        self.torch, self.backend = torch, backend
        self.registrations: list = []  # (snapshots taken, packs, unpacks)
        self.adoptions: list = []      # (rid, tokens, packs, unpacks)
        self.exact = None              # (rid, tokens) of the adoption read back

    def __enter__(self):
        b = self.backend
        self._register, self._adopt = b._register_prefix, b._adopt_prefix_rows
        b._register_prefix, b._adopt_prefix_rows = self.register, self.adopt
        return self

    def __exit__(self, *exc):
        del self.backend._register_prefix, self.backend._adopt_prefix_rows

    @staticmethod
    def _counts() -> tuple:
        BK = launch_modules()[1]
        return BK.LAUNCHES["bitplane_pack"], BK.LAUNCHES["bitplane_unpack"]

    def register(self, slot_id: int, end: int) -> None:
        b = self.backend
        read, reads = b.slot_kv_bits, []

        def counted_read(*args, **kw):
            reads.append(args)
            return read(*args, **kw)

        b.slot_kv_bits = counted_read
        try:
            (p0, u0) = self._counts()
            self._register(slot_id, end)
            (p1, u1) = self._counts()
        finally:
            del b.slot_kv_bits
        self.registrations.append((len(reads), p1 - p0, u1 - u0))

    def adopt(self, slot_id: int, entry, lo: int, m: int) -> None:
        torch, b = self.torch, self.backend
        (p0, u0) = self._counts()
        self._adopt(slot_id, entry, lo, m)
        (p1, u1) = self._counts()
        rid = b._slots[slot_id].rid
        self.adoptions.append((rid, m - lo, p1 - p0, u1 - u0))
        if self.exact is not None:
            return
        with uncounted():
            got = b.slot_kv_bits(slot_id, lo, m, layers=slice(None))
        o = lo - entry.r0_token
        if not (torch.equal(got[:, 0], entry.k[:, o:o + m - lo])
                and torch.equal(got[:, 1], entry.v[:, o:o + m - lo])):
            raise AssertionError(f"request {rid}: the adopted rows [{lo}, {m}) of slot "
                                 f"{slot_id} differ from the donor snapshot's")
        self.exact = (rid, m - lo)


def serve_trace(torch, model, params, cfg, items, first=None, window=None) -> dict:
    """One phase-3p run: the trace's requests submitted at their arrival
    steps and served to the end of the backlog, launch counts reset just
    before the first step and read just after the drain, under a
    ``PrefixWatch`` (and, with ``first``, a ``DecodeWatch``: a check run).
    With ``window`` (first step, steps) on the card, a profiler window over
    those steps gives the device time a step (their host time is left out
    of the host time a step).  The weight reads the controller charges are
    counted by tensor name."""
    from collections import deque

    from repro_torch.serving import ContinuousScheduler

    dev = params["embed"]["table"].device
    t0 = time.perf_counter()
    sched = ContinuousScheduler(model, params, cfg, device=dev)
    build_s = time.perf_counter() - t0
    ctl = sched.backend.controller
    account, weight_reads = ctl.account_weight_read, collections.Counter()

    def counted_account(name, planes=None):
        weight_reads[name] += 1
        return account(name, planes)

    ctl.account_weight_read = counted_account
    pending = deque(items)
    reqs = [it.request for it in items]

    def advance():
        while pending and pending[0].arrival_step <= sched.step_count:
            sched.submit(pending.popleft().request)
        sched.step()

    for m in launch_modules():
        m.reset_launches()
    window_ms, window_wall = None, 0.0
    with contextlib.ExitStack() as stack:
        prefix = stack.enter_context(PrefixWatch(torch, sched.backend))
        watch = (stack.enter_context(DecodeWatch(torch, model, sched, first))
                 if first is not None else None)
        t0 = time.perf_counter()
        while pending or sched.has_work():
            if window and dev.type == "cuda" and sched.step_count == window[0]:
                tw = time.perf_counter()
                rows = device_rows(lambda: [advance() for _ in range(window[1])],
                                   f"phase 3p: {window[1]} steps from step {window[0]}")
                window_wall += time.perf_counter() - tw
                window_ms = sum(e.self_device_time_total for e in rows) / window[1] / 1e3
            else:
                advance()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    del ctl.account_weight_read
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    if not all(r.done and not r.truncated and len(r.output) == r.max_new_tokens for r in reqs):
        raise AssertionError("phase 3p: not every request completed")
    steps = sched.step_count - (window[1] if window_ms is not None else 0)
    return {"reqs": reqs, "rep": sched.report(), "launches": launches, "sched": sched,
            "watch": watch, "prefix": prefix, "weight_reads": weight_reads,
            "encodes": dict(sched.backend.page_encodes), "build_s": build_s, "wall": wall,
            "host_ms_a_step": (wall - window_wall) / max(1, steps) * 1e3,
            "device_ms_a_step": window_ms}


def check_prefix_launches(name: str, run: dict, n_layers: int) -> None:
    """A phase-3p run's launches on the card: flash 30 a prefill chunk the
    run made, the fused kernel 30 a decode step, one encode a page
    transform and no decode; a registration one unpack a snapshot it took
    and no pack, an adoption one pack (every layer) and no unpack."""
    got, rep = run["launches"], run["rep"]
    expect = {"flash_attention": n_layers * rep["prefill_chunks"],
              "paged_attention_fused": n_layers * rep["decode_steps"],
              "paged_attention_rung": 0,
              "exp_delta_encode": sum(run["encodes"].values()), "exp_delta_decode": 0}
    expect_launches(f"phase 3p run {name}", got, expect)
    regs = [r for r in run["prefix"].registrations if r[1:] != (0, r[0])]
    adopts = [a for a in run["prefix"].adoptions if a[2:] != (1, 0)]
    if regs or adopts:
        raise AssertionError(f"phase 3p run {name}: registrations (snapshots, packs, unpacks) "
                             f"{regs} or adoptions (request, tokens, packs, unpacks) {adopts} "
                             f"launched other than one unpack a snapshot and one pack an "
                             f"adoption")


def check_prefix_launch_deltas(a: dict, b: dict, n_layers: int) -> dict:
    """Sharing's launches, run (b) against run (a): once the launches that
    follow the chunks, decode steps and page transforms each run made are
    taken out (30 packs and 30 unpacks a prefill chunk, 30 packs a decode
    step, a pack and an unpack a transform), (b) adds one pack an
    adoption and one unpack a snapshot, and nothing else.  Returns the
    deltas."""
    def per(run, kind):
        rep, enc = run["rep"], sum(run["encodes"].values())
        steps = rep["decode_steps"] if kind == "bitplane_pack" else 0
        return run["launches"][kind] - n_layers * (rep["prefill_chunks"] + steps) - enc

    extra = {kind: per(b, kind) - per(a, kind) for kind in ("bitplane_pack", "bitplane_unpack")}
    expect = {"bitplane_pack": len(b["prefix"].adoptions),
              "bitplane_unpack": sum(r[0] for r in b["prefix"].registrations)}
    if extra != expect:
        raise AssertionError(f"phase 3p: sharing added launches {extra}, expected one pack an "
                             f"adoption and one unpack a snapshot {expect}")
    return extra


def once_per_layer(weight_reads, w: dict) -> dict:
    """The reference's once-per-layer identity over a run's weight reads:
    every layer charged the same number of passes, and that number is
    ``passes_fetched``.  Returns the passes per layer."""
    per_layer = collections.Counter()
    for name, n in weight_reads.items():
        per_layer[name.split("/", 1)[0]] += n
    tensors = len(weight_reads) // w["n_layers"]
    passes = {layer: n // tensors for layer, n in per_layer.items()}
    if len(passes) != w["n_layers"] or set(passes.values()) != {w["passes_fetched"]}:
        raise AssertionError(f"weight passes per layer {passes}, passes_fetched "
                             f"{w['passes_fetched']}")
    if not w["passes_consumed"] <= w["passes_fetched"] <= w["passes_consumed"] + 1:
        raise AssertionError(f"weights: {w['passes_consumed']} passes consumed, "
                             f"{w['passes_fetched']} fetched")
    return passes


def check_prefix_runs(a: dict, b: dict, c: dict) -> dict:
    """Phase 3p's checks across its runs (a: sharing off, b: on, c: on
    with the weights streamed compressed): sharing happened and its ledger
    holds; the matched tokens were skipped, not recomputed; adoption was
    exact; streaming the weights moved no token and no KV byte; the
    weights were charged once a layer a pass; the exporters' outputs are
    valid.  Returns what the phase prints."""
    import tempfile

    from repro_torch.serving.kv_cache import is_prefix_seq
    from repro_torch.telemetry import prometheus_snapshot, validate_trace, write_perfetto_trace

    px = b["rep"]["prefix"]
    if not (px["requests_matched"] > 0 and px["prefill_chunks_skipped"] > 0
            and px["bytes_deduplicated"] > 0):
        raise AssertionError(f"phase 3p: no sharing happened: {px}")
    store = b["sched"].backend.store
    shared = [kt for kt in store._lru if is_prefix_seq(kt[0])]
    if px["resident_shared_bytes"] != sum(store._lru[kt] for kt in shared) \
            or px["resident_shared_pages"] != len(shared):
        raise AssertionError(f"phase 3p: resident shared {px['resident_shared_pages']} pages, "
                             f"{px['resident_shared_bytes']} B; the store holds {len(shared)} "
                             f"pages, {sum(store._lru[kt] for kt in shared)} B")
    skipped = a["rep"]["prefill_tokens"] - b["rep"]["prefill_tokens"]
    if skipped != px["tokens_matched"]:
        raise AssertionError(f"phase 3p: (a) prefilled {skipped} tokens more than (b), "
                             f"which matched {px['tokens_matched']}")
    watch = b["prefix"]
    if watch.exact is None or len(watch.adoptions) != px["requests_matched"]:
        raise AssertionError(f"phase 3p: {len(watch.adoptions)} adoptions, "
                             f"{px['requests_matched']} requests matched")
    snapshots = sum(r[0] for r in watch.registrations)
    if not snapshots >= px["index_entries"] > 0 \
            or sum(r[0] for r in a["prefix"].registrations) or a["prefix"].adoptions:
        raise AssertionError(f"phase 3p: {snapshots} snapshots for {px['index_entries']} "
                             f"index entries; sharing off registered or adopted")
    if [r.output for r in c["reqs"]] != [r.output for r in b["reqs"]]:
        raise AssertionError("phase 3p: streaming the weights changed greedy tokens")
    for key in ("kv_fetch_physical", "device_bytes_read", "kv_stored_bytes"):
        if c["rep"][key] != b["rep"][key]:
            raise AssertionError(f"phase 3p: {key} {c['rep'][key]} with the weights "
                                 f"streamed, {b['rep'][key]} resident")
    if c["rep"]["prefix"] != px:
        raise AssertionError("phase 3p: streaming the weights changed the prefix report")
    w = c["rep"]["weights"]
    passes = once_per_layer(c["weight_reads"], w)
    wstore = c["sched"].backend.streamers[0].store
    if w["read_logical_bytes"] != w["passes_fetched"] * wstore.valid_logical_bytes:
        raise AssertionError(f"weights: fetched {w['read_logical_bytes']} logical bytes, "
                             f"{w['passes_fetched']} passes of {wstore.valid_logical_bytes}")
    if b["rep"]["weights"] != {"mode": "resident"}:
        raise AssertionError(f"resident weights streamed: {b['rep']['weights']}")
    tel = c["sched"].telemetry
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        trace = write_perfetto_trace(tel, path)
        summary = validate_trace(path)
        trace_bytes = Path(path).stat().st_size
    weight_events = sum(e.get("cat") == "weights" for e in trace["traceEvents"])
    if weight_events != tel.counts["weight_fetches"] or weight_events <= 0:
        raise AssertionError(f"the trace holds {weight_events} weight events, telemetry "
                             f"counted {tel.counts['weight_fetches']} fetches")
    prom = prometheus_snapshot(c["rep"])
    return {"tokens_skipped": skipped, "snapshots": snapshots,
            "adoptions": len(watch.adoptions), "exact": watch.exact,
            "passes_per_layer": sorted(set(passes.values())), "trace": summary,
            "trace_bytes": trace_bytes, "weight_events": weight_events,
            "prometheus_lines": len(prom.splitlines()), "prometheus_chars": len(prom)}


def run_prefix_phase(torch, model, params) -> dict:
    """Phase 3p: phase 3's model, ladder and engine config serving
    ``prefix_trace()`` three ways: (a) sharing off, (b) sharing on, (c)
    sharing on with the weights streamed compressed.  Checks each run's
    launches and the runs against each other (``check_prefix_runs``); where
    (a) and (b) part, check runs repeat both under a ``DecodeWatch`` and
    each run's row at every first divergence is held to the plain
    attention on its own cache (``check_fused_against_rung``)."""
    base = engine_config("fused")
    n_layers = model.cfg.n_layers
    runs = {}
    for name, sharing, weights in (("a", False, "resident"), ("b", True, "resident"),
                                   ("c", True, "compressed")):
        run = serve_trace(torch, model, params, prefix_config(base, sharing, weights),
                          prefix_trace(), window=PREFIX_WINDOW)
        check_prefix_launches(name, run, n_layers)
        rep = run["rep"]
        log(f"phase 3p [{name}: sharing {'on' if sharing else 'off'}, weights {weights}]: "
            f"{len(run['reqs'])} requests, {rep['decode_steps']} decode steps, "
            f"{rep['prefill_chunks']} prefill chunks ({rep['prefill_chunks_skipped']} skipped), "
            f"{rep['prefill_tokens']} prefill tokens; launches {run['launches']}; page "
            f"transforms {run['encodes']}; registrations (snapshots, packs, unpacks) "
            f"{collections.Counter(run['prefix'].registrations)}, adoptions (packs, unpacks) "
            f"{collections.Counter(a[2:] for a in run['prefix'].adoptions)}; scheduler built "
            f"in {run['build_s']:.2f} s; run wall {run['wall']:.2f} s, host "
            f"{run['host_ms_a_step']:.2f} ms a step, device "
            + (f"{run['device_ms_a_step']:.3f} ms" if run["device_ms_a_step"] else "not measured")
            + f" a step ({PREFIX_WINDOW[1]}-step profiler window from step "
            f"{PREFIX_WINDOW[0]}); decode {rep['decode_tok_per_s']:.1f} tok/s; digest "
            f"{phase3_digest(run['reqs'], rep, True)}")
        runs[name] = run
    a, b, c = runs["a"], runs["b"], runs["c"]
    out = check_prefix_runs(a, b, c)
    deltas = check_prefix_launch_deltas(a, b, n_layers)
    log(f"phase 3p: prefix report (b) {b['rep']['prefix']}")
    log(f"phase 3p: (a) prefilled {out['tokens_skipped']} tokens more than (b) = (b)'s "
        f"tokens_matched; prefill chunks (a) {a['rep']['prefill_chunks']}, (b) "
        f"{b['rep']['prefill_chunks']}, chunk_schedule of the matched prefixes "
        f"{b['rep']['prefill_chunks_skipped']}; {out['snapshots']} snapshots, "
        f"{out['adoptions']} adoptions, which add {deltas} launches to (b) beyond its "
        f"chunks, decode steps and page transforms; the first adoption (request, tokens) "
        f"{out['exact']} equals the donor snapshot bit for bit")
    w = c["rep"]["weights"]
    log(f"phase 3p: weights streamed (c): {w}; scheduler with attach_weights built in "
        f"{c['build_s']:.2f} s; passes per layer {out['passes_per_layer']}; (c)'s tokens, "
        f"kv_fetch_physical {c['rep']['kv_fetch_physical']} and device_bytes_read "
        f"{c['rep']['device_bytes_read']} equal (b)'s")
    log(f"phase 3p: Perfetto trace of (c): {out['trace']}, {out['trace_bytes']} B, "
        f"{out['weight_events']} weight events = telemetry's weight_fetches; Prometheus "
        f"snapshot {out['prometheus_lines']} lines, {out['prometheus_chars']} characters")
    first = first_divergences(a["reqs"], b["reqs"])
    same = sum(x == y for ra, rb in zip(a["reqs"], b["reqs"])
               for x, y in zip(ra.output, rb.output))
    total = sum(len(r.output) for r in a["reqs"])
    log(f"phase 3p: (a) and (b) agree on {same}/{total} greedy tokens; "
        f"{len(first)} requests part")
    if first:
        checks = {}
        for name, sharing in (("a", False), ("b", True)):
            run = serve_trace(torch, model, params,
                              prefix_config(base, sharing, "resident"), prefix_trace(),
                              first=first)
            check_repeat(f"phase 3p run {name}", (runs[name]["reqs"], runs[name]["rep"]),
                         (run["reqs"], run["rep"]))
            checks[name] = run["watch"]
        check_fused_against_rung(torch, a["reqs"], b["reqs"], first, checks["a"], checks["b"],
                                 names=("off", "on"), phase="phase 3p")
        del checks
    return {name: {"launches": run["launches"], "decode_steps": run["rep"]["decode_steps"]}
            for name, run in runs.items()}


def run_quickstart(torch) -> dict:
    """The quickstart entry point on the card, launch counts reset just
    before and read just after; then on the CPU (plain versions) for the
    comparison.  Returns the card run's launches."""
    from repro_torch import quickstart
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.exp_delta import kernel as EK

    BK.reset_launches()
    MK.reset_launches()
    EK.reset_launches()
    t0 = time.perf_counter()
    gpu = quickstart.run("cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**BK.LAUNCHES, **MK.LAUNCHES, **EK.LAUNCHES}
    for line in gpu["lines"]:
        log(f"phase 4 quickstart: {line}")
    if (launches["bitplane_matmul"] != 2 or launches["bitplane_pack"] != 2
            or launches["exp_delta_encode"] != 1):
        raise AssertionError(f"quickstart launches {launches}: expected two packs (the "
                             f"weight and the KV surrogate), one exponent-delta encode "
                             f"and two bit-plane matmuls")
    cpu = quickstart.run("cpu")

    def strip(lines):
        return [re.sub(r"rel err [0-9.]+", "rel err", line) for line in lines]

    if strip(gpu["lines"]) != strip(cpu["lines"]):
        raise AssertionError(f"quickstart byte counts differ from the CPU run:\n"
                             f"{gpu['lines']}\n{cpu['lines']}")
    if abs(gpu["rel_err"] - cpu["rel_err"]) > QUICKSTART_REL_TOL:
        raise AssertionError(f"quickstart rel err {gpu['rel_err']} vs plain {cpu['rel_err']}")
    log(f"phase 4 quickstart: {secs:.2f} s on the card, launches {launches}; byte "
        f"counts equal the CPU run's, rel err {gpu['rel_err']:.6f} vs plain "
        f"{cpu['rel_err']:.6f}")
    return launches


@contextlib.contextmanager
def plain_ssd(q=None):
    """Route the model's SSD scan through the plain PyTorch version on the
    card (the kernel's reference), for one comparison; ``q`` overrides the
    model's chunk length (the same function, summed in another order)."""
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.kernels.ssd import ref as SR

    saved = SO.ssd
    SO.ssd = lambda xdt, da, b, c, h0=None, chunk=256: SR.ssd_ref(
        xdt, da, b, c, h0, q or chunk)
    try:
        yield
    finally:
        SO.ssd = saved


@contextlib.contextmanager
def plain_flash(chunk=None):
    """Route the model's prefill attention through the plain PyTorch flash
    version on the card (the kernel's reference), for one comparison;
    ``chunk`` overrides its 512-key chunks (the same function, summed in
    another order)."""
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention import ref as FR

    saved = FO.flash_attention
    FO.flash_attention = lambda q, k, v, *, q_pos, kv_valid, causal=True, window=0, \
        kv_pos=None: FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid,
                                            causal=causal, window=window,
                                            chunk=chunk or 512, kv_pos=kv_pos)
    try:
        yield
    finally:
        FO.flash_attention = saved


def run_mamba(torch, dev) -> dict:
    """Full-width Mamba2-1.3B through the step functions: prefill 4 seeded
    prompts of 1024 tokens, then 32 greedy decode steps, with the SSD
    launch count reset just before and read just after each; a profiler
    window over one prefill; the kernel-versus-plain and the
    prefill/decode consistency checks on the logits."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import build_model

    cfg = get_config("mamba2-1.3b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 5: mamba2-1.3b, {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{n_params / 1e9:.3f} B parameters initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab, (SSM_B, SSM_L)).astype(np.int32)).to(dev)
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)

    def prefill(tokens):
        SK.reset_launches()
        t0 = time.perf_counter()
        tok, cache = prefill_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if SK.LAUNCHES["ssd"] != cfg.n_layers:
            raise AssertionError(f"prefill launched the SSD kernel {SK.LAUNCHES['ssd']} "
                                 f"times, expected {cfg.n_layers}")
        return tok, cache, secs

    prefill(prompts)  # first call: cuBLAS handles, allocator warm-up
    tok, cache, pre_s = prefill(prompts)
    prefill_launches = SK.LAUNCHES["ssd"]
    tokens = [tok]
    SK.reset_launches()
    t0 = time.perf_counter()
    for _ in range(SSM_STEPS):
        tok, cache = serve_step(params, tok, cache)
        tokens.append(tok)
    torch.cuda.synchronize()
    dec_s = (time.perf_counter() - t0) / SSM_STEPS
    decode_launches = SK.LAUNCHES["ssd"]
    if decode_launches != 0:
        raise AssertionError(f"decode steps launched the SSD kernel {decode_launches} times")
    out = torch.stack(tokens, dim=1)
    if out.dtype != torch.int32 or not bool(((out >= 0) & (out < cfg.vocab_padded)).all()):
        raise AssertionError(f"greedy tokens out of range: {out}")
    if int(cache["len"]) != SSM_L + SSM_STEPS:
        raise AssertionError(f"cache len {int(cache['len'])} after {SSM_STEPS} steps")
    log(f"phase 5: prefill {SSM_B}x{SSM_L} in {pre_s * 1e3:.2f} ms = "
        f"{SSM_B * SSM_L / pre_s:.1f} tok/s ({prefill_launches} SSD launches); decode "
        f"{dec_s * 1e3:.3f} ms/step = {SSM_B / dec_s:.1f} tok/s over {SSM_STEPS} steps "
        f"({decode_launches} SSD launches); first greedy tokens {out[:, :6].tolist()}")

    prefill_rows = device_rows(lambda: prefill_step(params, {"tokens": prompts}),
                               "a Mamba2 prefill", repeatable=True)
    rows = [(e.self_device_time_total, e.key) for e in prefill_rows]
    busy_ms = sum(t for t, _ in rows) / 1e3
    ssd_ms = sum(t for t, k in rows if any(n in k for n in SSD_KERNELS)) / 1e3
    if busy_ms <= 0 or ssd_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the prefill")
    top = sorted(rows, reverse=True)[:5]
    log(f"phase 5 profile: one prefill {busy_ms:.3f} ms of device kernel time, SSD "
        f"kernels {ssd_ms:.3f} ms ({ssd_ms / busy_ms:.3f} of it; "
        f"{ssd_ms / prefill_launches:.4f} ms a call), host wall "
        f"{pre_s * 1e3:.2f} ms (unprofiled; busy share {busy_ms / 1e3 / pre_s:.3f}); top "
        f"kernels ms: " + "; ".join(f"{k[:40]} {t / 1e3:.3f}" for t, k in top))
    state = [tok, cache]

    def steps():
        for _ in range(4):
            state[0], state[1] = serve_step(params, state[0], state[1])

    dec_busy = sum(e.self_device_time_total
                   for e in device_rows(steps, "Mamba2 decode steps")) / 4 / 1e3
    tok, cache = state
    log(f"phase 5 profile: one decode step {dec_busy:.3f} ms of device kernel time "
        f"against {dec_s * 1e3:.3f} ms host wall (busy share {dec_busy / 1e3 / dec_s:.3f})")

    # the same prompts through the kernel and through the plain SSD; the
    # plain SSD at Q=128 against Q=256 is the stack's own rounding floor
    logits_k, _ = model.prefill(params, {"tokens": prompts})
    with plain_ssd():
        logits_p, _ = model.prefill(params, {"tokens": prompts})
    with plain_ssd(128):
        logits_q, _ = model.prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    scale = float(logits_p.abs().max())
    tol = SSM_LOGITS_RTOL_OF_MAX * scale
    d_kp = float((logits_k - logits_p).abs().max())
    d_floor = float((logits_q - logits_p).abs().max())
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    log(f"phase 5 kernel vs plain SSD: max|logit| {scale:.4f}, max|kernel-plain| "
        f"{d_kp:.5f} (floor: plain Q=128 vs Q=256 {d_floor:.5f}), tolerance {tol:.5f}; "
        f"argmax agree {agree:.3f}")
    if not (math.isfinite(scale) and d_kp <= tol):
        raise AssertionError("prefill logits through the SSD kernel disagree with plain")

    # the reference's consistency check: decode(prefill(p[:, :-1]), p[:, -1])
    # against prefill(p); the kernel's h_final is what decode continues from
    _, short = model.prefill(params, {"tokens": prompts[:, :-1]})
    logits_d, _ = model.decode(params, prompts[:, -1], short)
    torch.cuda.synchronize()
    d_pd = float((logits_d - logits_k).abs().max())
    agree = float((logits_d.argmax(-1) == logits_k.argmax(-1)).float().mean())
    log(f"phase 5 prefill/decode consistency: max|decode-prefill| {d_pd:.5f}, "
        f"tolerance {tol:.5f}; argmax agree {agree:.3f}")
    if not d_pd <= tol:
        raise AssertionError("decode from the prefill cache disagrees with prefill")
    mamba_layer_checks(torch, cfg, params, prompts)
    return {"prefill_launches": prefill_launches, "decode_launches": decode_launches,
            "prefill_ms": pre_s * 1e3, "decode_ms": dec_s * 1e3,
            "prefill_device_ms": busy_ms, "ssd_device_ms": ssd_ms,
            "decode_device_ms": dec_busy}


def bf16_step(t) -> float:
    """One bf16 step at the largest magnitude of ``t`` (8 significant bits)."""
    return 2.0 ** (math.floor(math.log2(float(t.float().abs().max()))) - 7)


def row_bf16_steps(got, want) -> float:
    """The largest difference of ``got`` from ``want`` in bf16 steps at the
    largest magnitude of its own row of ``want`` (the last axis)."""
    import torch

    w = want.float()
    rmax = w.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    step = torch.exp2(torch.floor(torch.log2(rmax)) - 7)
    return float(((got.float() - w).abs() / step).max())


def mamba_layer_checks(torch, cfg, params, prompts) -> None:
    """Layer by layer, each layer fed the kernel prefill's hidden state:
    the layer through the kernel against the plain SSD (outputs and
    h_final), and one recurrent decode step from the layer's prefill cache
    of the first L-1 tokens against the prefill's last token."""
    from repro_torch.models.layers import embed_apply, layer_slice

    x = embed_apply(params["embed"], prompts.long())
    worst = new_worst()
    for i in range(cfg.n_layers):
        x = mamba_layer_check(torch, cfg, layer_slice(params["layers"], i), x, worst)
    torch.cuda.synchronize()
    report_layers("phase 5", f"{cfg.n_layers} layers", worst)


def new_worst() -> dict:
    return {"kernel_steps": 0.0, "kernel_share": 0.0, "state_rel": 0.0,
            "decode_steps": 0.0, "decode_share": 0.0}


def _worse(worst, key_steps, key_share, got, want) -> None:
    d = (got.float() - want.float()).abs()
    worst[key_steps] = max(worst[key_steps], float(d.max()) / bf16_step(want))
    worst[key_share] = max(worst[key_share], float((d > 0).float().mean()))


def mamba_layer_check(torch, cfg, lp, x, worst):
    """One Mamba2 layer fed ``x``: through the SSD kernel against the plain
    SSD (output and h_final), and one recurrent decode step from the
    layer's prefill cache of the first L-1 tokens against the prefill's
    last token.  Returns the kernel run's output."""
    from repro_torch.models.hybrid import _mamba_layer_seq, _mamba_layer_step

    out_k, cache_k = _mamba_layer_seq(lp, x, cfg)
    with plain_ssd():
        out_p, cache_p = _mamba_layer_seq(lp, x, cfg)
    _, short = _mamba_layer_seq(lp, x[:, :-1], cfg)
    out_d, _ = _mamba_layer_step(lp, x[:, -1], short, cfg)
    d_s = (cache_k["state"] - cache_p["state"]).abs().max() / cache_p["state"].abs().max()
    _worse(worst, "kernel_steps", "kernel_share", out_k, out_p)
    _worse(worst, "decode_steps", "decode_share", out_d, out_k[:, -1])
    worst["state_rel"] = max(worst["state_rel"], float(d_s))
    return out_k


def report_layers(phase: str, what: str, worst: dict) -> None:
    log(f"{phase} layer by layer over {what} (worst layer; bf16 steps at "
        f"the output's largest magnitude): kernel vs plain {worst['kernel_steps']:.2f} "
        f"steps, share differing {worst['kernel_share']:.4f}, h_final rel "
        f"{worst['state_rel']:.3g}; decode step vs prefill {worst['decode_steps']:.2f} "
        f"steps, share differing {worst['decode_share']:.4f}")
    if not (worst["kernel_steps"] <= LAYER_KERNEL_STEPS
            and worst["kernel_share"] <= LAYER_KERNEL_SHARE
            and worst["state_rel"] <= SSD_REL_TOL):
        raise AssertionError(f"a layer through the SSD kernel disagrees with plain: {worst}")
    if not worst["decode_steps"] <= LAYER_DECODE_STEPS:
        raise AssertionError(f"a decode step disagrees with the prefill: {worst}")


def run_zamba(torch, dev) -> dict:
    """Full-width Zamba2-7B through the step functions: prefill 2 seeded
    prompts of 4096 tokens, then 32 greedy decode steps from the padded
    cache, with the flash and SSD launch counts reset just before and read
    just after each; a profiler window over one prefill; the kernels
    against their plain versions end to end (after the plain versions'
    floor) and slot by slot, and decode against prefill."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import build_model
    from repro_torch.models.model import prepare_decode_cache

    cfg = get_config("zamba2-7b")
    n_attn = cfg.n_attn_slots
    n_mamba = cfg.n_layers - n_attn
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    log(f"phase 5b: zamba2-7b, {cfg.n_layers} slots ({n_attn} shared-block calls, "
        f"{n_mamba} Mamba2 layers), d {cfg.d_model}, {n_params / 1e9:.3f} B parameters "
        f"initialised on the card in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab, (ZAMBA_B, ZAMBA_L)).astype(np.int32)).to(dev)
    prefill_step, serve_step = make_prefill_step(model), make_serve_step(model)

    def prefill(tokens):
        FK.reset_launches()
        SK.reset_launches()
        t0 = time.perf_counter()
        tok, cache = prefill_step(params, {"tokens": tokens})
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = (FK.LAUNCHES["flash_attention"], SK.LAUNCHES["ssd"])
        if got != (n_attn, n_mamba):
            raise AssertionError(f"prefill launched flash/ssd {got}, expected "
                                 f"{(n_attn, n_mamba)}")
        return tok, cache, secs, got

    prefill(prompts)  # first call: cuBLAS handles, allocator warm-up
    tok, cache, pre_s, prefill_launches = prefill(prompts)
    cache = prepare_decode_cache(cfg, cache, ZAMBA_L + ZAMBA_STEPS + 4)
    tokens = [tok]
    FK.reset_launches()
    SK.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ZAMBA_STEPS):
        tok, cache = serve_step(params, tok, cache)
        tokens.append(tok)
    torch.cuda.synchronize()
    dec_s = (time.perf_counter() - t0) / ZAMBA_STEPS
    decode_launches = (FK.LAUNCHES["flash_attention"], SK.LAUNCHES["ssd"])
    if decode_launches != (0, 0):
        raise AssertionError(f"decode steps launched flash/ssd {decode_launches}")
    out = torch.stack(tokens, dim=1)
    if out.dtype != torch.int32 or not bool(((out >= 0) & (out < cfg.vocab_padded)).all()):
        raise AssertionError(f"greedy tokens out of range: {out}")
    if int(cache["len"]) != ZAMBA_L + ZAMBA_STEPS:
        raise AssertionError(f"cache len {int(cache['len'])} after {ZAMBA_STEPS} steps")
    log(f"phase 5b: prefill {ZAMBA_B}x{ZAMBA_L} in {pre_s * 1e3:.2f} ms = "
        f"{ZAMBA_B * ZAMBA_L / pre_s:.1f} tok/s (flash/ssd launches {prefill_launches}); "
        f"decode {dec_s * 1e3:.3f} ms/step = {ZAMBA_B / dec_s:.1f} tok/s over "
        f"{ZAMBA_STEPS} steps (flash/ssd launches {decode_launches}); first greedy "
        f"tokens {out[:, :6].tolist()}")

    prefill_rows = device_rows(lambda: prefill_step(params, {"tokens": prompts}),
                               "a Zamba2 prefill",
                               {"flash_attention_kernel": n_attn,
                                **{name: n_mamba for name in SSD_KERNELS}}, repeatable=True)
    rows = [(e.self_device_time_total, e.key) for e in prefill_rows]
    busy_ms = sum(t for t, _ in rows) / 1e3
    # a flash call launches its attention kernel and, when its keys are
    # split, the merge kernel: both are named flash_attention_*
    flash_ms = sum(t for t, k in rows if "flash_attention_" in k) / 1e3
    ssd_ms = sum(t for t, k in rows if any(n in k for n in SSD_KERNELS)) / 1e3
    n_rec = {name: sum(e.count for e in prefill_rows if name in e.key)
             for name in ("flash_attention_kernel",) + SSD_KERNELS}
    if busy_ms <= 0 or flash_ms <= 0 or ssd_ms <= 0:
        raise AssertionError("the profiler recorded no device time for the prefill kernels")
    top = sorted(rows, reverse=True)[:6]
    log(f"phase 5b profile: one prefill {busy_ms:.3f} ms of device kernel time, flash "
        f"{flash_ms:.3f} ms ({flash_ms / busy_ms:.3f}), SSD {ssd_ms:.3f} ms "
        f"({ssd_ms / busy_ms:.3f}; {ssd_ms / n_mamba:.4f} ms a call), host wall "
        f"{pre_s * 1e3:.2f} ms (unprofiled; busy "
        f"share {busy_ms / 1e3 / pre_s:.3f}); launches recorded {n_rec}; top kernels ms: "
        + "; ".join(f"{k[:40]} {t / 1e3:.3f}" for t, k in top))
    state = [tok, cache]

    def steps():
        for _ in range(4):
            state[0], state[1] = serve_step(params, state[0], state[1])

    dec_busy = sum(e.self_device_time_total
                   for e in device_rows(steps, "Zamba2 decode steps")) / 4 / 1e3
    tok, cache = state
    log(f"phase 5b profile: one decode step {dec_busy:.3f} ms of device kernel time "
        f"against {dec_s * 1e3:.3f} ms host wall (busy share {dec_busy / 1e3 / dec_s:.3f})")
    del cache

    # the floor first: both plain versions against themselves in another
    # sum order (SSD chunk 128, flash chunk 256); then both kernels
    # against both plain versions
    with plain_ssd(), plain_flash():
        logits_p, _ = model.prefill(params, {"tokens": prompts})
    with plain_ssd(128), plain_flash(256):
        logits_q, _ = model.prefill(params, {"tokens": prompts})
    logits_k, _ = model.prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    scale = float(logits_p.abs().max())
    tol = HYBRID_LOGITS_RTOL_OF_MAX * scale
    d_floor = float((logits_q - logits_p).abs().max())
    log(f"phase 5b floor: plain (SSD Q=128, flash chunk 256) vs plain (Q=256, chunk "
        f"512): max|diff| {d_floor:.5f} at max|logit| {scale:.4f}")
    d_kp = float((logits_k - logits_p).abs().max())
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    log(f"phase 5b kernels vs plain: max|kernels-plain| {d_kp:.5f}, tolerance {tol:.5f}; "
        f"argmax agree {agree:.3f}")
    if not (math.isfinite(scale) and d_kp <= tol):
        raise AssertionError("prefill logits through the kernels disagree with plain")

    # decode(prefill(p[:, :-1]), p[:, -1]) against prefill(p)
    _, short = model.prefill(params, {"tokens": prompts[:, :-1]})
    short = prepare_decode_cache(cfg, short, ZAMBA_L)
    logits_d, _ = model.decode(params, prompts[:, -1], short)
    torch.cuda.synchronize()
    del short
    d_pd = float((logits_d - logits_k).abs().max())
    agree = float((logits_d.argmax(-1) == logits_k.argmax(-1)).float().mean())
    log(f"phase 5b prefill/decode consistency: max|decode-prefill| {d_pd:.5f}, "
        f"tolerance {tol:.5f}; argmax agree {agree:.3f}")
    if not d_pd <= tol:
        raise AssertionError("decode from the prefill cache disagrees with prefill")
    zamba_layer_checks(torch, cfg, params, prompts)
    del params
    return {"prefill_flash_launches": prefill_launches[0],
            "prefill_ssd_launches": prefill_launches[1],
            "decode_launches": decode_launches, "prefill_ms": pre_s * 1e3,
            "decode_ms": dec_s * 1e3, "prefill_device_ms": busy_ms,
            "flash_device_ms": flash_ms, "ssd_device_ms": ssd_ms,
            "decode_device_ms": dec_busy}


def zamba_layer_checks(torch, cfg, params, prompts) -> None:
    """Slot by slot, each fed the kernel prefill's hidden state: every
    Mamba2 layer as in phase 5, and the shared block through the flash
    kernel against the plain flash (its attention sub-layer within
    FLASH_BF16_STEPS at each token's scale, its output within
    SHARED_BLOCK_STEPS) and one decode step through its padded
    KV cache against the prefill's last token."""
    from repro_torch.models.attention import attn_apply
    from repro_torch.models.hybrid import hybrid_counts
    from repro_torch.models.layers import embed_apply, layer_slice, rmsnorm
    from repro_torch.models.transformer import block_apply

    n_attn, seg_m, tail = hybrid_counts(cfg)
    x = embed_apply(params["embed"], prompts.long())
    b, l = prompts.shape
    pos = torch.arange(l, dtype=torch.int32, device=x.device)[None].expand(b, l)
    mamba, shared, attn = new_worst(), new_worst(), new_worst()
    sp = params["shared"]
    for i in range(n_attn):
        seg_lp = layer_slice(params["seg_layers"], i)
        for j in range(seg_m):
            x = mamba_layer_check(torch, cfg, layer_slice(seg_lp, j), x, mamba)
        h = rmsnorm(x, sp["ln1"], cfg.norm_eps)
        a_k, _ = attn_apply(sp["attn"], h, cfg, pos=pos)
        out_k, _ = block_apply(sp, x, cfg, pos=pos)
        with plain_flash():
            a_p, _ = attn_apply(sp["attn"], h, cfg, pos=pos)
            out_p, _ = block_apply(sp, x, cfg, pos=pos)
        attn["kernel_steps"] = max(attn["kernel_steps"], row_bf16_steps(a_k, a_p))
        attn["kernel_share"] = max(attn["kernel_share"],
                                   float(((a_k - a_p) != 0).float().mean()))
        _, (k, v) = block_apply(sp, x[:, :-1], cfg, pos=pos[:, :-1])
        pad = (0, 0, 0, 0, 0, 1)
        kv = (torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad))
        out_d, _ = block_apply(sp, x[:, -1:], cfg, pos=pos[:, -1:], cache=kv, cache_len=l - 1)
        _worse(shared, "kernel_steps", "kernel_share", out_k, out_p)
        _worse(shared, "decode_steps", "decode_share", out_d[:, 0], out_k[:, -1])
        x = out_k
    for j in range(tail):
        x = mamba_layer_check(torch, cfg, layer_slice(params["tail_layers"], j), x, mamba)
    torch.cuda.synchronize()
    report_layers("phase 5b", f"{n_attn * seg_m + tail} Mamba2 layers", mamba)
    log(f"phase 5b layer by layer over {n_attn} shared-block calls (worst call): flash "
        f"kernel vs plain, attention sub-layer {attn['kernel_steps']:.2f} bf16 steps at "
        f"each token's largest magnitude (tolerance {FLASH_BF16_STEPS}; share differing "
        f"{attn['kernel_share']:.4f}), block {shared['kernel_steps']:.2f} steps at the "
        f"output's largest magnitude (tolerance {SHARED_BLOCK_STEPS}; share "
        f"{shared['kernel_share']:.4f}); decode step vs prefill {shared['decode_steps']:.2f} "
        f"steps (tolerance {LAYER_DECODE_STEPS}), share differing "
        f"{shared['decode_share']:.4f}")
    if not (attn["kernel_steps"] <= FLASH_BF16_STEPS
            and shared["kernel_steps"] <= SHARED_BLOCK_STEPS):
        raise AssertionError(f"the shared block through the flash kernel disagrees: {shared}")
    if not shared["decode_steps"] <= LAYER_DECODE_STEPS:
        raise AssertionError(f"a shared-block decode step disagrees with prefill: {shared}")


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def kernel_bytes(cache_keeps, mask, hkv, hd8, page_keep_filter=None) -> int:
    """Plane bytes one launch must read: sum over pages with a valid token
    and keep > 0 of keep * 16 * Hkv * hd/8, for K and V."""
    b, s = mask.shape
    valid_page = (mask.view(b, s // 16, 16) > 0).any(dim=-1)
    keep = cache_keeps.to(valid_page.device)
    sel = valid_page & (keep > 0)
    if page_keep_filter is not None:
        sel &= keep == page_keep_filter
    return int((keep * sel).sum()) * 16 * hkv * hd8 * 2


def time_kernels(torch, cache, keeps, errs, launches) -> list:
    """Time both kernels on the serving snapshot's own planes, plane map and
    lengths, walking the 30 layers so each launch reads planes that are not
    in L2 (the real caller's case); then at the long, cold shape
    (``time_long_paged``), whose rows go under each kernel's ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R

    dev = cache["planes"].device
    n_layers = cache["k_planes"].shape[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((B, HKV, REP, HD), generator=gen, device=dev).to(torch.bfloat16)
    lens = cache["len"] + 1
    ok = torch.arange(S, device=dev)[None] < lens[:, None]
    page_keeps = cache["planes"].contiguous()
    tok_keep = page_keeps.repeat_interleave(16, dim=1)
    mask = (ok & (tok_keep > 0)).to(torch.int8).contiguous()
    kps = [cache["k_planes"][i] for i in range(n_layers)]
    vps = [cache["v_planes"][i] for i in range(n_layers)]
    hd8 = HD // 8
    small = q.numel() * 2 + mask.numel()
    out_b = B * HKV * REP * HD * 4
    valid_tok = int(mask.sum()) * HKV
    flops = valid_tok * REP * HD * 4  # q.k and p.v, 2 flops per multiply-add

    def bound(nbytes, nflops):
        t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, nflops / F32_FLOPS * 1e3
        return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")

    # library yardstick: SDPA over the same KV unpacked to dense bf16
    kd = R.unpack_kv_keeps_ref(kps[0], tok_keep, BITS).repeat_interleave(REP, dim=2)
    vd = R.unpack_kv_keeps_ref(vps[0], tok_keep, BITS).repeat_interleave(REP, dim=2)
    qd = q.reshape(B, HKV * REP, 1, HD)
    kd, vd = kd.transpose(1, 2).contiguous(), vd.transpose(1, 2).contiguous()
    amask = (mask > 0)[:, None, None, :]
    sdpa = lambda i: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=amask)  # noqa: E731
    lib_ms, lib_dev = cuda_time_ms(sdpa), device_ms(sdpa, "", 30)

    # fused: one call per layer; a call launches the attention kernel and,
    # when S is split, the kernel that merges the splits (both named
    # paged_attention_*)
    per_call = 2 if K.plan(B, S, HKV, REP, HD)["splits"] > 1 else 1
    fused = lambda i: K.paged_attention_fused(  # noqa: E731
        q, kps[i % n_layers], vps[i % n_layers], page_keeps, mask)
    f_ms, f_dev = cuda_time_ms(fused, iters=60), device_ms(fused, "paged_attention_", 60,
                                                           per_call)
    f_plain = cuda_time_ms(lambda i: R.paged_attention_fused_ref(
        q, kps[i % n_layers], vps[i % n_layers], page_keeps, mask), iters=10)
    f_bytes = kernel_bytes(page_keeps, mask, HKV, hd8) + small + page_keeps.numel() * 4 + out_b
    f_bound, f_by = bound(f_bytes, flops)

    # rung: one launch per member of the rung set per layer; per-launch means
    masks = {k: (mask * (tok_keep == k)).to(torch.int8).contiguous() for k in keeps}
    rung = lambda i: [K.paged_attention_rung(  # noqa: E731
        q, kps[i % n_layers], vps[i % n_layers], masks[k], keep=k) for k in keeps]
    r_ms = cuda_time_ms(rung, iters=30) / len(keeps)
    r_dev = device_ms(rung, "paged_attention_", 30, per_call * len(keeps)) / len(keeps)
    r_plain = cuda_time_ms(lambda i: [R.paged_attention_rung_ref(
        q, kps[i % n_layers], vps[i % n_layers], masks[k], k) for k in keeps],
        iters=10) / len(keeps)
    r_bytes = sum(kernel_bytes(page_keeps, masks[k], HKV, hd8, k) for k in keeps) \
        / len(keeps) + small + out_b + 2 * B * HKV * REP * 4
    r_bound, r_by = bound(r_bytes, flops / len(keeps))
    steps = {k: launches[k]["paged_attention_" + k] / launches["steps"][k]
             for k in ("fused", "rung")}
    log(f"phase 6 (ms per launch, CUDA events / profiler device time): fused {f_ms:.4f} / "
        f"{f_dev:.4f}, {steps['fused']:.0f} launches per decode step (bound {f_bound:.5f} "
        f"ms, {f_bytes} B), rung {r_ms:.4f} / {r_dev:.4f}, {steps['rung']:.0f} launches "
        f"per decode step (bound {r_bound:.5f} ms), plain fused {f_plain:.4f} ms, plain "
        f"rung {r_plain:.4f} ms, sdpa {lib_ms:.4f} / {lib_dev:.4f}; device factor against "
        f"sdpa: fused {f_dev / lib_dev:.2f}, rung {r_dev / lib_dev:.2f}; "
        f"valid tokens {int(mask.sum())}, plane map keeps {sorted(set(page_keeps.flatten().tolist()))}")
    long_rows = time_long_paged(torch, dev)
    src = "src/repro_torch/csrc/paged_attention.cu"
    return [
        {"name": "paged_attention_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_attention/kernel.py:274",
         "launches": launches["fused"]["paged_attention_fused"],
         "max_abs_err": errs["paged_attention_fused"], "ms": f_ms, "device_ms": f_dev,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": lib_ms, "library_device_ms": lib_dev,
         "library": "scaled_dot_product_attention over the unpacked KV",
         "shapes": [r for r in long_rows if r["kernel"] == "fused"]},
        {"name": "paged_attention_rung", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_attention/kernel.py:115",
         "launches": launches["rung"]["paged_attention_rung"],
         "max_abs_err": errs["paged_attention_rung"], "ms": r_ms, "device_ms": r_dev,
         "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": lib_ms, "library_device_ms": lib_dev,
         "library": "scaled_dot_product_attention over the unpacked KV",
         "shapes": [r for r in long_rows if r["kernel"] == "rung"]},
    ]


# Phase 6's long, cold decode shape: B 8, S 4096, every token valid, Yi-9B's
# head shape; LONG_LAYERS layers of planes (and of dense bf16 K/V for SDPA)
# rotated, 268 MB of each, so every call finds its planes outside the 50 MB
# L2, as a decode step through a deep model would
LONG_SHAPE = (8, 4096) + YI_HEADS
LONG_LAYERS = 4


def time_long_paged(torch, dev) -> list:
    """Both kernels at LONG_SHAPE with every page at keep 16, 8 and 4, cold:
    device time (profiler; the attention and merge kernels) and CUDA-event
    time per call, the bytes a call must move (the kept planes, q, mask,
    plane map, output), the byte bound and the share of it, beside
    ``scaled_dot_product_attention(q, k, v, enable_gqa=True)`` over the same
    layers' dense bf16 K/V (twice the bytes of keep 8).  Each keep is first
    held to the plain version on one layer (KERNEL_ATOL / RTOL)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ref import pack_kv_ref

    b, s, hkv, rep, hd = LONG_SHAPE
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((b, hkv, rep, hd), generator=gen, device=dev).to(torch.bfloat16)
    dense, planes = [], []
    for _ in range(LONG_LAYERS):
        k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
        planes.append((pack_kv_ref(k), pack_kv_ref(v)))
        dense.append((k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()))
        del k, v
    mask = torch.ones((b, s), dtype=torch.int8, device=dev)
    qd = q.reshape(b, hkv * rep, 1, hd)
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qd, dense[i % LONG_LAYERS][0], dense[i % LONG_LAYERS][1], enable_gqa=True)
    lib_ms, lib_dev = cuda_time_ms(sdpa, iters=40), device_ms(sdpa, "", 40)
    plan = K.plan(b, s, hkv, rep, hd)
    per_call = 2 if plan["splits"] > 1 else 1
    rows = []
    for keep in (16, 8, 4):
        page_keeps = torch.full((b, s // 16), keep, dtype=torch.int32, device=dev)
        calls = {
            "fused": lambda i: K.paged_attention_fused(
                q, *planes[i % LONG_LAYERS], page_keeps, mask),
            "rung": lambda i: K.paged_attention_rung(
                q, *planes[i % LONG_LAYERS], mask, keep=keep)}
        fused_err = float((calls["fused"](0) - R.paged_attention_fused_ref(
            q, *planes[0], page_keeps, mask)).abs().max())
        torch.testing.assert_close(calls["fused"](0), R.paged_attention_fused_ref(
            q, *planes[0], page_keeps, mask), atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        check_rung_partials(torch, calls["rung"](0),
                            R.paged_attention_rung_ref(q, *planes[0], mask, keep))
        small = q.numel() * 2 + mask.numel() + b * hkv * rep * hd * 4
        for kernel, fn in calls.items():
            nbytes = kernel_bytes(page_keeps, mask, hkv, hd // 8) + small + (
                page_keeps.numel() * 4 if kernel == "fused" else 2 * b * hkv * rep * 4)
            k_ms = cuda_time_ms(fn, iters=40)
            k_dev = device_ms(fn, "paged_attention_", 40, per_call)
            b_ms = nbytes / HBM_BYTES_PER_S * 1e3
            rows.append({"kernel": kernel, "shape": list(LONG_SHAPE), "keep": keep,
                         "layers": LONG_LAYERS, "plan": plan, "ms": k_ms, "device_ms": k_dev,
                         "bytes": nbytes, "bound_ms": b_ms, "bound_by": "bytes",
                         "bound_share": b_ms / k_dev, "sdpa_ms": lib_ms,
                         "sdpa_device_ms": lib_dev, "over_sdpa": k_dev / lib_dev,
                         "max_abs_err": fused_err if kernel == "fused" else None})
            log(f"phase 6: paged_attention_{kernel} B S Hkv rep hd = {LONG_SHAPE}, every "
                f"page at keep {keep}, cold ({LONG_LAYERS} layers): {k_ms:.4f} / "
                f"{k_dev:.4f} ms (events / device, {per_call} kernels a call; plan {plan}); "
                f"{nbytes} B, byte bound {b_ms:.5f} ms, {b_ms / k_dev:.3f} of it; sdpa "
                f"enable_gqa over dense bf16 {lib_ms:.4f} / {lib_dev:.4f} "
                f"(kernel / sdpa by device {k_dev / lib_dev:.3f})")
    del dense, planes
    torch.cuda.empty_cache()
    return rows


def bound_ms(nbytes: float, nflops: float, flops_per_s: float) -> tuple:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for their type, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, nflops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def bitplane_bytes(values: int, width: int, planes: int) -> int:
    """Bytes a pack or unpack must move: ``values`` of ``width`` bytes read
    or written once, and ``planes`` planes of one bit each of them."""
    return values * width + planes * values // 8


def bitplane_row(torch, what: str, run, plain, match: str, nbytes: int, iters: int = 200,
                 plain_iters: int = 20, parent=None) -> dict:
    """One shape of a pack, unpack or exponent-delta kernel: CUDA events
    around back-to-back calls and the profiler's device time of the kernel
    (``match``), beside the byte bound (they move bits with a few integer
    operations a value and no floating point: bytes bound them), the plain version
    and, with ``parent``, the parent's route for the same work (every
    kernel of it, device time)."""
    ms, dev_ms = cuda_time_ms(run, iters=iters), device_ms(run, match, iters)
    p_ms = cuda_time_ms(plain, iters=plain_iters, warmup=1)
    p_dev = device_ms(plain, "", plain_iters)
    b_ms, b_by = bound_ms(nbytes, 0, BF16_TENSOR_FLOPS)
    row = {"shape": what, "ms": ms, "device_ms": dev_ms, "plain_ms": p_ms,
           "plain_device_ms": p_dev, "bound_ms": b_ms, "bound_by": b_by,
           "bound_bytes": nbytes, "bound_share": b_ms / dev_ms}
    if parent is not None:
        row["parent_route_ms"] = cuda_time_ms(parent, iters=iters)
        row["parent_route_device_ms"] = device_ms(parent, "", iters)
        row["parent_route_kernels"] = kernels_per_call(parent, "")
    return row


def parent_append(torch, k, v, kp, vp, lens) -> None:
    """The parent's decode append (the attention layer's before the KV
    entry points): a row index and a clamp, a flat pack of each stream into
    a fresh plane tensor, and an indexed write of each into the cache."""
    from repro_torch.kernels.paged_attention.ops import pack_kv_planes

    rows = torch.arange(kp.shape[1], device=kp.device)
    slot = torch.clamp(lens, 0, kp.shape[2] - 1).long()
    kp[:, rows, slot] = pack_kv_planes(k, kp.shape[0])[:, :, 0]
    vp[:, rows, slot] = pack_kv_planes(v, kp.shape[0])[:, :, 0]


def parent_chunk_append(k, v, kp, vp, start: int) -> None:
    """The parent's prefill-chunk append: a flat pack of each stream, then a
    copy into the slice of the cache."""
    from repro_torch.kernels.paged_attention.ops import pack_kv_planes

    end = start + k.shape[1]
    kp[:, :, start:end] = pack_kv_planes(k, kp.shape[0])
    vp[:, :, start:end] = pack_kv_planes(v, kp.shape[0])


def parent_unpack_pair(kp, vp, keep: int) -> tuple:
    """The parent's unpack of a slot's K and V: a flat unpack of each (the
    slot view is no contiguous plane block, so each is copied first)."""
    from repro_torch.kernels.paged_attention.ops import unpack_kv

    return unpack_kv(kp, keep, BITS), unpack_kv(vp, keep, BITS)


COLD_VALUES = 1 << 24
SPAN_VALUES = 256 * 16 * HKV * HD


def time_bitplane_kernels(torch, dev, errs, serve_launches, per_step, prefill, decode,
                          rt, qs_launches) -> list:
    """The pack and unpack kernels at the shapes the main path gives them,
    each beside its byte bound and plain version: the decode append (K and
    V of B 8 into one layer's 1,024-row cache, clamped positions) and a
    256-row prefill chunk's append, both beside the parent's route; the
    unpack of one slot's K and V (what a prefill chunk reads: keep 16, over
    10 layers x 8 slots of a stacked cache, 63 MB, so they come from HBM)
    beside the parent's route; the memory tier's flat pack of a 256-page span
    and ``get_sequence``'s flat unpack of phase 3c's longest sequence; and a
    cold shape where bytes bind, m = 2^24 int16 values, buffers rotated
    beyond L2: pack, unpack at keep 16 and 8.  An empty kernel's device
    time is printed as the launch floor.  Then the matmul (``time_matmul``)
    at the quickstart's shape at keep 8 (warm) and at the Zamba2-7B MLP
    up-projection, cold: M 8 at keep 16, 12, 8 and 4, M 128 at keep 8.
    Each is timed twice: CUDA events around back-to-back calls (``ms``; at
    these sizes the host's issue time per call can exceed the kernel's)
    and the profiler's device time of the kernels alone (``device_ms``)."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane import ref as BR

    gen = torch.Generator(device=dev).manual_seed(4)
    pack_k, unpack_k = "bitplane_pack_kernel", "bitplane_unpack_kernel"
    floor_ms = cuda_time_ms(lambda i: BK.launch_empty(), iters=200)
    floor_dev = device_ms(lambda i: BK.launch_empty(), "bitplane_empty_kernel", 200)
    r = HKV * HD

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def rand_planes(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.uint8)

    # decode append: 8 K and V inputs, one layer's planes
    kv = [(randn(B, 1, HKV, HD), randn(B, 1, HKV, HD)) for _ in range(8)]
    kp, vp = rand_planes(BITS, B, S, HKV, HD // 8), rand_planes(BITS, B, S, HKV, HD // 8)
    lens = torch.tensor(APPEND_POS, device=dev, dtype=torch.int32)
    append = bitplane_row(
        torch, f"decode append, K+V of B {B} into {S} rows",
        lambda i: BK.pack_kv_into(*kv[i % 8], kp, vp, lens),
        lambda i: BR.pack_kv_into_ref(*kv[i % 8], kp, vp, lens), pack_k,
        bitplane_bytes(2 * B * r, 2, BITS) + 4 * B,
        parent=lambda i: parent_append(torch, *kv[i % 8], kp, vp, lens))
    kernels = kernels_per_call(lambda i: BK.pack_kv_into(*kv[0], kp, vp, lens), "")
    if kernels != 1:
        raise AssertionError(f"the decode append launched {kernels} kernels, not one")
    append["kernels"] = kernels
    # prefill chunk append into slot 3 of one layer
    chunk_kv = [(randn(1, CHUNK, HKV, HD), randn(1, CHUNK, HKV, HD)) for _ in range(4)]
    slot = kp.narrow(1, 3, 1), vp.narrow(1, 3, 1)
    chunk = bitplane_row(
        torch, f"prefill chunk append, K+V of {CHUNK} rows at {S // 2 - 64}",
        lambda i: BK.pack_kv_into(*chunk_kv[i % 4], *slot, S // 2 - 64),
        lambda i: BR.pack_kv_into_ref(*chunk_kv[i % 4], *slot, S // 2 - 64), pack_k,
        bitplane_bytes(2 * CHUNK * r, 2, BITS),
        parent=lambda i: parent_chunk_append(*chunk_kv[i % 4], *slot, S // 2 - 64))
    del kp, vp, slot
    # one slot's K and V, all 16 planes (a prefill chunk's read), over 10
    # layers x 8 slots
    stacked = [rand_planes(10, BITS, B, S, HKV, HD // 8) for _ in range(2)]

    def slot_views(i):
        return [c.narrow(2, (i // 10) % B, 1)[i % 10] for c in stacked]

    slot_unpack = bitplane_row(
        torch, f"slot unpack, K+V of {S} rows, keep 16",
        lambda i: BK.unpack_kv_pair(*slot_views(i), BITS),
        lambda i: BR.unpack_kv_pair_ref(*slot_views(i), BITS), unpack_k,
        2 * bitplane_bytes(S * r, 2, BITS), iters=320,
        parent=lambda i: parent_unpack_pair(*slot_views(i), BITS))
    del stacked
    # the memory tier: a span's flat pack (in L2, as its caller has just
    # made the values) and get_sequence's flat unpack (just copied in)
    span = torch.randint(0, 2**16, (SPAN_VALUES,), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.int16)
    span_pack = bitplane_row(
        torch, f"memory tier span pack, m {SPAN_VALUES}", lambda i: BK.pack(span, BITS),
        lambda i: BR.pack_ref(span, BITS), pack_k, bitplane_bytes(SPAN_VALUES, 2, BITS))
    get_planes = rand_planes(BITS, rt["get_values"] // 8)
    get_unpack = bitplane_row(
        torch, f"get_sequence unpack, m {rt['get_values']}, keep 16",
        lambda i: BK.unpack(get_planes, BITS, BITS, torch.int16),
        lambda i: BR.unpack_ref(get_planes, BITS, BITS, torch.int16), unpack_k,
        bitplane_bytes(rt["get_values"], 2, BITS))
    del span, get_planes
    # cold: three buffers of 2^24 values and of their planes, outputs kept
    # alive over three calls, so each call's 67 MB miss the 50 MB L2
    vals = [torch.randint(0, 2**16, (COLD_VALUES,), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16) for _ in range(3)]
    planes = [BK.pack(u, BITS) for u in vals]
    outs = [None] * 3

    def keep_out(i, t):
        outs[i % 3] = t

    cold = [bitplane_row(
        torch, f"cold pack, m {COLD_VALUES}",
        lambda i: keep_out(i, BK.pack(vals[i % 3], BITS)),
        lambda i: keep_out(i, BR.pack_ref(vals[i % 3], BITS)), pack_k,
        bitplane_bytes(COLD_VALUES, 2, BITS), iters=60, plain_iters=2)]
    for keep in (BITS, 8):
        cold.append(bitplane_row(
            torch, f"cold unpack, m {COLD_VALUES}, keep {keep}",
            lambda i, keep=keep: keep_out(i, BK.unpack(planes[i % 3], BITS, keep, torch.int16)),
            lambda i, keep=keep: keep_out(i, BR.unpack_ref(planes[i % 3], BITS, keep,
                                                           torch.int16)),
            unpack_k, bitplane_bytes(COLD_VALUES, 2, keep), iters=60, plain_iters=2))
    del vals, planes, outs
    torch.cuda.empty_cache()
    for row in (append, chunk, slot_unpack, span_pack, get_unpack, *cold):
        parent = "" if "parent_route_ms" not in row else (
            f"; parent route {row['parent_route_ms']:.4f} / {row['parent_route_device_ms']:.4f} "
            f"({row['parent_route_kernels']} kernels)")
        log(f"phase 6: bitplane {row['shape']}: {row['ms']:.4f} / {row['device_ms']:.4f} ms "
            f"(events / device); bound {row['bound_ms']:.6f} ms by {row['bound_by']} "
            f"({row['bound_bytes']} B), {row['bound_share']:.3f} of it; launch floor "
            f"{floor_ms:.4f} / {floor_dev:.4f}; plain {row['plain_ms']:.4f} / "
            f"{row['plain_device_ms']:.4f}{parent}")
    cold_ratio = cold[2]["device_ms"] / cold[1]["device_ms"]
    log(f"phase 6: bitplane cold unpack device time keep 8 / keep 16 = {cold_ratio:.3f} "
        f"(bytes {cold[2]['bound_bytes'] / cold[1]['bound_bytes']:.3f})")
    floor = {"launch_floor_ms": floor_ms, "launch_floor_device_ms": floor_dev}

    qs = time_matmul(torch, dev, gen, 8, 1024, 1024, (8,), warm=True)[0]
    shapes = [row for m, k, n in ZAMBA_MLP
              for row in time_matmul(torch, dev, gen, m, k, n, (16, 12, 8, 4) if m == 8 else (8,))]
    by_keep = {r["keep"]: r for r in shapes if r["m"] == 8}
    ratio = by_keep[16]["device_ms"] / by_keep[8]["device_ms"]
    for r in [qs, *shapes]:
        log(f"phase 6: bitplane_matmul ({r['m']},{r['k']})x({r['k']},{r['n']}) keep {r['keep']} "
            f"{'warm' if r['warm'] else 'cold'}: {r['ms']:.4f} / {r['device_ms']:.4f} ms "
            f"(events / device; plan {r['plan']}); bound {r['bound_ms']:.5f} ms by "
            f"{r['bound_by']} ({r['bound_bytes']} B, {r['bound_flops']} bf16 operations), "
            f"{r['bound_share']:.3f} of it; plain {r['plain_ms']:.4f} / "
            f"{r['plain_device_ms']:.4f}; torch.matmul over the dense bf16 weight {r['library_ms']:.4f} / "
            f"{r['library_device_ms']:.4f} (kernel / library by device "
            f"{r['device_ms'] / r['library_device_ms']:.2f}); max abs err {r['max_abs_err']:.3g}")
    log(f"phase 6: bitplane_matmul at M 8 on the Zamba2-7B MLP shape: device time keep 16 / "
        f"keep 8 = {ratio:.3f}")
    src = "src/repro_torch/csrc/bitplane.cu"
    return [
        {"name": "bitplane_pack", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bitplane/kernel.py:53",
         "launches": serve_launches["bitplane_pack"],
         "launches_per_decode_step": per_step["bitplane_pack"],
         "launches_per_model_decode": decode["bitplane_pack"],
         "launches_per_prefill_chunk": prefill["bitplane_pack"],
         "max_abs_err": errs["bitplane_pack"],
         **{key: append[key] for key in ("shape", "ms", "device_ms", "plain_ms",
                                         "plain_device_ms", "bound_ms", "bound_by",
                                         "bound_bytes", "parent_route_ms",
                                         "parent_route_device_ms")},
         "library_ms": None, "library": "none", **floor,
         "shapes": [chunk, span_pack, cold[0]]},
        {"name": "bitplane_unpack", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bitplane/kernel.py:73",
         "launches": serve_launches["bitplane_unpack"],
         "launches_per_decode_step": per_step["bitplane_unpack"],
         "launches_per_model_decode": decode["bitplane_unpack"],
         "launches_per_prefill_chunk": prefill["bitplane_unpack"],
         "max_abs_err": errs["bitplane_unpack"],
         **{key: slot_unpack[key] for key in ("shape", "ms", "device_ms", "plain_ms",
                                              "plain_device_ms", "bound_ms", "bound_by",
                                              "bound_bytes", "parent_route_ms",
                                              "parent_route_device_ms")},
         "library_ms": None, "library": "none", **floor,
         "shapes": [get_unpack, cold[1], cold[2]], "cold_keep8_over_keep16": cold_ratio},
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul/kernel.py:49",
         "launches": qs_launches["bitplane_matmul"],
         "launches_per_quickstart_run": qs_launches["bitplane_matmul"],
         **{key: qs[key] for key in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                                     "bound_ms", "bound_by", "library_ms",
                                     "library_device_ms")},
         "max_abs_err": max(errs["bitplane_matmul"], qs["max_abs_err"]),
         "shape": [qs["m"], qs["k"], qs["n"]], "keep": qs["keep"],
         "library": "torch.matmul (dense bf16 weight)",
         "shapes": shapes, "zamba2_mlp_m8_keep16_over_keep8": ratio},
    ]


def time_matmul(torch, dev, gen, m: int, k: int, n: int, keeps, warm: bool = False) -> list:
    """The bit-plane matmul at x (m, k) x W (k, n), one row per keep: CUDA
    events around back-to-back calls and the profiler's device time (the
    product kernel and, when K is split, the kernel that adds the splits),
    beside the bound, the plain version and torch.matmul over the dense
    bf16 weight.  Cold (``warm`` False): the calls rotate over three
    weights, each stored both as planes and as dense bf16 (103 MB of bf16
    at the Zamba2-7B MLP shape, so a kept-plane read finds nothing in the
    50 MB L2); warm: one weight, as the quickstart multiplies right after
    packing."""
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.bitplane_matmul import ops as MM
    from repro_torch.kernels.bitplane_matmul import ref as MR

    nbuf = 1 if warm else 3
    dense = [(torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
             for _ in range(nbuf)]
    planes = [MM.pack_weights(w) for w in dense]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lib = lambda i: torch.matmul(x, dense[i % nbuf])  # noqa: E731
    lib_ms, lib_dev = cuda_time_ms(lib, iters=30), device_ms(lib, "", 30)
    rows = []
    for keep in keeps:
        plan = MK.plan(m, k, n, keep)
        run = lambda i: MK.bitplane_matmul(x, planes[i % nbuf], keep=keep)  # noqa: E731
        plain = lambda i: MR.bitplane_matmul_ref(x, planes[i % nbuf], keep)  # noqa: E731
        err = float((run(0) - plain(0)).abs().max())
        torch.testing.assert_close(run(0), plain(0), atol=MATMUL_ATOL, rtol=MATMUL_RTOL)
        k_ms = cuda_time_ms(run, iters=30)
        k_dev = device_ms(run, "bitplane_matmul", 30, 2 if plan["splits"] > 1 else 1)
        p_ms, p_dev = cuda_time_ms(plain, iters=2, warmup=1), device_ms(plain, "", 2)
        nbytes = keep * k * n // 8 + 2 * m * k + 4 * m * n
        flops = 2 * m * k * n
        b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
        rows.append({"m": m, "k": k, "n": n, "keep": keep, "warm": warm, "plan": plan,
                     "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
                     "plain_device_ms": p_dev, "bound_ms": b_ms, "bound_by": b_by,
                     "bound_bytes": nbytes, "bound_flops": flops,
                     "bound_share": b_ms / k_dev,
                     "library_ms": lib_ms, "library_device_ms": lib_dev,
                     "max_abs_err": err})
    del dense, planes
    torch.cuda.empty_cache()
    return rows


# The cold encode: 2^24 bf16 values as the (layers, 2, t, C) transposed view
# of a (2, layers, t, C) tensor, three of them rotated (beyond the 50 MB L2)
EXP_DELTA_COLD = (2, 32, 1024, 256)


def encode_bytes(view, group: int = 16) -> int:
    """Bytes the fused cluster-and-encode must move: the view's values read
    once (a ragged tail's repeated token once), the encoded groups and a
    base byte per channel of each group written once."""
    pages = math.prod(view.shape[:-2]) * -(-view.shape[-2] // group)
    w = view.element_size()
    return view.numel() * w + pages * view.shape[-1] * (group * w + 1)


def time_exp_delta_kernels(torch, span, view, errs, serve_launches, per_step, rt,
                           spans) -> list:
    """The encode at the shapes the main path gives it, each timed by CUDA
    events around back-to-back calls and by the profiler's device time,
    beside its byte bound (a few integer operations a value: bytes bind),
    the plain version and the parent's route for the same work
    (``parent_span_encode``, every kernel of it): the 512-token serving span
    as ``slot_kv_bits`` returns it ((4, 2, 512, 192), phase 2's bf16 KV; 1.5
    MB, in L2 as it is for the real caller, which has just unpacked it), a
    decode page fill (its first 16 tokens: 8 pages) and a cold 2^24 values
    (EXP_DELTA_COLD, buffers rotated and outputs kept alive over three
    calls).  Then the flat entry point (the (R, G, 1) view: the kernel's
    direct path) at the span's (49,152, 16) rows and the decode there,
    with the launch floor (an empty kernel)."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.exp_delta import ref as ER

    man, mask = EXP_DELTA_FIELDS[16]
    enc_k, dec_k = "exp_delta_encode_kernel", "exp_delta_decode_kernel"
    floor_ms = cuda_time_ms(lambda i: BK.launch_empty(), iters=200)
    floor_dev = device_ms(lambda i: BK.launch_empty(), "bitplane_empty_kernel", 200)
    outs = [None] * 3

    def keep_out(i, t):
        outs[i % 3] = t

    def views_row(what, views, iters=200, plain_iters=20):
        n = len(views)
        return bitplane_row(
            torch, what, lambda i: keep_out(i, EK.cluster_encode(views[i % n], 16, man, mask)),
            lambda i: keep_out(i, ER.cluster_encode_ref(views[i % n], 16, man, mask)), enc_k,
            encode_bytes(views[0]), iters, plain_iters,
            parent=lambda i: keep_out(i, parent_span_encode(views[i % n])))

    span_row = views_row(f"serving span view {tuple(view.shape)}", [view])
    fill = view[:, :, :PAGE]
    fill_row = views_row(f"decode page fill {tuple(fill.shape)}", [fill])
    gen = torch.Generator(device=view.device).manual_seed(22)
    cold = [torch.randint(0, 2**16, EXP_DELTA_COLD, generator=gen, device=view.device,
                          dtype=torch.int32).to(torch.int16).transpose(0, 1) for _ in range(3)]
    cold_row = views_row(f"cold {tuple(cold[0].shape)} view, 2^24 values", cold, iters=60,
                         plain_iters=2)
    del cold
    outs[:] = [None] * 3
    enc, base = EK.encode(span, man, mask)
    flat_row = bitplane_row(torch, f"flat rows {tuple(span.shape)}",
                            lambda i: EK.encode(span, man, mask),
                            lambda i: ER.encode_ref(span, man, mask),
                            enc_k,
                            2 * span.numel() * span.element_size() + base.numel())
    dec_row = bitplane_row(torch, f"flat rows {tuple(span.shape)}",
                           lambda i: EK.decode(enc, base, man, mask),
                           lambda i: ER.decode_ref(enc, base, man, mask), dec_k,
                           2 * span.numel() * span.element_size() + base.numel())
    torch.cuda.empty_cache()
    for name, row in (("encode", span_row), ("encode", fill_row), ("encode", cold_row),
                      ("encode", flat_row), ("decode", dec_row)):
        parent = "" if "parent_route_ms" not in row else (
            f"; parent route {row['parent_route_ms']:.4f} / {row['parent_route_device_ms']:.4f} "
            f"({row['parent_route_kernels']} kernels)")
        log(f"phase 6: exp_delta_{name} {row['shape']}: {row['ms']:.4f} / "
            f"{row['device_ms']:.4f} ms (events / device); bound {row['bound_ms']:.6f} ms by "
            f"{row['bound_by']} ({row['bound_bytes']} B), {row['bound_share']:.3f} of it; "
            f"launch floor {floor_ms:.4f} / {floor_dev:.4f}; plain {row['plain_ms']:.4f} / "
            f"{row['plain_device_ms']:.4f}{parent}")
    src = "src/repro_torch/csrc/exp_delta.cu"
    floor = {"launch_floor_ms": floor_ms, "launch_floor_device_ms": floor_dev}
    keys = ("shape", "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms", "bound_by",
            "bound_bytes", "bound_share")
    return [
        {"name": "exp_delta_encode", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/exp_delta/kernel.py:44",
         "launches": serve_launches["exp_delta_encode"],
         "max_abs_err": float(errs["exp_delta_encode"]),
         "launches_per_decode_step": per_step["exp_delta_encode"],
         "launches_per_put_sequence": rt["encode_launches"] / rt["sequences"],
         "span_kernels_between_unpack_and_pack": spans,
         **{key: span_row[key] for key in keys + ("parent_route_ms", "parent_route_device_ms",
                                                  "parent_route_kernels")},
         "library_ms": None, "library": "none", **floor,
         "shapes": [fill_row, cold_row, flat_row]},
        {"name": "exp_delta_decode", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/exp_delta/kernel.py:69",
         "launches": rt["decode_launches"],
         "max_abs_err": float(errs["exp_delta_decode"]),
         "launches_per_get_sequence": rt["decode_launches"] / rt["gets"],
         "launches_in_serving": serve_launches["exp_delta_decode"],
         **{key: dec_row[key] for key in keys},
         "library_ms": None, "library": "none", **floor},
    ]


def ssd_work(bsz: int, l: int, h: int, p: int, n: int, q: int, g: int) -> tuple:
    """(bytes, causal operations of each product, TPU-form operations) of
    one SSD launch: each input read once (xdt, da, b and c per group, h0)
    and each output written once (y, h_final), float32.  The function needs
    only the causal half of the two Q x Q products: per (batch, head, chunk)
    2 Q(Q+1)/2 N for the scores c.b, 2 Q(Q+1)/2 P for scores.xdt and 2 Q N P
    each for c.state and the chunk state, in that order.  The TPU kernel
    computes the Q x Q products in full, 2 (Q^2 N + Q^2 P + 2 Q N P), and
    that count is kept only for comparison."""
    nbytes = 4 * (2 * bsz * l * h * p + bsz * l * h + 2 * bsz * l * g * n
                  + 2 * bsz * h * n * p)
    blocks = bsz * h * (l // q)
    full = 2 * (q * q * n + q * q * p + 2 * q * n * p) * blocks
    tri = q * (q + 1) // 2
    products = tuple(2 * k * blocks for k in (tri * n, tri * p, q * n * p, q * n * p))
    return nbytes, products, full


def ssd_bounds(nbytes: int, products: tuple, passes: tuple = SSD_PASSES_F32) -> dict:
    """Both bounds of an SSD launch: the form the kernel takes on these
    inputs (each product's causal operations times its TF32 passes at the
    TF32 tensor-core rate) against the bytes, and float32 on the CUDA cores
    against the bytes."""
    causal = sum(products)
    tc_flops = sum(k * o for k, o in zip(passes, products))
    tc_ms, tc_by = bound_ms(nbytes, tc_flops, TF32_TENSOR_FLOPS)
    f32_ms, f32_by = bound_ms(nbytes, causal, F32_FLOPS)
    return {"bound_ms": tc_ms, "bound_by": tc_by, "bound_flops": tc_flops,
            "bound_form": f"TF32 tensor cores, passes {list(passes)}",
            "f32_bound_ms": f32_ms, "f32_bound_by": f32_by, "causal_flops": causal,
            "bound_bytes": nbytes}


def time_ssd_shape(torch, err: float, case: tuple, passes: tuple = SSD_PASSES_F32) -> dict:
    """The SSD kernel on phase 2's inputs at one prefill shape (beyond L2:
    156 MB at Mamba2-1.3B's, 489 MB at Zamba2-7B's), timed with CUDA events
    and with the profiler's device time of its three kernels, beside the
    plain version's times and both bounds (``passes``: the TF32 passes the
    kernel takes for each product on these inputs)."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as SR

    xdt, da, b, c, h0 = case
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    q = 256
    run = lambda i: SK.ssd(xdt, da, b, c, h0, chunk=q)  # noqa: E731
    plain = lambda i: SR.ssd_ref(xdt, da, b, c, h0, chunk=q)  # noqa: E731
    per_call = kernels_per_call(run, "::ssd_")
    k_ms, k_dev = cuda_time_ms(run, iters=20), device_ms(run, "::ssd_", 20, per_call)
    p_ms, p_dev = cuda_time_ms(plain, iters=3), device_ms(plain, "", 3)
    nbytes, products, full = ssd_work(bsz, l, h, p, n, q, g)
    bounds = ssd_bounds(nbytes, products, passes)
    causal = bounds["causal_flops"]
    b_full, _ = bound_ms(nbytes, full, F32_FLOPS)
    ws = SK.plan(bsz, l, h, g, p, n, q)["workspace_bytes"]
    log(f"phase 6: ssd B={bsz} L={l} H={h} P={p} N={n} G={g} Q={q}: {k_ms:.4f} / {k_dev:.4f} "
        f"ms (events / device, {per_call} kernels a call); bound {bounds['bound_ms']:.4f} ms "
        f"by {bounds['bound_by']} ({bounds['bound_flops']} TF32 operations: passes "
        f"{list(passes)} over {list(products)} operations of the causal half of the Q x Q "
        f"products at {TF32_TENSOR_FLOPS / 1e12:.0f} TFLOP/s, "
        f"{nbytes} B), {bounds['bound_ms'] / k_dev:.3f} of it; float32 CUDA-core bound "
        f"{bounds['f32_bound_ms']:.4f} ms by {bounds['f32_bound_by']}, "
        f"{bounds['f32_bound_ms'] / k_dev:.3f} of it; {causal / (k_dev * 1e-3) / 1e12:.2f} "
        f"TFLOP/s of causal work; workspace {ws} B written once, read twice; the TPU "
        f"kernel's full Q x Q form would count {full} operations, {b_full:.4f} ms in "
        f"float32; plain {p_ms:.4f} / {p_dev:.4f} ms")
    return {"shape": [bsz, l, h, p, n, g], "chunk": q, "kernels_per_call": per_call,
            "max_abs_err": err, "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
            "plain_device_ms": p_dev, **bounds, "bound_share": bounds["bound_ms"] / k_dev,
            "workspace_bytes": ws, "tpu_form_flops": full, "tpu_form_f32_bound_ms": b_full}


def bf16_valued_bc(torch, case: tuple) -> tuple:
    """``case`` with b and c rounded to bf16 values, as the models' are
    (their products then take the kernel's exact-TF32 path), held to the
    plain version within SSD_REL_TOL; returns (max abs err, the inputs)."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as SR

    xdt, da, b, c, h0 = case
    case = (xdt, da, b.bfloat16().float(), c.bfloat16().float(), h0)
    (y, hf), (y_r, hf_r) = SK.ssd(*case, chunk=256), SR.ssd_ref(*case, chunk=256)
    err_y, err_h = float((y - y_r).abs().max()), float((hf - hf_r).abs().max())
    rel = max(err_y / float(y_r.abs().max()), err_h / float(hf_r.abs().max()))
    log(f"phase 6: ssd B L = {tuple(xdt.shape[:2])}, b and c bf16-valued: rel err {rel:.3g}, "
        f"tolerance {SSD_REL_TOL} of max")
    if not rel <= SSD_REL_TOL:
        raise AssertionError("ssd kernel differs from plain on bf16-valued b and c")
    return max(err_y, err_h), case


def time_ssd_kernel(torch, checks: dict, mamba: dict, zamba: dict) -> dict:
    """The SSD kernel's row: at the Mamba2-1.3B prefill shape, with under
    ``shapes`` the Zamba2-7B prefill shape and both shapes with b and c
    rounded to bf16 values as the models' are (``time_ssd_shape``)."""
    row = time_ssd_shape(torch, *checks["mamba2"])
    z = time_ssd_shape(torch, *checks["zamba2"])
    z["device_ms_in_prefill_step"] = zamba["ssd_device_ms"] / zamba["prefill_ssd_launches"]
    exact = []
    for name in ("mamba2", "zamba2"):
        exact.append(time_ssd_shape(torch, *bf16_valued_bc(torch, checks[name][1]),
                                    SSD_PASSES_BF16_BC))
        exact[-1]["bc"] = "bf16-valued"
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:72",
            "launches": mamba["prefill_launches"],
            "launches_per_prefill_step": mamba["prefill_launches"],
            "launches_per_serve_step": mamba["decode_launches"] / SSM_STEPS,
            "launches_per_zamba2_prefill_step": zamba["prefill_ssd_launches"],
            **row, "device_ms_in_prefill_step": mamba["ssd_device_ms"]
            / mamba["prefill_launches"], "library_ms": None, "library": "none",
            "shapes": [z, *exact]}


def flash_work(pos, kv_valid, hp: int, hd: int, causal: bool, window: int) -> int:
    """Operations of one causal flash launch on these inputs: 4 hd per
    (query, visible key) pair per head (q·k and p·v, two operations per
    multiply-add); the pairs follow the masks of this run's q_pos and
    kv_valid."""
    import torch

    qp = pos.long()
    hi = kv_valid.long()[:, None].expand_as(qp)
    if causal:
        hi = torch.minimum(hi, qp + 1)
    lo = (qp - window + 1).clamp(min=0) if window > 0 else torch.zeros_like(qp)
    pairs = int((hi - lo).clamp(min=0).sum())
    return 4 * hd * hp * pairs


def kernels_per_call(fn, match: str) -> int:
    """Kernels whose name holds ``match`` that one call of ``fn(0)``
    launches, as a profiler window over that one call records them (a
    flash call launches its attention kernel and, when its keys are split,
    the merge kernel)."""
    fn(0)
    rows = device_rows(lambda: fn(0), f"one call ({match})", repeatable=True)
    n = sum(e.count for e in rows if match in e.key)
    if n <= 0:
        raise AssertionError(f"one call launched no {match} kernel")
    return n


# Phase 6's SmolLM-135M prefill chunks (9 q / 3 kv heads of 64), (sq, skv,
# start, kv_valid): into a 1024-row slot the first chunk (not split), the
# last one and a 512-row chunk at an offset with valid below the slot; and
# a chunk at the end of a 4096-row cache (the plan splits the last three)
FLASH_CHUNKS = ((64, S, 0, 64), (64, S, 960, S), (512, S, 448, 960),
                (64, 4 * S, 4 * S - 64, 4 * S))


def sdpa_backend(names) -> str:
    """The SDPA backend a call took, from its device kernels' names."""
    text = " ".join(names).lower()
    for key, name in (("cudnn", "cudnn"), ("flash", "flash"), ("fmha", "efficient"),
                      ("mem_eff", "efficient"), ("cutlass", "efficient")):
        if key in text:
            return name
    return "math"


def time_flash_chunks(torch, dev) -> list:
    """The flash kernel at FLASH_CHUNKS (warm: a chunk's K and V, 0.79 MB,
    stay in L2, as between a prefill's layers they would not, but each
    call lasts microseconds and its fixed cost is what these rows show): device
    time of every kernel of a call and CUDA-event time, the bound, and
    scaled_dot_product_attention over k[:, :valid] (k and v repeated to the
    query heads) with a boolean mask, named by the backend it took."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK

    gen = torch.Generator(device=dev).manual_seed(19)
    hp, hkv, hd = 9, 3, HD
    out = []
    for sq, skv, start, valid in FLASH_CHUNKS:
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

        q, k, v = randn(1, sq, hp, hd), randn(1, skv, hkv, hd), randn(1, skv, hkv, hd)
        pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].contiguous()
        kv_valid = torch.full((1,), valid, dtype=torch.int32, device=dev)
        run = lambda i: FK.flash_attention(q, k, v, pos, kv_valid, causal=True, window=0,  # noqa: E731,B023
                                           valid=valid)
        per_call = kernels_per_call(run, "flash_attention_")
        k_ms = cuda_time_ms(run, iters=200)
        k_dev = device_ms(run, "flash_attention_", 100, per_call)
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t[:, :valid].repeat_interleave(hp // hkv, dim=2).transpose(1, 2).contiguous()
                  for t in (k, v))
        amask = torch.arange(valid, device=dev)[None, :] <= pos[0, :, None]
        lib = lambda i: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask)  # noqa: E731,B023
        lib(0)
        lib_names = sorted({e.key for e in device_rows(lambda: lib(0), "one SDPA call",
                                                         repeatable=True)})
        lib_ms, lib_dev = cuda_time_ms(lib, iters=200), device_ms(lib, "", 100)
        flops = flash_work(pos, kv_valid, hp, hd, causal=True, window=0)
        nbytes = 2 * (2 * q.numel() + 2 * valid * hkv * hd)
        b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
        backend = sdpa_backend(lib_names)
        log(f"phase 6: flash_attention chunk Sq={sq} start={start} kv_valid={valid} "
            f"(Skv {skv}, 9 q / 3 kv heads of {hd}): {k_ms:.4f} / {k_dev:.4f} ms (events / "
            f"device, {per_call} kernels a call); bound {b_ms:.6f} ms by {b_by}; SDPA "
            f"({backend}: {'; '.join(n[:60] for n in lib_names)}) {lib_ms:.4f} / "
            f"{lib_dev:.4f} ms; device factor {k_dev / lib_dev:.2f}")
        out.append({"shape": [1, sq, skv, hp, hkv, hd], "start": start, "kv_valid": valid,
                    "kernels_per_call": per_call, "ms": k_ms, "device_ms": k_dev,
                    "bound_ms": b_ms, "bound_by": b_by, "bound_flops": flops,
                    "bound_bytes": nbytes, "library_ms": lib_ms,
                    "library_device_ms": lib_dev, "library_backend": backend})
    return out


def serving_chunks() -> collections.Counter:
    """(bucket, start, end) of every prefill chunk of phase 3's serving run,
    counted: its requests cut as the scheduler cuts them (the largest
    bucket that fits, the smallest one padded for a ragged tail)."""
    from repro_torch.serving.scheduler import next_chunk, prefill_buckets

    buckets = prefill_buckets(S)
    chunks = collections.Counter()
    for req in make_requests():
        n, start = len(req.prompt), 0
        while start < n:
            bucket, real = next_chunk(n - start, buckets)
            chunks[(bucket, start, start + real)] += 1
            start += real
    return chunks


def flash_unsplit(torch, q, k, v, pos, kv_valid):
    """One flash launch with its keys not split (one range of every key
    tile), the call the wrapper makes when the plan does not split: the
    yardstick for the plan's splits (no count in LAUNCHES)."""
    from repro_torch.kernels.flash_attention import kernel as FK

    b, sq, hp, hd = q.shape
    p = FK.plan(b, sq, k.shape[1], hp, k.shape[2], hd)
    out = torch.empty_like(q)
    err = FK._library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), kv_valid.data_ptr(), None,
        None, out.data_ptr(), None, None, b, sq, k.shape[1], hp, k.shape[2], hd, 1, 0,
        p["tokens"], 1, p["key_tiles"], torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise AssertionError(f"flash launch failed with CUDA error {err}")
    return out


def time_flash_mix(torch, dev) -> dict:
    """The flash kernel at every distinct prefill chunk of phase 3's run
    (``serving_chunks``; SmolLM-135M heads, a 1024-row slot, kv_valid the
    chunk's end), each held against the plain version and timed by device
    as the wrapper plans it and with its keys not split; the sums weight
    each chunk by how often the run issues it (one layer's calls).  Each
    chunk's bound is counted as ``time_flash_chunks`` counts it: q read and
    the output written, K and V of the valid keys read (bytes), and the
    causal operations of this chunk's positions (``flash_work``) at the
    bf16 tensor-core peak; the larger of the two, summed like the times."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=dev).manual_seed(23)
    hp, hkv, hd = 9, 3, HD
    k = torch.randn((1, S, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((1, S, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    chunks = serving_chunks()
    total = {"plan": 0.0, "unsplit": 0.0, "bound": 0.0}
    split = 0
    rows, calls = [], []
    for (sq, start, end), n in sorted(chunks.items()):
        q = torch.randn((1, sq, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
        pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].contiguous()
        kv_valid = torch.full((1,), end, dtype=torch.int32, device=dev)
        p = FK.plan(1, sq, S, hp, hkv, hd, end)
        # bound to this chunk's tensors: the calls run after the loop
        run = lambda i, q=q, pos=pos, kv_valid=kv_valid, end=end: FK.flash_attention(  # noqa: E731
            q, k, v, pos, kv_valid, causal=True, window=0, valid=end)
        whole = lambda i, q=q, pos=pos, kv_valid=kv_valid: flash_unsplit(  # noqa: E731
            torch, q, k, v, pos, kv_valid)
        want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=end)
        for fn in (run, whole):
            got = fn(0)
            steps = row_bf16_steps(got, want)
            if not (torch.isfinite(got.float()).all() and steps <= FLASH_BF16_STEPS):
                raise AssertionError(f"flash kernel differs from plain at chunk {sq} at {start}")
        calls += [(run, 1 + (p["splits"] > 1)), (whole, 1)]
        b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * end * hkv * hd),
                              flash_work(pos, kv_valid, hp, hd, causal=True, window=0),
                              BF16_TENSOR_FLOPS)
        rows.append((sq, start, end, n, p, b_ms, b_by))
    # every chunk's two calls in one profiler window
    times = device_ms_each(calls, "flash_attention_", 20, "phase 3's prefill chunks")
    for (sq, start, end, n, p, b_ms, b_by), t_plan, t_whole in zip(rows, times[0::2],
                                                                   times[1::2]):
        total["plan"] += n * t_plan
        total["unsplit"] += n * t_whole
        total["bound"] += n * b_ms
        split += n * (p["splits"] > 1)
        log(f"phase 6: flash_attention serving chunk {sq} at {start}, valid {end} (x{n}): "
            f"{p['splits']} splits of {p['tiles_per_split']} of {p['key_tiles']} key tiles "
            f"{t_plan:.6f} ms device, not split {t_whole:.6f}; bound {b_ms:.6f} by {b_by}")
    log(f"phase 6: flash_attention over phase 3's {sum(chunks.values())} prefill chunks "
        f"({len(chunks)} distinct, {split} split), one layer: {total['plan']:.6f} ms device "
        f"as planned, {total['unsplit']:.6f} not split; bound {total['bound']:.6f} ms, "
        f"{total['bound'] / total['plan']:.3f} of it as planned")
    return {"chunks": sum(chunks.values()), "distinct": len(chunks), "split_chunks": split,
            "device_ms": total["plan"], "unsplit_device_ms": total["unsplit"],
            "bound_ms": total["bound"], "bound_share": total["bound"] / total["plan"]}


def time_flash_kernel(torch, err: float, case: tuple, zamba: dict, chunk: dict) -> dict:
    """The flash kernel at the Zamba2-7B prefill shape on phase 2's inputs
    (59 MB each of q, k and v, beyond L2), timed with CUDA events and with
    the profiler's device time (every kernel of a call), beside the plain
    version's times, the bound and scaled_dot_product_attention on the
    same inputs (a yardstick the port never calls); then at the SmolLM
    prefill chunks (``time_flash_chunks``), whose rows go under
    ``shapes``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    q, k, v, pos, kv_valid = case
    b, l, hp, hd = q.shape
    run = lambda i: FK.flash_attention(q, k, v, pos, kv_valid, causal=True, window=0)  # noqa: E731
    plain = lambda i: FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=kv_valid)  # noqa: E731
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = lambda i: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)  # noqa: E731
    per_call = kernels_per_call(run, "flash_attention_")
    k_ms = cuda_time_ms(run, iters=10)
    k_dev = device_ms(run, "flash_attention_", 10, per_call)
    p_ms, p_dev = cuda_time_ms(plain, iters=3), device_ms(plain, "", 3)
    lib_ms, lib_dev = cuda_time_ms(lib, iters=10), device_ms(lib, "", 10)
    flops = flash_work(pos, kv_valid, hp, hd, causal=True, window=0)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    log(f"phase 6: flash_attention {k_ms:.4f} / {k_dev:.4f} ms (events / device, "
        f"{per_call} kernels a call) at B={b} L={l} Hp={hp} hd={hd} causal: bound "
        f"{b_ms:.4f} ms by {b_by} ({flops} bf16 operations over the visible pairs, "
        f"{nbytes} B), {flops / (k_dev * 1e-3) / 1e12:.1f} TFLOP/s, {b_ms / k_dev:.3f} of "
        f"the bound; plain {p_ms:.4f} / {p_dev:.4f} ms; scaled_dot_product_attention "
        f"{lib_ms:.4f} / {lib_dev:.4f} ms; device factor {k_dev / lib_dev:.2f}")
    shapes = time_flash_chunks(torch, q.device)
    mix = time_flash_mix(torch, q.device)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:79",
            "launches": zamba["prefill_flash_launches"],
            "launches_per_prefill_step": zamba["prefill_flash_launches"],
            "launches_per_serve_step": zamba["decode_launches"][0] / ZAMBA_STEPS,
            "launches_per_smollm_prefill_chunk": chunk["flash_attention"],
            "kernels_per_call": per_call,
            "max_abs_err": err, "ms": k_ms, "device_ms": k_dev,
            "device_ms_in_prefill_step": zamba["flash_device_ms"]
            / zamba["prefill_flash_launches"],
            "plain_ms": p_ms, "plain_device_ms": p_dev,
            "bound_ms": b_ms, "bound_by": b_by, "bound_flops": flops,
            "bound_bytes": nbytes, "library_ms": lib_ms, "library_device_ms": lib_dev,
            "library": "torch.nn.functional.scaled_dot_product_attention",
            "shapes": shapes, "serving_mix": mix}

# ---------------------------------------------------------------------------
# Phases 3s and 7: the sharded tier, and Mixtral-8x7B through the ring
# ---------------------------------------------------------------------------

# Phase 3s: phase 3's trace through backend="sharded": SmolLM-135M's 3 kv
# heads split over 3 shards (the head route: each page's channels cut per
# shard) and, as 3 does not divide by 2, whole pages dealt over 2 shards
# (the sequence route)
SHARDED_RUNS = ((3, "head"), (2, "seq"))
# Phase 7: Mixtral-8x7B (src/repro_torch/configs/mixtral_8x7b.py) at full
# width, cut in depth from 32 layers (about 2.9 GB of bf16 weights a layer:
# 32 are 93 GB, past the card's 80) to 4 (8 until phase 8 came: the whole
# script took 1,177.8 s of its 1,200 on a slow host with an NVIDIA H100
# 80GB HBM3 at 700 W, PERF.md §6); four
# slots of an 8,192-token context in a 4,096-token ring; six greedy
# requests of 160 new tokens: two prompts inside the window, two that
# cross it while they decode, two that start beyond it
MIXTRAL_LAYERS = 4
MIXTRAL_BATCH, MIXTRAL_CTX, MIXTRAL_NEW = 4, 8192, 160
MIXTRAL_PROMPTS = (1024, 2048, 3968, 4032, 4500, 6000)
# layers written through the compressed store: every decode step queues one
# fetch job a stored page per layer and stream (the reference's
# accounting), about 0.1 ms of host time each, and four slots of a
# 4,096-token window hold up to 1,032 pages a layer and stream; one layer
# keeps a step near 150 ms of host time and the phase inside its 150 s.
# The lane engine is unbounded, as in phase 3p: a full-width page is 32 KiB
# a stream, and phase 3's 4 MiB window a step deferred most prompt pages
# until their requests retired and cancelled them (PERF.md §6), so
# the store would not follow the window it exists to follow
MIXTRAL_STORE_LAYERS = 1
# the profiler window of a timed ring run: this many decode steps, from the
# first step at which every slot decodes
RING_WINDOW_STEPS = 4
# phase 6's ring chunk: the chunk's queries over [a full 4,096-slot ring]
# ++ [the chunk], Mixtral's heads (32 q, 8 kv, hd 128), at two chunk sizes
RING_CHUNKS = (512, 4096)
# phase 6's ring chunk with one key that dominates every query that may see
# it (its key a large multiple of a direction all queries share, its value
# a constant far from the others'), at a chunk of RING_DOMINANT_CHUNK from
# position 6,096 over the full ring of RING_CHUNKS' rows (4,096 slots after
# 6,096 tokens: the wrap at slot 2,000, the window's edge at 6,096 - 4,095
# for the chunk's first query): (case, the key's position).  A tile the sort
# skips or takes whole by mistake moves the rows of that key by tens of bf16
# steps.
RING_DOMINANT_CHUNK = 512
RING_DOMINANT = (("just inside the window edge", 2001),      # the first query's alone
                 ("just past the window edge", 2000),        # no query's
                 ("the last ring key before the wrap", 6095),  # slot 1,999: every query's
                 ("an old position still seen by the early queries", 2100))  # 100 queries'
# phase 6's paged attention over a ring: B 4, a 4,096-slot ring, Mixtral's
# heads, the slots' lengths (two wrapped, one part-filled, one just full)
RING_PAGED = (4, 4096, 8, 4, 128)
RING_LENS = (6160, 4200, 3000, 4096)


def sharded_config(shards: int, base=None):
    import dataclasses

    return dataclasses.replace(base or engine_config("fused"), backend="sharded", shards=shards)


def run_sharded_phase(torch, model, params, paged_reqs, paged_ledger, requests=make_requests,
                      base=None, runs=SHARDED_RUNS) -> dict:
    """Phase 3s: phase 3's requests through the sharded tier, fused kernel,
    at SHARDED_RUNS.  Each run's greedy tokens must equal phase 3's paged
    fused run's (the device KV and the plane map do not depend on the
    tier), its page writes queued must be the paged run's byte for byte (a
    head route's parts sum to the page), and its shards' stored logical
    bytes plus the writes ``retire`` cancelled must be what it queued.
    ``requests``, ``base`` and ``runs`` default to phase 3's requests and
    engine config and SHARDED_RUNS (a smaller model takes its own)."""
    from repro_torch.serving import ContinuousScheduler

    out = {}
    n_layers = model.cfg.n_layers
    dev = params["embed"]["table"].device
    for shards, route in runs:
        sched = ContinuousScheduler(model, params, sharded_config(shards, base), device=dev)
        reqs = requests()
        for m in launch_modules():
            m.reset_launches()
        t0 = time.perf_counter()
        with write_job_ledger() as ledger:
            for r in reqs:
                sched.submit(r)
            sched.run_until_drained()
            if dev.type == "cuda":
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
        rep = sched.report()
        what = f"phase 3s [shards {shards}]"
        if rep["shard_route"] != route or len(rep["shards"]) != shards:
            raise AssertionError(f"{what}: route {rep['shard_route']} over "
                                 f"{len(rep['shards'])} shards, expected {route}")
        same = sum(a.output == b.output for a, b in zip(reqs, paged_reqs))
        if same != len(reqs):
            raise AssertionError(f"{what}: {len(reqs) - same} requests' greedy tokens differ "
                                 f"from phase 3's paged run")
        per_shard = [s["kv_logical_bytes"] for s in rep["shards"]]
        if sum(per_shard) != rep["kv_logical_bytes"]:
            raise AssertionError(f"{what}: shards' logical bytes {per_shard} do not sum to "
                                 f"{rep['kv_logical_bytes']}")
        if ledger["submitted_write_bytes"] != paged_ledger["submitted_write_bytes"]:
            raise AssertionError(f"{what}: queued {ledger['submitted_write_bytes']} page-write "
                                 f"bytes, the paged run {paged_ledger['submitted_write_bytes']}")
        if rep["kv_logical_bytes"] + ledger["cancelled_write_bytes"] \
                != ledger["submitted_write_bytes"]:
            raise AssertionError(f"{what}: queued page writes are neither stored nor cancelled")
        if dev.type == "cuda":  # a CPU run takes the plain versions, no launch
            expect_launches(what, launches, {
                "paged_attention_fused": n_layers * rep["decode_steps"],
                "paged_attention_rung": 0, "flash_attention": n_layers * rep["prefill_chunks"],
                "exp_delta_encode": sum(sched.backend.page_encodes.values()),
                "exp_delta_decode": 0})
        log(f"{what}: route {route}, {rep['decode_steps']} decode steps, tokens equal phase "
            f"3's paged run ({same}/{len(reqs)} requests), launches {launches}; kv_logical_bytes "
            f"by shard {per_shard} (sum {sum(per_shard)}), stored by shard "
            f"{[s['kv_stored_bytes'] for s in rep['shards']]}; write bytes queued "
            f"{ledger['submitted_write_bytes']} (paged {paged_ledger['submitted_write_bytes']}) "
            f"= stored {rep['kv_logical_bytes']} + cancelled {ledger['cancelled_write_bytes']}; "
            f"engine latency by shard {[round(s['engine_modeled_latency_ns']) for s in rep['shards']]} "
            f"ns; wall {wall:.2f} s, {rep['decode_tok_per_s']:.1f} tok/s; digest "
            f"{phase3_digest(reqs, rep, True)}")
        out[shards] = {"launches": launches, "route": route, "wall": wall, "rep": rep,
                       "reqs": reqs}
    return out


def mixtral_requests(vocab: int, prompts=MIXTRAL_PROMPTS, new: int = MIXTRAL_NEW) -> list:
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(1)
    return [Request(rid=i, prompt=rng.integers(0, vocab, n).astype(np.int32), max_new_tokens=new)
            for i, n in enumerate(prompts)]


def ring_config(kernel: str, max_batch: int = MIXTRAL_BATCH, max_ctx: int = MIXTRAL_CTX):
    from repro_torch.core.quantization import PrecisionLadder
    from repro_torch.memctl import MemCtlConfig
    from repro_torch.serving import EngineConfig

    return EngineConfig(max_batch=max_batch, max_ctx=max_ctx, ladder=PrecisionLadder(LADDER),
                        codec="lz4", device_kv="bitplane", decode_kernel=kernel,
                        backend="ring", store_layers=MIXTRAL_STORE_LAYERS,
                        engine=MemCtlConfig(step_cycles=None))


def serve_ring(torch, model, params, cfg, reqs, profile_steps: int = 0,
               snap: bool = False, phase: str = "phase 7") -> dict:
    """One phase-7 run: every request submitted at once and served to the
    end of the backlog, launch counts reset just before and read just
    after; the store's resident pages after every step (their largest
    count), the pages the window retired (``drop_page`` calls that dropped
    a page) and each request's first stored page.  On the card, a profiler
    window of ``profile_steps`` decode steps from the first step at which
    every slot decodes gives the device time a decode step.  The host time
    a decode step is one definition throughout: the mean wall time of the
    steps outside that window that start and end with every slot decoding
    (no prefill chunk), split into the model's decode call up to its
    tokens on the host (the scheduler's ``decode_s``) and the memory
    tier's bookkeeping (``on_decode_token`` and ``tick``: page writes,
    window retirement, fetch jobs, the lane engine).  With ``snap``, a
    copy of the cache
    at the first step at which every slot decodes and one has crossed the
    window (for the teacher-forced checks; a full-attention cache, window
    0, at the first step at which every slot decodes past its first
    page).  ``phase`` names the run in the log."""
    from repro_torch.serving import ContinuousScheduler

    dev = params["embed"]["table"].device
    sched = ContinuousScheduler(model, params, cfg, device=dev)
    backend = sched.backend
    stores = [t.store for t in backend.tiers]
    retired, first_page = [0], {}
    for st in stores:
        def drop(key, orig=st.drop_page):
            done = orig(key)
            retired[0] += bool(done)
            return done

        def put(key, kv, *a, orig=st.put_page, **kw):
            if isinstance(key.seq_id, int):
                first_page[key.seq_id] = min(first_page.get(key.seq_id, 1 << 30), key.page_idx)
            return orig(key, kv, *a, **kw)

        st.drop_page, st.put_page = drop, put
    tier_s = [0.0]
    for name in ("on_decode_token", "tick"):
        def timed(*a, orig=getattr(backend, name), **kw):
            t = time.perf_counter()
            try:
                return orig(*a, **kw)
            finally:
                tier_s[0] += time.perf_counter() - t

        setattr(backend, name, timed)
    w = model.cfg.attn_window
    for r in reqs:
        sched.submit(r)
    for m in launch_modules():
        m.reset_launches()
    resident, window_ms, snapshot = 0, None, None
    decode = [0, 0.0, 0.0, 0.0]  # steps, wall, model, tier (s)

    def all_decoding():
        return all(s is not None and not s.prefilling for s in sched._slots)

    t0 = time.perf_counter()
    while sched.has_work():
        full = all_decoding()
        if profile_steps and window_ms is None and full and dev.type == "cuda":
            rows = device_rows(lambda: [sched.step() for _ in range(profile_steps)],
                               f"{phase}: {profile_steps} decode steps")
            window_ms = sum(e.self_device_time_total for e in rows) / profile_steps / 1e3
        else:
            ts, t_model, t_tier = time.perf_counter(), sched.stats["decode_s"], tier_s[0]
            sched.step()
            if full and all_decoding():
                decode[0] += 1
                decode[1] += time.perf_counter() - ts
                decode[2] += sched.stats["decode_s"] - t_model
                decode[3] += tier_s[0] - t_tier
        resident = max(resident, sum(st.footprint()["pages"] for st in stores))
        if snap and snapshot is None and full and int(sched._lens.max()) > w + PAGE:
            with uncounted():
                snapshot = {k: v.clone() for k, v in backend.cache.items()}
            snapshot["len"] = torch.tensor(sched._lens, device=dev)
            snapshot["tok"] = torch.tensor([s.pending for s in sched._slots], device=dev)
            snapshot["live"] = [s is not None and not s.prefilling for s in sched._slots]
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for st in stores:
        del st.drop_page, st.put_page
    del backend.on_decode_token, backend.tick
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    rep = sched.report()
    n = max(1, decode[0])
    return {"reqs": reqs, "rep": rep, "launches": launches, "sched": sched,
            "resident": resident, "retired": retired[0], "first_page": first_page,
            "encodes": dict(backend.page_encodes), "wall": wall, "decode_steps_timed": decode[0],
            "host_ms_a_step": decode[1] / n * 1e3, "model_ms_a_step": decode[2] / n * 1e3,
            "tier_ms_a_step": decode[3] / n * 1e3,
            "device_ms_a_step": window_ms, "snapshot": snapshot,
            "keeps": backend.device_keeps()}


def check_served_run(what: str, name: str, run: dict, n_layers: int) -> None:
    """A ``serve_ring`` run's common checks: every request served in full;
    on the card the fused kernel once a layer a decode step (or the rung
    kernel once a plane count, never the other), flash once a layer a
    prefill chunk, one encode a page transform and no decode, the plane
    cache packed and unpacked; device bytes equal to the controller's
    plane-scaled reads."""
    rep, launches = run["rep"], run["launches"]
    if not all(r.done and not r.truncated and len(r.output) == r.max_new_tokens
               for r in run["reqs"]):
        raise AssertionError(f"{what}: not every request completed")
    # a CPU run takes the plain versions and launches nothing
    if run["sched"].device.type == "cuda":
        per_step = n_layers * rep["decode_steps"]
        expect_launches(what, launches, {
            "paged_attention_fused": per_step if name == "fused" else 0,
            "paged_attention_rung": 0 if name == "fused" else per_step * len(run["keeps"]),
            "flash_attention": n_layers * rep["prefill_chunks"],
            "exp_delta_encode": sum(run["encodes"].values()), "exp_delta_decode": 0})
        if min(launches["bitplane_pack"], launches["bitplane_unpack"]) <= 0:
            raise AssertionError(f"{what}: the plane cache was not packed and unpacked: "
                                 f"{launches}")
    if not rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0:
        raise AssertionError(f"{what}: device_bytes_read {rep['device_bytes_read']} != "
                             f"kv_read_device_bytes {rep['kv_read_device_bytes']}")


def check_ring_run(name: str, run: dict, model) -> None:
    """A phase-7 run's checks: ``check_served_run``'s; the store's resident
    pages within stored layers x 2 streams x (window pages + a boundary
    page + the growing tail) x slots; pages retired by the window, none
    evicted."""
    rep, launches, sched = run["rep"], run["launches"], run["sched"]
    what = f"phase 7 [{name}]"
    check_served_run(what, name, run, model.cfg.n_layers)
    bound = (sched.backend.stored_layers() * 2
             * (model.cfg.attn_window // PAGE + 2) * sched.cfg.max_batch)
    if run["resident"] > bound:
        raise AssertionError(f"{what}: {run['resident']} resident pages, bound {bound}")
    if run["retired"] <= 0 or rep["kv_evictions"] != 0:
        raise AssertionError(f"{what}: {run['retired']} pages retired, "
                             f"{rep['kv_evictions']} evicted")
    dev_ms = run["device_ms_a_step"]
    busy = "" if dev_ms is None else f" (busy {dev_ms / run['host_ms_a_step']:.3f})"
    log(f"{what}: {len(run['reqs'])} requests, {rep['decode_steps']} decode steps, "
        f"{rep['prefill_chunks']} prefill chunks, launches {launches}, page transforms "
        f"{run['encodes']}; pages retired by the window {run['retired']}, resident at most "
        f"{run['resident']} (bound {bound}), evicted {rep['kv_evictions']}; first stored page "
        f"by request {run['first_page']}; a decode step (every slot decoding, "
        f"{run['decode_steps_timed']} steps): host {run['host_ms_a_step']:.2f} ms, of which the "
        f"model's decode call {run['model_ms_a_step']:.2f} ms and the memory tier "
        f"{run['tier_ms_a_step']:.2f} ms; device "
        f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} a step"
        f"{busy}; decode "
        f"{rep['decode_tok_per_s']:.1f} tok/s, prefill {rep['prefill_tokens']} tok in "
        f"{rep['prefill_s']:.3f} s, wall {run['wall']:.2f} s; device_bytes_read "
        f"{rep['device_bytes_read']} of kv_fetch_logical {rep['kv_fetch_logical']}; digest "
        f"{phase3_digest(run['reqs'], rep, True)}")


def ring_teacher_forced(torch, model, params, snap: dict, keeps) -> dict:
    """From a snapshot of a ring serving cache: one decode step through the
    fused kernel, the rung kernel and the plain attention, and one 512-token
    prefill chunk into the slot with the longest context (past the window:
    the ring chunk path) through the flash kernel and its plain version;
    each pair's logits within LOGITS_RTOL_OF_MAX of the largest."""
    from repro_torch.kernels.flash_attention import kernel as FK

    cache = {k: v for k, v in snap.items() if k not in ("tok", "live")}
    tok = snap["tok"]

    def decode(kernel):
        c = {k: v.clone() for k, v in cache.items()}
        return model.decode(params, tok, c, keeps=keeps, decode_kernel=kernel)[0]

    with uncounted():
        fused, rung = decode("fused"), decode("rung")
        with plain_attention():
            plain = decode("fused")
        slot = int(cache["len"].argmax())
        start = int(cache["len"][slot])
        gen = torch.Generator(device=tok.device).manual_seed(3)
        tokens = torch.randint(0, model.cfg.vocab, (1, 512), generator=gen, device=tok.device)

        def chunk():
            c = {k: v.clone() for k, v in cache.items()}
            return model.prefill_chunk(params, tokens, c, slot, start, 511)[0]

        FK.reset_launches()
        k_logits = chunk()
        flash = FK.LAUNCHES["flash_attention"]
        with plain_flash():
            p_logits = chunk()
    torch.cuda.synchronize()
    if flash != model.cfg.n_layers:
        raise AssertionError(f"phase 7: a ring chunk launched flash {flash} times")
    scale = float(plain.abs().max())
    out = {"decode_max_logit": scale,
           "fused_vs_plain": float((fused - plain).abs().max()),
           "rung_vs_plain": float((rung - plain).abs().max()),
           "chunk_max_logit": float(p_logits.abs().max()),
           "chunk_kernel_vs_plain": float((k_logits - p_logits).abs().max()),
           "chunk_slot": slot, "chunk_start": start}
    log(f"phase 7 teacher-forced: decode max|logit| {scale:.4f}, max|fused-plain| "
        f"{out['fused_vs_plain']:.5f}, max|rung-plain| {out['rung_vs_plain']:.5f}; a 512-token "
        f"ring chunk at {start} in slot {slot}: max|logit| {out['chunk_max_logit']:.4f}, "
        f"max|kernel-plain| {out['chunk_kernel_vs_plain']:.5f}; tolerance "
        f"{LOGITS_RTOL_OF_MAX} of max")
    if max(out["fused_vs_plain"], out["rung_vs_plain"]) > LOGITS_RTOL_OF_MAX * scale or \
            out["chunk_kernel_vs_plain"] > LOGITS_RTOL_OF_MAX * out["chunk_max_logit"]:
        raise AssertionError("phase 7: teacher-forced logits disagree with the plain versions")
    return out


def check_ring_snapshot(torch, model, snap: dict, keeps) -> None:
    """The ring glue on a snapshot of a serving cache, from the slots'
    lengths alone: every live slot's ``pos`` plane, in every layer, holds
    position p at ring slot p % window for the last min(len, window)
    positions and -1 elsewhere; its plane map reads one of ``keeps`` in
    every column and full precision in the column the next append lands
    in (a page the ring head reclaims never keeps its rung)."""
    w, live = model.cfg.attn_window, snap["live"]
    lens = [int(n) for n in snap["len"]]
    want = ring_positions(torch, snap["pos"].device, len(lens), w, lens)
    bad = [b for b in range(len(lens)) if live[b] and not bool((snap["pos"][:, b] == want[b]).all())]
    if bad:
        raise AssertionError(f"phase 7: the ring positions of slots {bad} are not those of "
                             f"their lengths {[lens[b] for b in bad]}")
    planes = snap["planes"].cpu()
    for b in (b for b in range(len(lens)) if live[b]):
        row = planes[b].tolist()
        if not set(row) <= set(keeps) or row[lens[b] % w // PAGE] != max(keeps):
            raise AssertionError(f"phase 7: slot {b} at length {lens[b]} reads plane map {row} "
                                 f"(keeps {keeps}, the head column {lens[b] % w // PAGE} at "
                                 f"full precision)")
    log(f"phase 7 snapshot: ring positions and plane maps of {sum(live)} live slots at lengths "
        f"{lens} follow their lengths")


def ring_attention_layers(torch, model, params, snap: dict, keeps,
                          phase: str = "phase 7") -> list:
    """One decode step from a ring snapshot through the fused kernel, with
    each layer's attention sub-layer (before the MoE) also run on the same
    input and a copy of that layer's cache through the rung kernel and the
    plain attention.  Returns, a layer, the largest difference of the fused
    and the rung output from the plain one over the live slots' rows, in
    bf16 steps at each row's largest magnitude; fails past
    ATTN_BF16_STEPS."""
    from repro_torch.models import transformer as T

    orig, live = T.attn_apply, torch.tensor(snap["live"], device=snap["tok"].device)
    worst = []

    def watch(p, x, cfg, *, cache=None, **kw):
        def other(kernel):
            return orig(p, x, cfg, cache=tuple(t.clone() for t in cache),
                        **{**kw, "decode_kernel": kernel})[0]

        rung = other("rung")
        with plain_attention():
            plain = other("fused")
        y, new_kv = orig(p, x, cfg, cache=cache, **kw)
        top = plain.float().abs().amax(-1)
        step = torch.exp2(torch.floor(torch.log2(top)) - 7)
        worst.append(tuple(float(((o.float() - plain.float()).abs().amax(-1) / step)[live].max())
                           for o in (y, rung)))
        return y, new_kv

    cache = {k: v.clone() for k, v in snap.items() if k not in ("tok", "live")}
    T.attn_apply = watch
    try:
        with uncounted():
            model.decode(params, snap["tok"], cache, keeps=keeps, decode_kernel="fused")
    finally:
        T.attn_apply = orig
    log(f"{phase} attention sub-layers: max|fused-plain|, max|rung-plain| a layer in bf16 "
        f"steps at the row's largest magnitude {[(round(f, 3), round(r, 3)) for f, r in worst]}; "
        f"tolerance {ATTN_BF16_STEPS}")
    if len(worst) != model.cfg.n_layers or max(max(w) for w in worst) > ATTN_BF16_STEPS:
        raise AssertionError(f"{phase}: an attention sub-layer disagrees with the plain attention")
    return worst


def mixtral_model(torch, dev, layers: int = MIXTRAL_LAYERS, smoke: bool = False,
                  window: int | None = None):
    """Mixtral-8x7B at full width (or SMOKE) cut to ``layers`` layers, with
    random weights from a seeded generator on ``dev``.  SMOKE takes the
    FULL window unless ``window`` is given, so that phase 7's trace runs
    the card's control flow at the smoke width."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = get_config("mixtral-8x7b", smoke=smoke)
    if smoke or window is not None:
        cfg = dataclasses.replace(cfg, attn_window=window or get_config("mixtral-8x7b").attn_window)
    cfg = dataclasses.replace(cfg, n_layers=layers)
    model = build_model(cfg)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def run_ring_phase(torch, model, params, profile_steps: int = RING_WINDOW_STEPS,
                   prompts=MIXTRAL_PROMPTS, new: int = MIXTRAL_NEW,
                   max_batch: int = MIXTRAL_BATCH, max_ctx: int = MIXTRAL_CTX) -> dict:
    """Phase 7: the Mixtral trace (``prompts``, ``new`` tokens each)
    through the ring, fused then rung, each run checked
    (``check_ring_run``); the two runs' token agreement; on the fused
    run's snapshot the ring glue (``check_ring_snapshot``) and each layer's
    attention sub-layer (``ring_attention_layers``), and on the card the
    teacher-forced logits."""
    runs = {}
    for kernel in ("fused", "rung"):
        reqs = mixtral_requests(model.cfg.vocab, prompts, new)
        runs[kernel] = serve_ring(torch, model, params, ring_config(kernel, max_batch, max_ctx),
                                  reqs, profile_steps=profile_steps, snap=kernel == "fused")
        check_ring_run(kernel, runs[kernel], model)
    w = model.cfg.attn_window
    cross = sum(p <= w < p + new for p in prompts)
    beyond = sum(p > w for p in prompts)
    same = sum(a == b for fr, rr in zip(runs["fused"]["reqs"], runs["rung"]["reqs"])
               for a, b in zip(fr.output, rr.output))
    total = sum(len(r.output) for r in runs["fused"]["reqs"])
    log(f"phase 7: window {w}; {cross} prompts cross it while decoding, {beyond} start beyond "
        f"it; fused and rung runs agree on {same}/{total} greedy tokens")
    snap, keeps = runs["fused"]["snapshot"], runs["fused"]["keeps"]
    if snap is None:
        raise AssertionError("phase 7: no step had every slot decoding past the window")
    check_ring_snapshot(torch, model, snap, keeps)
    layers = ring_attention_layers(torch, model, params, snap, keeps)
    forced = None
    if params["embed"]["table"].is_cuda:
        forced = ring_teacher_forced(torch, model, params, snap, keeps)
    for run in runs.values():  # the scheduler holds the model and its cache
        run["snapshot"] = run["sched"] = None
    return {"runs": runs, "forced": forced, "layers": layers, "agree": (same, total)}


def ring_counts_on_cpu() -> dict:
    """Phase 7's trace on this host's CPU at the smoke width with the FULL
    window (control flow and counts do not follow the width, except where
    the lane budget meets a page's bytes): the predictions a card run is
    held to.  ``PYTHONPATH=src python3 -c "import chip_smoke as C;
    C.ring_counts_on_cpu()"`` (a few minutes)."""
    import torch

    model, params = mixtral_model(torch, torch.device("cpu"), layers=2, smoke=True)
    return run_ring_phase(torch, model, params, profile_steps=0)


def ring_positions(torch, dev, b: int, w: int, ends) -> "torch.Tensor":
    """(b, w) int32 positions of rings of w slots after ``ends`` tokens: slot
    p % w holds position p for the last min(end, w) positions, -1 where
    nothing was written."""
    pos = torch.full((b, w), -1, dtype=torch.int32, device=dev)
    for i, end in enumerate(ends):
        p = torch.arange(max(0, end - w), end, device=dev, dtype=torch.int32)
        pos[i, p.long() % w] = p
    return pos


def dominant_key_rows(position: int, chunk: int = RING_DOMINANT_CHUNK, w: int = 4096,
                      start: int = 4096 + 2000) -> int:
    """Queries of a ring chunk at start .. start + chunk - 1 (causal, window
    w) that may see a key at ``position``."""
    return sum(q - w < position <= q for q in range(start, start + chunk))


def check_ring_dominant_keys(torch, dev) -> list:
    """Phase 6's RING_DOMINANT cases: the flash kernel with key positions
    against the plain version within FLASH_BF16_STEPS at each row's largest
    magnitude, where one key dominates the rows that see it; the plain
    rows that see it must be its value (the case tests what it names).
    Launches here are left out of the counts."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    hp, hkv, hd, w, c = 32, 8, 128, 4096, RING_DOMINANT_CHUNK
    start = w + 2000
    gen = torch.Generator(device=dev).manual_seed(13)
    ring = ring_positions(torch, dev, 1, w, (start,))
    q_pos = (start + torch.arange(c, device=dev, dtype=torch.int32))[None].contiguous()
    kv_pos = torch.cat([ring, q_pos], dim=1).contiguous()
    kv_valid = torch.full((1,), start + c, dtype=torch.int32, device=dev)
    u = torch.ones(hd, device=dev)
    out = []
    for case, position in RING_DOMINANT:
        slot = position % w
        if int(ring[0, slot]) != position:
            raise AssertionError(f"phase 6: ring slot {slot} holds {int(ring[0, slot])}")
        q = (torch.randn((1, c, hp, hd), generator=gen, device=dev) + 2 * u).to(torch.bfloat16)
        k = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev)
        v = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev)
        k[0, slot] = 2 * u
        v[0, slot] = 4.0
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        with uncounted():
            got = FK.flash_attention(q, k, v, q_pos, kv_valid, causal=True, window=w,
                                     kv_pos=kv_pos)
            want = FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid, window=w,
                                          kv_pos=kv_pos)
            torch.cuda.synchronize()
        seen = (q_pos[0] - w < position) & (position <= q_pos[0])
        rows = int(seen.sum())
        steps = row_bf16_steps(got, want)
        err = float((got.float() - want.float()).abs().max())
        dominated = bool(((want[0, seen].float() - 4.0).abs() < 0.05).all()) if rows else True
        log(f"phase 6: ring chunk of {c} with a dominant key {case} (position {position}, slot "
            f"{slot}, seen by {rows} of {c} queries): {steps:.2f} bf16 steps from plain "
            f"(tolerance {FLASH_BF16_STEPS}), max abs err {err:.3g}")
        if rows != dominant_key_rows(position, c, w, start) or not dominated:
            raise AssertionError(f"phase 6: the dominant-key case {case} does not dominate "
                                 f"its {rows} rows")
        if not (torch.isfinite(got.float()).all() and steps <= FLASH_BF16_STEPS):
            raise AssertionError(f"phase 6: ring flash with a dominant key {case}: {steps:.2f} "
                                 f"bf16 steps from the plain version")
        out.append({"case": case, "position": position, "slot": slot, "rows_seeing": rows,
                    "bf16_steps": steps, "max_abs_err": err})
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return out


def time_ring_flash(torch, dev) -> list:
    """The flash kernel with key positions at the ring chunk (RING_CHUNKS):
    C queries over [a full 4,096-slot ring] ++ [the chunk], Mixtral's heads,
    window 4,096; and the same over a ring of which 3,000 slots were
    written (the rest -1).  Each held to the plain version within
    FLASH_BF16_STEPS at each row's largest magnitude, then timed (events,
    device), beside the plain version, the bound (bytes or operations over
    the pairs the masks leave visible) and
    ``scaled_dot_product_attention`` with the same boolean mask
    (``enable_gqa``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    hp, hkv, hd, w = 32, 8, 128, 4096
    gen = torch.Generator(device=dev).manual_seed(11)
    rows = []
    for c in RING_CHUNKS:
        for filled in (w + 2000, 3000):
            ring = ring_positions(torch, dev, 1, w, (filled,))
            start = filled
            q_pos = (start + torch.arange(c, device=dev, dtype=torch.int32))[None].contiguous()
            kv_pos = torch.cat([ring, q_pos], dim=1).contiguous()
            kv_valid = torch.full((1,), start + c, dtype=torch.int32, device=dev)
            q = torch.randn((1, c, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
            k = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
            v = torch.randn((1, w + c, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
            run = lambda i: FK.flash_attention(q, k, v, q_pos, kv_valid, causal=True,  # noqa: E731
                                               window=w, kv_pos=kv_pos)
            plain = lambda i: FR.flash_attention_ref(  # noqa: E731
                q, k, v, q_pos=q_pos, kv_valid=kv_valid, window=w, kv_pos=kv_pos)
            with uncounted():
                got, want = run(0), plain(0)
                torch.cuda.synchronize()
                steps = row_bf16_steps(got, want)
                if steps > FLASH_BF16_STEPS:
                    raise AssertionError(f"phase 6: ring flash C={c} filled {filled}: "
                                         f"{steps:.2f} bf16 steps from the plain version")
                err = float((got.float() - want.float()).abs().max())
                ok = ((kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] < kv_valid[:, None, None])
                      & (kv_pos[:, None, :] <= q_pos[:, :, None])
                      & (kv_pos[:, None, :] > q_pos[:, :, None] - w))
                pairs = int(ok.sum())
                flops = 4 * hd * hp * pairs
                nbytes = 2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * (
                    q_pos.numel() + kv_pos.numel())
                b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                mask = ok[:, None]
                lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                    qt, kt, vt, attn_mask=mask, enable_gqa=True)
                per_call = kernels_per_call(run, "flash_attention_")
                k_ms = cuda_time_ms(run, iters=10)
                k_dev = device_ms(run, "flash_attention_", 10, per_call)
                p_ms = cuda_time_ms(plain, iters=3)
                lib_ms, lib_dev = cuda_time_ms(lib, iters=10), device_ms(lib, "", 10)
            rows.append({"chunk": c, "ring_filled": min(filled, w), "keys": w + c,
                         "heads": [hp, hkv, hd], "window": w,
                         "plan": FK.plan(1, c, w + c, hp, hkv, hd),
                         "max_abs_err": err, "bf16_steps": steps, "ms": k_ms, "device_ms": k_dev,
                         "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_flops": flops,
                         "bound_bytes": nbytes, "bound_share": b_ms / k_dev,
                         "library_ms": lib_ms, "library_device_ms": lib_dev,
                         "over_library": k_dev / lib_dev})
            log(f"phase 6: flash_attention with kv_pos, a ring chunk of {c} over {w} slots "
                f"({min(filled, w)} written) + itself, 32/8 heads of 128, window {w}: {k_ms:.4f} / "
                f"{k_dev:.4f} ms (events / device, {per_call} kernels a call); {steps:.2f} bf16 "
                f"steps from plain; bound {b_ms:.4f} ms by {b_by} ({pairs} visible pairs, "
                f"{flops} operations, {nbytes} B), {b_ms / k_dev:.3f} of it; plain {p_ms:.4f} ms; "
                f"scaled_dot_product_attention with the mask {lib_ms:.4f} / {lib_dev:.4f} ms "
                f"(kernel / sdpa by device {k_dev / lib_dev:.3f})")
            del q, k, v, qt, kt, vt, mask, ok
    torch.cuda.empty_cache()
    return rows


def time_ring_paged(torch, dev) -> dict:
    """The fused paged kernel over a ring's mask (RING_PAGED, RING_LENS,
    window 4,096, keeps drawn from {8, 12, 16}): the mask
    ``batched_ladder_paged_attention`` folds from the ring's positions, the
    call held to the plain version (KERNEL_ATOL / RTOL), then timed (events,
    device) beside the plain version, its byte bound and SDPA with the
    same boolean mask over the dense bf16 ring."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ref as R
    from repro_torch.kernels.paged_attention.ref import pack_kv_ref

    b, s, hkv, rep, hd = RING_PAGED
    w = s
    gen = torch.Generator(device=dev).manual_seed(13)
    q = torch.randn((b, hkv, rep, hd), generator=gen, device=dev).to(torch.bfloat16)
    k = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(torch.bfloat16)
    kp, vp = pack_kv_ref(k), pack_kv_ref(v)
    lens = torch.tensor(RING_LENS, dtype=torch.int32, device=dev)
    kv_pos = ring_positions(torch, dev, b, w, [n + 1 for n in RING_LENS])
    choice = torch.tensor((8, 12, 16), dtype=torch.int32, device=dev)
    keeps = choice[torch.randint(0, 3, (b, s // PAGE), generator=gen, device=dev)].contiguous()
    q_pos = lens[:, None]
    ok = (kv_pos >= 0) & (kv_pos < (lens + 1)[:, None]) & (kv_pos <= q_pos) & \
        (kv_pos > q_pos - w)
    mask = (ok & (keeps.repeat_interleave(PAGE, dim=1) > 0)).to(torch.int8).contiguous()
    run = lambda i: K.paged_attention_fused(q, kp, vp, keeps, mask)  # noqa: E731
    plain = lambda i: R.paged_attention_fused_ref(q, kp, vp, keeps, mask)  # noqa: E731
    with uncounted():
        got, want = run(0), plain(0)
        torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
        err = float((got - want).abs().max())
        plan = K.plan(b, s, hkv, rep, hd)
        per_call = 2 if plan["splits"] > 1 else 1
        k_ms = cuda_time_ms(run, iters=40)
        k_dev = device_ms(run, "paged_attention_", 40, per_call)
        p_ms = cuda_time_ms(plain, iters=5)
        nbytes = kernel_bytes(keeps, mask, hkv, hd // 8) + q.numel() * 2 + mask.numel() + \
            keeps.numel() * 4 + b * hkv * rep * hd * 4
        b_ms = nbytes / HBM_BYTES_PER_S * 1e3
        qd = q.reshape(b, hkv * rep, 1, hd)
        kd, vd = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        bmask = ok[:, None, None, :]
        lib = lambda i: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=bmask,  # noqa: E731
                                                       enable_gqa=True)
        lib_ms, lib_dev = cuda_time_ms(lib, iters=40), device_ms(lib, "", 40)
    out = {"shape": list(RING_PAGED), "lens": list(RING_LENS), "window": w, "plan": plan,
           "max_abs_err": err, "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms,
           "bytes": nbytes, "bound_ms": b_ms, "bound_by": "bytes", "bound_share": b_ms / k_dev,
           "library_ms": lib_ms, "library_device_ms": lib_dev, "over_library": k_dev / lib_dev}
    log(f"phase 6: paged_attention_fused over a ring mask, B S Hkv rep hd = {RING_PAGED}, "
        f"lengths {RING_LENS}, window {w}, keeps {{8, 12, 16}}: {k_ms:.4f} / {k_dev:.4f} ms "
        f"(events / device); max abs err {err:.3g}; {nbytes} B, byte bound {b_ms:.5f} ms, "
        f"{b_ms / k_dev:.3f} of it; plain {p_ms:.4f} ms; sdpa with the mask over dense bf16 "
        f"{lib_ms:.4f} / {lib_dev:.4f} ms")
    del k, v, kp, vp, kd, vd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 8: the remaining model families at full width
# ---------------------------------------------------------------------------

# 8a, 8b: the served families at full width and depth (arch, requests,
# prompt tokens from, to), each request greedy with FAMILY_NEW new tokens,
# on phase 3's ladder in four slots of a 2,048-token context
FAMILY_RUNS = (("deepseek-moe-16b", 8, 256, 1536), ("nemotron-4-15b", 6, 256, 1024))
FAMILY_NEW, FAMILY_BATCH, FAMILY_CTX = 32, 4, 2048
# layers written through the compressed store, as phase 7's: every decode
# step queues a fetch job a stored page and stream; at 4 (the default) the
# memory tier took 137-139 ms of a DeepSeek decode step's 240-269 ms of
# host time (NVIDIA H100 80GB HBM3, 700 W; PERF.md §6)
FAMILY_STORE_LAYERS = 1
# 8c: LLaVA-NeXT-34B, B 2 x (2,880 patches + 1,024 text tokens), the cache
# padded to 4,096 and 32 greedy decode steps; all 60 layers when at least
# VLM_FREE_GIB stay free after init, else the deepest multiple of 4 that
# leaves it
VLM_B, VLM_TEXT, VLM_CTX, VLM_STEPS, VLM_FREE_GIB = 2, 1024, 4096, 32, 6
# 8d: Whisper-tiny, B 8 x 1,500 frames and a 224-token decoder prompt, then
# 64 greedy decode steps
WHISPER_B, WHISPER_TEXT, WHISPER_STEPS = 8, 224, 64
# Phase 6's rows of the new shapes: flash (b, sq, skv, hp, hkv, hd, start,
# kv_valid, causal) at a 1,024-token prefill chunk of Nemotron-4 (rep 6)
# and DeepSeek (rep 1), LLaVA's whole prefill (64 q heads, 8 of them zero
# padding), Whisper's encoder (bidirectional over 1,500 frames) and its
# decoder's cross attention (224 queries over 1,500 frames); paged (B, S,
# Hkv, rep, hd) at 8a's and 8b's decode, four slots of 2,048 tokens
FLASH_PHASE8 = (
    ("nemotron-4-15b chunk", (1, 1024, FAMILY_CTX, 48, 8, 128, 0, 1024, True)),
    ("deepseek-moe-16b chunk", (1, 1024, FAMILY_CTX, 16, 16, 128, 0, 1024, True)),
    ("llava-next-34b prefill", (VLM_B, 3904, 3904, 64, 8, 128, 0, 3904, True)),
    ("whisper-tiny encoder", (WHISPER_B, 1500, 1500, 6, 6, 64, 0, 1500, False)),
    ("whisper-tiny cross", (WHISPER_B, WHISPER_TEXT, 1500, 6, 6, 64, 0, 1500, False)),
)
PAGED_PHASE8 = (("deepseek-moe-16b", (FAMILY_BATCH, FAMILY_CTX, 16, 1, 128)),
                ("nemotron-4-15b", (FAMILY_BATCH, FAMILY_CTX, 8, 6, 128)))
# (the last row with nothing valid, which must come out exactly 0)
PAGED_PHASE8_LENS = (1800, 700, 2048, 0)


def family_requests(vocab: int, n: int, lo: int, hi: int, new: int = FAMILY_NEW) -> list:
    import numpy as np

    from repro_torch.serving import Request

    rng = np.random.default_rng(8)
    # the lengths first: they set every count, and do not follow the vocab
    lens = rng.integers(lo, hi + 1, n)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(m)).astype(np.int32),
                    max_new_tokens=new) for i, m in enumerate(lens)]


def family_config(kernel: str, max_batch: int = FAMILY_BATCH, max_ctx: int = FAMILY_CTX):
    """Phase 3's ladder on the paged backend with bit-plane device KV, one
    stored layer (FAMILY_STORE_LAYERS), the lane engine unbounded: a
    full-width page is 64 KiB (DeepSeek) or 32 KiB (Nemotron) a stream a
    layer, and phase 3's 4 MiB window a step would defer pages until
    ``retire`` cancelled them."""
    from repro_torch.core.quantization import PrecisionLadder
    from repro_torch.memctl import MemCtlConfig
    from repro_torch.serving import EngineConfig

    return EngineConfig(max_batch=max_batch, max_ctx=max_ctx, ladder=PrecisionLadder(LADDER),
                        codec="lz4", device_kv="bitplane", decode_kernel=kernel,
                        backend="paged", store_layers=FAMILY_STORE_LAYERS,
                        engine=MemCtlConfig(step_cycles=None))


def family_model(torch, dev, arch: str, smoke: bool = False, **change):
    """``arch`` (FULL, or SMOKE) with random weights from a generator seeded
    0 on ``dev``; ``change`` replaces config fields (the CPU tests' cuts)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch, smoke=smoke), **change)
    model = build_model(cfg)
    return model, model.init(torch.Generator(device=dev).manual_seed(0))


def check_family_run(name: str, run: dict, model, phase: str) -> None:
    """An 8a/8b run's checks (``check_served_run``'s), and its KV bytes a
    token printed."""
    rep, launches = run["rep"], run["launches"]
    what = f"{phase} [{name}]"
    check_served_run(what, name, run, model.cfg.n_layers)
    tokens = rep["prefill_tokens"] + rep["decode_tokens"]
    run["bytes_a_token"] = {"kv_logical": rep["kv_logical_bytes"] / tokens,
                            "kv_stored": rep["kv_stored_bytes"] / tokens,
                            "device_read_a_decode_token":
                                rep["device_bytes_read"] / rep["decode_tokens"]}
    dev_ms = run["device_ms_a_step"]
    log(f"{what}: {len(run['reqs'])} requests, {rep['decode_steps']} decode steps, "
        f"{rep['prefill_chunks']} prefill chunks, launches {launches}, page transforms "
        f"{run['encodes']}; a decode step (every slot decoding, {run['decode_steps_timed']} "
        f"steps): host {run['host_ms_a_step']:.2f} ms, of which the model's decode call "
        f"{run['model_ms_a_step']:.2f} ms and the memory tier {run['tier_ms_a_step']:.2f} ms; "
        f"device {'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'} a step; decode "
        f"{rep['decode_tok_per_s']:.1f} tok/s, prefill {rep['prefill_tokens']} tok in "
        f"{rep['prefill_s']:.3f} s, wall {run['wall']:.2f} s; KV bytes a token: logical "
        f"{run['bytes_a_token']['kv_logical']:.1f}, stored {run['bytes_a_token']['kv_stored']:.1f}, "
        f"device read a decode token {run['bytes_a_token']['device_read_a_decode_token']:.1f}; "
        f"device_bytes_read {rep['device_bytes_read']} of kv_fetch_logical "
        f"{rep['kv_fetch_logical']}; digest {phase3_digest(run['reqs'], rep, True)}")


def run_family_phase(torch, model, params, n: int, lo: int, hi: int, phase: str,
                     new: int = FAMILY_NEW, profile_steps: int = RING_WINDOW_STEPS,
                     max_batch: int = FAMILY_BATCH, max_ctx: int = FAMILY_CTX) -> dict:
    """8a or 8b: ``n`` requests of ``lo`` to ``hi`` prompt tokens through
    the paged backend, fused then rung (``serve_ring``'s run: launch counts
    reset before and read after, host and device ms a decode step), each
    run checked (``check_family_run``); on the fused run's snapshot each
    layer's attention sub-layer fused and rung against the plain one
    (``ring_attention_layers``) and, on the card, a teacher-forced decode
    step (``teacher_forced``; an MoE model's with its routes pinned to the
    plain run's, ``moe_teacher_forced``)."""
    runs = {}
    for kernel in ("fused", "rung"):
        reqs = family_requests(model.cfg.vocab, n, lo, hi, new)
        runs[kernel] = serve_ring(torch, model, params, family_config(kernel, max_batch, max_ctx),
                                  reqs, profile_steps=profile_steps, snap=kernel == "fused",
                                  phase=phase)
        check_family_run(kernel, runs[kernel], model, phase)
    same = sum(a == b for fr, rr in zip(runs["fused"]["reqs"], runs["rung"]["reqs"])
               for a, b in zip(fr.output, rr.output))
    total = sum(len(r.output) for r in runs["fused"]["reqs"])
    log(f"{phase}: fused and rung runs agree on {same}/{total} greedy tokens")
    snap, keeps = runs["fused"]["snapshot"], runs["fused"]["keeps"]
    if snap is None:
        raise AssertionError(f"{phase}: no step had every slot decoding")
    layers = ring_attention_layers(torch, model, params, snap, keeps, phase)
    forced = None
    if params["embed"]["table"].is_cuda:
        cache = {k: v for k, v in snap.items() if k not in ("tok", "live")}
        with uncounted():
            if model.cfg.family == "moe":
                forced = moe_teacher_forced(torch, model, params, cache, snap["tok"], keeps,
                                            phase)
            else:
                forced = teacher_forced(torch, model, params, cache, snap["tok"], keeps, phase)
    for run in runs.values():  # the scheduler holds the model and its cache
        run["snapshot"] = run["sched"] = None
    return {"runs": runs, "forced": forced, "layers": layers, "agree": (same, total)}


@contextlib.contextmanager
def pinned_routes(torch, routes: list, record: bool):
    """While inside, every MoE layer routes each token to the experts of
    ``routes`` (one (B, S, k) entry a layer call, in call order), its gates
    the layer's own probabilities at them; with ``record``, the layer's own
    top-k is appended there first.  Only the choice is replaced
    (``moe.top_k_routes``): the rest is ``moe_apply``'s arithmetic.  A
    teacher-forced step through the kernels and through the plain
    attention then takes the same routes: with random weights and 64
    experts a top-6 boundary is often within a bf16 step, so one rounding
    of the attention flips an expert and moves the token's output by the
    order of itself."""
    from repro_torch.models import moe as M

    orig, calls = M.top_k_routes, [0]

    def pinned(probs, k):
        if record:
            routes.append(orig(probs, k)[1])
        expert = routes[calls[0]]
        calls[0] += 1
        return probs.gather(-1, expert), expert

    M.top_k_routes = pinned
    try:
        yield
    finally:
        M.top_k_routes = orig


def moe_teacher_forced(torch, model, params, cache, tok, keeps, phase: str) -> dict:
    """``teacher_forced`` for an MoE model, its decode step's routes pinned
    to the plain run's (``pinned_routes``) and held; the same step with
    each run routing for itself is printed beside it, not held (a flipped
    expert moves it)."""
    def run(kernel, plain=False, pin=True, record=False):
        c = {k: v.clone() for k, v in cache.items()}
        with contextlib.ExitStack() as stack:
            if plain:
                stack.enter_context(plain_attention())
            if pin:
                stack.enter_context(pinned_routes(torch, routes, record))
            return model.decode(params, tok, c, keeps=keeps, decode_kernel=kernel)[0]

    def diffs(plain, fused, rung):
        return (float(plain.abs().max()), float((fused - plain).abs().max()),
                float((rung - plain).abs().max()))

    routes = []
    plain = run("fused", plain=True, record=True)
    scale, d_fp, d_rp = diffs(plain, run("fused"), run("rung"))
    free = diffs(run("fused", plain=True, pin=False), run("fused", pin=False),
                 run("rung", pin=False))
    torch.cuda.synchronize()
    tol = LOGITS_RTOL_OF_MAX * scale
    log(f"{phase} teacher-forced, routes pinned to the plain run's: max|logit| {scale:.4f}, "
        f"max|fused-plain| {d_fp:.5f}, max|rung-plain| {d_rp:.5f}, tolerance {tol:.5f}; "
        f"each run routing for itself (not held): max|logit| {free[0]:.4f}, max|fused-plain| "
        f"{free[1]:.5f}, max|rung-plain| {free[2]:.5f}")
    if not (d_fp <= tol and d_rp <= tol):
        raise AssertionError(f"{phase}: teacher-forced logits disagree across fused/rung/plain")
    return {"max_logit": scale, "fused_vs_plain": d_fp, "rung_vs_plain": d_rp,
            "routes_pinned": True, "unpinned": {"max_logit": free[0], "fused_vs_plain": free[1],
                                                "rung_vs_plain": free[2]}}


@contextlib.contextmanager
def attention_watch(torch, module, name: str, worst: list, live=None):
    """While inside, every call of ``module.name`` (an attention sub-layer
    returning (y, kv)) also runs on the same inputs with the flash kernel
    replaced by its plain version, and appends the largest difference of
    the kernel's y from the plain one in bf16 steps at each row's largest
    magnitude to ``worst``.  The plain call is not counted."""
    orig = getattr(module, name)

    def watch(*a, **kw):
        with uncounted(), plain_flash():
            plain, _ = orig(*a, **kw)
        y, kv = orig(*a, **kw)
        worst.append(row_bf16_steps(y, plain))
        return y, kv

    setattr(module, name, watch)
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def padded_heads_watch(torch, cfg, seen: list):
    """While inside, every masked attention output (``mask_padded_heads``)
    of a config with padded q heads is checked: the padded heads exactly
    zero, the real ones not all zero; ``seen`` counts the calls checked."""
    import numpy as np

    from repro_torch.models import attention as A

    orig = A.mask_padded_heads
    valid = torch.as_tensor(np.asarray(A.valid_q_heads(cfg.n_q_heads_padded, cfg.n_heads,
                                                       cfg.n_kv_heads)))

    def watch(out, c):
        y = orig(out, c)
        if c.n_q_heads_padded == c.n_heads:
            return y
        pad, real = y[:, :, ~valid.to(y.device)], y[:, :, valid.to(y.device)]
        if bool((pad != 0).any()) or not bool((real != 0).any()):
            raise AssertionError(f"padded q heads {int((~valid).sum())}: not exactly zero "
                                 f"before wo, or the real heads all zero")
        seen.append(int((~valid).sum()))
        return y

    A.mask_padded_heads = watch
    try:
        yield
    finally:
        A.mask_padded_heads = orig


def timed_prefill(torch, step, params, batch, phase: str) -> dict:
    """One prefill step timed on the host (synchronised), then one in a
    profiler window: the device time and the flash kernel's share of it.
    Launch counts are read over the timed step."""
    dev = params["embed"]["table"].device
    for m in launch_modules():
        m.reset_launches()
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    tok, cache = step(params, batch)
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    out = {"tok": tok, "cache": cache, "host_ms": host_ms, "launches": launches,
           "device_ms": None, "flash_share": None}
    if dev.type == "cuda":
        with uncounted():
            rows = device_rows(lambda: step(params, batch), f"{phase}: one prefill",
                                  repeatable=True)
        busy = sum(e.self_device_time_total for e in rows) / 1e3
        flash = sum(e.self_device_time_total for e in rows if "flash_attention_" in e.key) / 1e3
        out.update(device_ms=busy, flash_share=flash / busy)
    return out


def timed_decode(torch, step, params, tok, cache, steps: int, phase: str,
                 window: int = 4) -> dict:
    """``steps`` greedy decode steps, host ms a step over them; then, on the
    card, a profiler window over ``window`` more steps on a copy of the
    cache (device ms a step).  Returns the tokens, the cache, the times and
    the launches of the timed steps."""
    dev = tok.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for m in launch_modules():
        m.reset_launches()
    sync()
    t0 = time.perf_counter()
    toks = []
    for _ in range(steps):
        tok, cache = step(params, tok, cache)
        toks.append(tok)
    sync()
    host_ms = (time.perf_counter() - t0) * 1e3 / steps
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    dev_ms = None
    if dev.type == "cuda":
        def more():
            c, t = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in cache.items()}, tok
            for _ in range(window):
                t, c = step(params, t, c)

        with uncounted():
            rows = device_rows(more, f"{phase}: {window} decode steps", repeatable=True)
        dev_ms = sum(e.self_device_time_total for e in rows) / 1e3 / window
    return {"tokens": torch.stack(toks, 1), "cache": cache, "host_ms": host_ms,
            "device_ms": dev_ms, "launches": launches}


def consistency(torch, model, params, batch: dict, logits, max_len: int, phase: str,
                text: str = "tokens") -> float:
    """The reference's prefill/decode consistency check: decode(prefill(
    prompt[:-1]), last token) against prefill(prompt)'s ``logits``, within
    LOGITS_RTOL_OF_MAX of the largest.  Returns max |difference|."""
    from repro_torch.models.model import prepare_decode_cache

    short = dict(batch, **{text: batch[text][:, :-1]})
    with uncounted():
        _, cache = model.prefill(params, short)
        cache = prepare_decode_cache(model.cfg, cache, max_len)
        got, _ = model.decode(params, batch[text][:, -1].long(), cache)
    scale = float(logits.abs().max())
    diff = float((got - logits).abs().max())
    log(f"{phase} prefill/decode consistency: max|decode-prefill| {diff:.5f}, max|logit| "
        f"{scale:.4f}, tolerance {LOGITS_RTOL_OF_MAX} of max")
    if diff > LOGITS_RTOL_OF_MAX * scale:
        raise AssertionError(f"{phase}: decode after prefill disagrees with prefill")
    return diff


def run_vlm_phase(torch, dev, smoke: bool = False, b: int = VLM_B, text: int = VLM_TEXT,
                  max_len: int = VLM_CTX, steps: int = VLM_STEPS, phase: str = "phase 8c",
                  **change) -> dict:
    """8c: LLaVA-NeXT-34B at full width through ``make_prefill_step`` on B
    ``b`` x (its patches, seeded N(0, 1) bf16, and ``text`` tokens), each
    layer's attention sub-layer held to the plain flash within
    FLASH_BF16_STEPS a row and its padded q heads exactly zero before
    ``wo``; ``prepare_decode_cache`` to ``max_len`` and ``steps`` greedy
    ``make_serve_step`` steps; the prefill/decode consistency check."""
    from repro_torch.configs import get_config
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import transformer as T
    from repro_torch.models.frontends import fake_patches
    from repro_torch.models.model import prepare_decode_cache

    full = get_config("llava-next-34b", smoke=smoke)
    # all of its layers where VLM_FREE_GIB stay free after init, else 4
    # fewer at a time until they do
    depth = change.pop("n_layers", None) or full.n_layers
    while True:
        model, params = family_model(torch, dev, "llava-next-34b", smoke, n_layers=depth,
                                     **change)
        free = torch.cuda.mem_get_info()[0] / 2**30 if dev.type == "cuda" else None
        if free is None or free >= VLM_FREE_GIB or depth <= 4:
            break
        log(f"{phase}: {free:.2f} GiB free after init at {depth} layers; 4 fewer")
        del model, params
        torch.cuda.empty_cache()
        depth -= 4
    cfg = model.cfg
    log(f"{phase}: {cfg.name} at width {cfg.d_model}, {cfg.n_heads} q heads padded to "
        f"{cfg.n_q_heads_padded}, {cfg.n_kv_heads} kv heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
        f"{cfg.n_patches} patches, vocab {cfg.vocab}; depth {cfg.n_layers} of {full.n_layers}"
        f"{'' if free is None else f' ({free:.2f} GiB free after init)'}")
    gen = torch.Generator(device=dev).manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, text), generator=gen, device=dev),
             "patches": fake_patches(gen, cfg, b)}
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    pre = timed_prefill(torch, prefill, params, batch, phase)
    n_pos = cfg.n_patches + text
    if pre["cache"]["k"].shape[2] != n_pos or int(pre["cache"]["len"]) != n_pos:
        raise AssertionError(f"{phase}: prefill cache of {pre['cache']['k'].shape[2]} rows")
    worst, padded = [], []
    with attention_watch(torch, T, "attn_apply", worst), padded_heads_watch(torch, cfg, padded):
        with uncounted():
            logits, _ = model.prefill(params, batch)
    log(f"{phase} attention sub-layers, flash against plain (bf16 steps at the row's largest "
        f"magnitude, a layer): {[round(w, 3) for w in worst]}; tolerance {FLASH_BF16_STEPS}; "
        f"padded q heads exactly zero before wo in {len(padded) // 2} layers")
    # each layer masks twice: the kernel's call and the plain one
    if len(worst) != cfg.n_layers or max(worst) > FLASH_BF16_STEPS or \
            len(padded) != 2 * cfg.n_layers * (cfg.n_q_heads_padded != cfg.n_heads):
        raise AssertionError(f"{phase}: an attention sub-layer disagrees with the plain one")
    cache = prepare_decode_cache(cfg, pre["cache"], max_len)
    del pre["cache"]
    dec = timed_decode(torch, serve, params, pre["tok"], cache, steps, phase)
    del cache, dec["cache"]
    cons = consistency(torch, model, params, batch, logits, max_len, phase)
    if dev.type == "cuda":  # a CPU run takes the plain versions and launches nothing
        expect_launches(f"{phase} prefill", pre["launches"], {"flash_attention": cfg.n_layers})
        expect_launches(f"{phase} decode", dec["launches"], {"flash_attention": 0})
    log(f"{phase}: prefill B {b} x {n_pos} positions: host {pre['host_ms']:.2f} ms, device "
        f"{'not measured' if pre['device_ms'] is None else f'{pre['device_ms']:.2f} ms'}, flash "
        f"{'not measured' if pre['flash_share'] is None else f'{pre['flash_share']:.3f}'} of the "
        f"device time; decode {dec['host_ms']:.2f} ms a step (host), "
        f"{'not measured' if dec['device_ms'] is None else f'{dec['device_ms']:.3f} ms'} (device); "
        f"launches prefill {pre['launches']}, decode {dec['launches']}")
    out = {"layers": cfg.n_layers, "prefill_ms": pre["host_ms"],
           "prefill_device_ms": pre["device_ms"], "flash_share": pre["flash_share"],
           "decode_ms": dec["host_ms"], "decode_device_ms": dec["device_ms"],
           "attn_steps": max(worst), "consistency": cons,
           "launches": {k: pre["launches"][k] + dec["launches"][k] for k in pre["launches"]}}
    del model, params
    return out


def run_whisper_phase(torch, dev, smoke: bool = False, b: int = WHISPER_B,
                      text: int = WHISPER_TEXT, steps: int = WHISPER_STEPS,
                      phase: str = "phase 8d", **change) -> dict:
    """8d: Whisper-tiny through ``make_prefill_step`` on B ``b`` x (1,500
    seeded N(0, 1) bf16 frames and ``text`` decoder tokens), each attention
    sub-layer of the prefill (encoder self, decoder self and cross) held to
    the plain flash within FLASH_BF16_STEPS a row; the cache padded and
    ``steps`` greedy ``make_serve_step`` steps; the consistency check."""
    from repro_torch.launch import make_prefill_step, make_serve_step
    from repro_torch.models import encdec as E
    from repro_torch.models.frontends import fake_frames
    from repro_torch.models.model import prepare_decode_cache

    model, params = family_model(torch, dev, "whisper-tiny", smoke, **change)
    cfg = model.cfg
    log(f"{phase}: {cfg.name}, {cfg.n_enc_layers} encoder and {cfg.n_layers} decoder layers, "
        f"width {cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, {cfg.enc_seq} frames, "
        f"vocab {cfg.vocab}")
    gen = torch.Generator(device=dev).manual_seed(5)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, text), generator=gen, device=dev),
             "frames": fake_frames(gen, cfg, b)}
    prefill, serve = make_prefill_step(model), make_serve_step(model)
    pre = timed_prefill(torch, prefill, params, batch, phase)
    worst = []
    with attention_watch(torch, E, "_attn", worst):
        with uncounted():
            logits, _ = model.prefill(params, batch)
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    log(f"{phase} attention sub-layers, flash against plain (bf16 steps at the row's largest "
        f"magnitude; encoder self, then decoder self and cross a layer): "
        f"{[round(w, 3) for w in worst]}; tolerance {FLASH_BF16_STEPS}")
    if len(worst) != n_attn or max(worst) > FLASH_BF16_STEPS:
        raise AssertionError(f"{phase}: an attention sub-layer disagrees with the plain one")
    # room for the timed steps and timed_decode's profiled ones after them
    cache = prepare_decode_cache(cfg, pre["cache"], text + steps + 8)
    dec = timed_decode(torch, serve, params, pre["tok"], cache, steps, phase)
    cons = consistency(torch, model, params, batch, logits, text + 1, phase)
    if dev.type == "cuda":  # a CPU run takes the plain versions and launches nothing
        expect_launches(f"{phase} prefill", pre["launches"], {"flash_attention": n_attn})
        expect_launches(f"{phase} decode", dec["launches"], {"flash_attention": 0})
    log(f"{phase}: prefill B {b} x ({cfg.enc_seq} frames + {text} tokens): host "
        f"{pre['host_ms']:.2f} ms, device "
        f"{'not measured' if pre['device_ms'] is None else f'{pre['device_ms']:.2f} ms'}, flash "
        f"{'not measured' if pre['flash_share'] is None else f'{pre['flash_share']:.3f}'} of the "
        f"device time; decode {dec['host_ms']:.2f} ms a step (host), "
        f"{'not measured' if dec['device_ms'] is None else f'{dec['device_ms']:.3f} ms'} (device)")
    return {"prefill_ms": pre["host_ms"], "prefill_device_ms": pre["device_ms"],
            "flash_share": pre["flash_share"], "decode_ms": dec["host_ms"],
            "decode_device_ms": dec["device_ms"], "attn_steps": max(worst),
            "consistency": cons,
            "launches": {k: pre["launches"][k] + dec["launches"][k] for k in pre["launches"]}}


def run_phase8(torch, dev, mark) -> dict:
    """Phase 8 on the card: 8a and 8b (``run_family_phase``), 8c
    (``run_vlm_phase``), 8d (``run_whisper_phase``), each model freed
    before the next and ``mark`` called with each sub-phase's name at its
    end; returns each sub-phase's results and the launches of every kernel
    over the phase."""
    out = {}
    for sub, (arch, n, lo, hi) in zip(("8a", "8b"), FAMILY_RUNS):
        model, params = family_model(torch, dev, arch)
        cfg = model.cfg
        log(f"phase {sub}: {arch} at full width and depth ({cfg.n_layers} layers, d "
            f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, "
            f"{cfg.act if cfg.family != 'moe' else f'{cfg.n_experts} routed top-{cfg.moe_top_k} and {cfg.n_shared_experts} shared experts'} "
            f"of d_ff {cfg.d_ff}, vocab {cfg.vocab}; {torch.cuda.memory_allocated() / 2**30:.2f} "
            f"GiB on the card after init)")
        out[sub] = run_family_phase(torch, model, params, n, lo, hi, f"phase {sub}")
        del model, params
        torch.cuda.empty_cache()
        mark(sub)
    out["8c"] = run_vlm_phase(torch, dev)
    torch.cuda.empty_cache()
    mark("8c")
    out["8d"] = run_whisper_phase(torch, dev)
    torch.cuda.empty_cache()
    mark("8d")
    launches = collections.Counter()
    for sub in ("8a", "8b"):
        for run in out[sub]["runs"].values():
            launches.update(run["launches"])
    for sub in ("8c", "8d"):
        launches.update(out[sub]["launches"])
    out["launches"] = dict(launches)
    return out


def flash_phase8_case(torch, dev, gen, case: tuple) -> tuple:
    """Random inputs of one FLASH_PHASE8 case: q, k, v, q_pos, kv_valid."""
    b, sq, skv, hp, hkv, hd, start, valid, causal = case

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v = randn(b, sq, hp, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd)
    pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].expand(b, sq)
    kv_valid = torch.full((b,), valid, dtype=torch.int32, device=dev)
    return q, k, v, pos.contiguous(), kv_valid


def time_flash_phase8(torch, dev) -> list:
    """The flash kernel at FLASH_PHASE8: held to its plain version within
    FLASH_BF16_STEPS a row, then timed (events, device) beside the plain
    version, the bound over the visible pairs and SDPA over the same valid
    keys (causal, a boolean mask of the visible pairs, or none)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    gen = torch.Generator(device=dev).manual_seed(12)
    rows = []
    for name, case in FLASH_PHASE8:
        b, sq, skv, hp, hkv, hd, start, valid, causal = case
        q, k, v, pos, kv_valid = flash_phase8_case(torch, dev, gen, case)
        run = lambda i: FK.flash_attention(q, k, v, pos, kv_valid, causal=causal,  # noqa: E731
                                           window=0, valid=valid)
        plain = lambda i: FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=kv_valid,  # noqa: E731
                                                 causal=causal)
        with uncounted():
            got, want = run(0), plain(0)
            torch.cuda.synchronize()
            steps = row_bf16_steps(got, want)
            err = float((got.float() - want.float()).abs().max())
            if steps > FLASH_BF16_STEPS:
                raise AssertionError(f"phase 6: flash {name}: {steps:.2f} bf16 steps from plain")
            # every head's work: the inputs here draw q for all hp heads
            # (LLaVA's model path gives its 8 padded heads zero queries and
            # masks their output, which the kernel computes all the same)
            flops = flash_work(pos, kv_valid, hp, hd, causal=causal, window=0)
            # q and the output, K and V of the valid keys only (the rows past
            # ``valid`` are allocated but never read)
            nbytes = 2 * (2 * q.numel() + 2 * b * valid * hkv * hd)
            b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
            # SDPA over the valid keys: causal from the first key where the
            # queries start there, else with a boolean mask of the visible
            # pairs; bidirectional over every valid key with none
            qt = q.transpose(1, 2).contiguous()
            kt, vt = (t[:, :valid].transpose(1, 2).contiguous() for t in (k, v))
            top_left = causal and start == 0 and sq == valid
            mask = None
            if causal and not top_left:
                kidx = torch.arange(valid, device=dev)
                mask = (kidx[None, None, :] <= pos[:, :, None])[:, None]
            lib = lambda i: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask, is_causal=top_left, enable_gqa=True)
            plan = FK.plan(b, sq, skv, hp, hkv, hd, valid)
            per_call = 1 + (plan["splits"] > 1)  # the merge kernel where the keys split
            k_ms = cuda_time_ms(run, iters=10)
            k_dev = device_ms(run, "flash_attention_", 10, per_call)
            p_ms = cuda_time_ms(plain, iters=2)
            lib_ms, lib_dev = cuda_time_ms(lib, iters=10), device_ms(lib, "", 10)
        rows.append({"shape": name, "case": list(case), "plan": plan,
                     "max_abs_err": err, "bf16_steps": steps, "ms": k_ms, "device_ms": k_dev,
                     "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "bound_flops": flops,
                     "bound_bytes": nbytes, "bound_share": b_ms / k_dev, "library_ms": lib_ms,
                     "library_device_ms": lib_dev, "over_library": k_dev / lib_dev,
                     "library_mask": "causal" if top_left else ("boolean" if mask is not None
                                                               else "none")})
        log(f"phase 6: flash_attention {name} B Sq Skv Hp Hkv hd = {(b, sq, skv, hp, hkv, hd)}, "
            f"{'causal' if causal else 'bidirectional'}: {k_ms:.4f} / {k_dev:.4f} ms (events / "
            f"device, {per_call} kernels a call); {steps:.2f} bf16 steps from plain; bound "
            f"{b_ms:.4f} ms by {b_by}, {b_ms / k_dev:.3f} of it; plain {p_ms:.4f} ms; sdpa "
            f"{'with the mask ' if mask is not None else ''}{lib_ms:.4f} / {lib_dev:.4f} ms "
            f"(kernel / sdpa by device {k_dev / lib_dev:.3f})")
        del q, k, v, qt, kt, vt, mask
    torch.cuda.empty_cache()
    return rows


def time_paged_phase8(torch, dev) -> dict:
    """Both paged kernels at PAGED_PHASE8 (keeps drawn from phase 3's
    ladder {8, 12, 16}, lengths PAGED_PHASE8_LENS): the case held to the
    plain versions (``check_paged_case``), then each kernel timed (events,
    device; the rung kernel once a plane count, summed) beside its byte
    bound, the plain version and SDPA with the same mask over dense bf16.
    Returns {"paged_attention_fused": rows, "paged_attention_rung": rows}."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as O
    from repro_torch.kernels.paged_attention import ref as R

    gen = torch.Generator(device=dev).manual_seed(14)
    out = {"paged_attention_fused": [], "paged_attention_rung": []}
    for name, shape in PAGED_PHASE8:
        b, s, hkv, rep, hd = shape
        case = random_case(torch, dev, gen, shape, (8, 12, 16), PAGED_PHASE8_LENS)
        q, kp, vp, keeps, mask, tok_keep = case
        with uncounted():
            fused_err, rung_err = check_paged_case(torch, case, 3, (8, 12, 16))
            rung_masks = [(kk, (mask * (tok_keep == kk)).to(torch.int8).contiguous())
                          for kk in (8, 12, 16)]
            calls = {
                "paged_attention_fused": lambda i: K.paged_attention_fused(q, kp, vp, keeps, mask),
                "paged_attention_rung": lambda i: [K.paged_attention_rung(q, kp, vp, m, keep=kk)
                                                   for kk, m in rung_masks]}
            plains = {
                "paged_attention_fused": lambda i: R.paged_attention_fused_ref(q, kp, vp, keeps, mask),
                "paged_attention_rung": lambda i: [R.paged_attention_rung_ref(q, kp, vp, m, kk)
                                                   for kk, m in rung_masks]}
            plan = K.plan(b, s, hkv, rep, hd)
            per_call = 2 if plan["splits"] > 1 else 1
            kd, vd = (O.unpack_kv(t, 16).transpose(1, 2).contiguous() for t in (kp, vp))
            qd = q.reshape(b, hkv * rep, 1, hd)
            bmask = mask.bool()[:, None, None, :]
            lib = lambda i: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=bmask,  # noqa: E731
                                                           enable_gqa=True)
            lib_ms, lib_dev = cuda_time_ms(lib, iters=40), device_ms(lib, "", 40)
            small = q.numel() * 2 + mask.numel() + b * hkv * rep * hd * 4
            for kernel, fn in calls.items():
                n_calls = 1 if kernel == "paged_attention_fused" else len(rung_masks)
                nbytes = kernel_bytes(keeps, mask, hkv, hd // 8) + small * n_calls + (
                    keeps.numel() * 4 if kernel == "paged_attention_fused"
                    else 2 * b * hkv * rep * 4 * n_calls)
                k_ms = cuda_time_ms(fn, iters=40)
                k_dev = device_ms(fn, "paged_attention_", 40, per_call * n_calls)
                p_ms = cuda_time_ms(plains[kernel], iters=5)
                b_ms = nbytes / HBM_BYTES_PER_S * 1e3
                out[kernel].append({
                    "shape": name, "case": list(shape), "lens": list(PAGED_PHASE8_LENS),
                    "keeps": [8, 12, 16], "plan": plan,
                    "max_abs_err": fused_err if kernel == "paged_attention_fused" else rung_err,
                    "ms": k_ms, "device_ms": k_dev, "plain_ms": p_ms, "bytes": nbytes,
                    "bound_ms": b_ms, "bound_by": "bytes", "bound_share": b_ms / k_dev,
                    "library_ms": lib_ms, "library_device_ms": lib_dev,
                    "over_library": k_dev / lib_dev})
                log(f"phase 6: {kernel} at {name}'s decode, B S Hkv rep hd = {shape}, lengths "
                    f"{PAGED_PHASE8_LENS}, keeps {{8, 12, 16}} ({n_calls} call(s), plan {plan}): "
                    f"{k_ms:.4f} / {k_dev:.4f} ms (events / device); {nbytes} B, byte bound "
                    f"{b_ms:.5f} ms, {b_ms / k_dev:.3f} of it; plain {p_ms:.4f} ms; sdpa with "
                    f"the mask over dense bf16 {lib_ms:.4f} / {lib_dev:.4f} ms")
        del case, q, kp, vp, kd, vd
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 3t and 9: staged decode, padded admission, and training
# ---------------------------------------------------------------------------

# Phase 3t: phase 3's first STAGED_REQUESTS requests on full-width
# SmolLM-135M, (a) on dense device KV with a STAGED_WS-token staging ring
# against the same trace unstaged, (b) admitted by left-padded whole-prompt
# prefill (bit-plane device KV, phase 3's ladder, fused kernel) against
# the same trace admitted by bucketed chunks
STAGED_REQUESTS, STAGED_WS = 8, 16
# the staged run is teacher-forced with the unstaged run's tokens, and
# every decode row of the two runs (the same history) must agree within
# this many bf16 steps of the unstaged row's largest logit: the two sum
# each layer's attention in another order (the main cache's and the
# ring's partials, then a merge), so a bf16 rounding of an attention
# output can move a step in any of 30 layers (rows agreed within 0.0227
# of their largest logit, about 3 to 6 steps, before this check forced
# them); a row the ring folded wrong moves far more
STAGED_ROW_STEPS = 8
# Phase 9: training at full width.  9a: the flash backward against its
# plain version at (name, B, Sq, Skv, Hp, Hkv, hd, causal, window,
# kv_valid): SmolLM-135M's training shape, a 64-key window, Whisper-tiny's
# encoder (1,500 frames of a 1,536-row key buffer) and its cross
# attention, and Nemotron-4-15B's attention heads (48 q / 8 kv of 128: rep
# 6, the register-heavy head dim every hd-128 family trains through)
FLASH_BWD_CASES = (
    ("smollm-135m train", 8, 2048, 2048, 9, 3, 64, True, 0, None),
    ("window 64", 8, 2048, 2048, 9, 3, 64, True, 64, None),
    ("whisper-tiny encoder", 8, 1500, 1536, 6, 6, 64, False, 0, 1500),
    ("whisper-tiny cross", 8, 224, 1536, 6, 6, 64, False, 0, 1500),
    ("nemotron-4-15b heads", 2, 2048, 2048, 48, 8, 128, True, 0, None),
)
# the cases phase 6 times beside the row's own (the first): the hd-128 one
FLASH_BWD_TIMED = ("nemotron-4-15b heads",)
# dq, dk and dv each within this many bf16 steps of its largest magnitude
# (the float32 sums run in another order, dq's in one that changes from run
# to run, and exp is ex2.approx, which can flip one rounding of p or ds)
# and 1% in relative Frobenius norm
FLASH_BWD_STEPS, FLASH_BWD_FROBENIUS = 2, 1e-2
# 9b: SmolLM-135M, all 30 layers, make_train_step with TRAIN_MICRO
# micro-batches of ShardedLoader batches of TRAIN_B x TRAIN_L; one step's
# loss and gradients through the kernels against the same step through
# the plain versions, then TRAIN_STEPS AdamW steps on one fixed batch
TRAIN_B, TRAIN_L, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 8, 2048, 2, 10, 1e-3
# kernels against plain over 30 layers of random weights: the loss within
# 1e-3 relative, the global gradient norm within 2%, every leaf's cosine
# at least 0.99 (the CPU tests hold the port to the reference at 3% and
# 0.9995 per leaf at SMOKE depth)
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_COSINE = 1e-3, 2e-2, 0.99
# 9c: Whisper-tiny at full width, WHISPER_B x (1,500 frames + WHISPER_TEXT
# tokens), WHISPER_TRAIN_STEPS steps on one batch
WHISPER_TRAIN_STEPS = 3
# 9d: TrainSupervisor with a CheckpointManager: (b)'s model, its top layer
# and final norm trained (the rest frozen: the checkpoint then holds 3.5 M
# bf16 parameters and their float32 moments, 35 MB, which the card's
# NumPy lz4 (no zstandard there) writes in about 5 s; the whole model's
# 1.35 GB would take minutes), SUPERVISOR_STEPS steps of SUPERVISOR_B x
# TRAIN_L, a checkpoint every SUPERVISOR_EVERY, a SimulatedFailure at the
# SUPERVISOR_FAIL call
SUPERVISOR_STEPS, SUPERVISOR_EVERY, SUPERVISOR_FAIL, SUPERVISOR_B = 4, 2, 4, 2
# 9e: the SSD backward kernel against its plain version (ref.ssd_bwd_ref)
# on the same forward workspaces, at (name, (B, L, H, P, N, G), h0 and
# dh_final nonzero): the Mamba2-1.3B and Zamba2-7B training micro-batches
# (1 x 4,096 tokens, chunk 256), drawn float32 inputs at the models'
# decays with b and c bf16-valued, as the models' are.  Each gradient
# within its relative Frobenius bound: TF32-pass products (about 2^-21 of
# a product dropped where an operand is not a TF32 value) and other sum
# orders; dda, a reverse cumsum over the chunk of row less column sums,
# collects more of that rounding.  Two calls on the same inputs must give
# the same bits (every sum in a fixed order).
SSD_BWD_CASES = (("mamba2-1.3b train", (1, 4096, 64, 64, 128, 1), False),
                 ("zamba2-7b train", (1, 4096, 112, 64, 64, 2), True))
SSD_BWD_FROBENIUS = {"dxdt": 1e-4, "dda": 1e-3, "db": 1e-4, "dc": 1e-4, "dh0": 1e-4}
# the device kernels of one backward call (chunk sums, the pass over
# chunks, column tiles (each tile pair's scores, once), row tiles, dda,
# group sums)
SSD_BWD_KERNELS = 6
# TF32 passes of the backward's nine products, in ssd_bwd_work's order
# (scores c.b, dy.xdt, dxdt's, db's and dc's intra parts, then dxdt's G
# term, db's G term, dc's h term and the reverse pass's input c (x) dy):
# the fewest that keep each product's float32 sum on the models' inputs,
# whose b and c are bf16 values, exact in TF32 (a product of two float32
# operands takes three, one fewer for each exact operand); the kernel
# takes these, picking its passes from the bits of the tiles it reads
SSD_BWD_PASSES = (1, 3, 3, 2, 2, 2, 3, 3, 2)
# the bound's count before it counted two passes for the products with
# one exact operand (only the scores' single pass), for the share against
# the bound PERF.md recorded before
SSD_BWD_PASSES_SCORES_ONLY = (1,) + (3,) * 8
# 9f: Mamba2-1.3B (all 48 layers) and Zamba2-7B (width in full, depth cut
# to ZAMBA_TRAIN_SLOTS of its 81 slots: at 16 bytes a parameter, bf16
# weights, float32 summed gradients, bf16 gradients and AdamW's two
# float32 moments, its 5.77 B parameters would need 92 GB of the card's
# 80; 25 slots keep 4 shared-block calls and 21 Mamba2 layers, 2.08 B
# parameters, 33 GB; the run logs its own count) through make_train_step
# on SSM_TRAIN_B x 4,096 tokens
# of the Zipf corpus in SSM_TRAIN_MICRO micro-batches: a step against the
# same step through the plain versions (9b's bounds), a profiler window,
# SSM_TRAIN_STEPS AdamW steps at SSM_TRAIN_LR (at 9b's 1e-3 the first step,
# which moves every weight by about 1e-3, 5% of a He-scaled weight of
# width 2,048, raised Mamba2-1.3B's loss from 11.29 to 22.46 on an NVIDIA
# H100 80GB HBM3 at 700 W)
SSM_TRAIN_B, SSM_TRAIN_L, SSM_TRAIN_MICRO, SSM_TRAIN_STEPS = 2, 4096, 2, 3
SSM_TRAIN_LR = 1e-4
ZAMBA_TRAIN_SLOTS = 25


class _DecodeRows:
    """Wraps ``model.decode`` (an instance attribute, removed on exit) to
    keep, on the device, the logits row each decode step computes for a
    request by the (request, output index) it produces (``rows``), and at
    each request's last decode row layer 0's keys and values of its
    tokens, a staging ring's rows put back after the main cache's
    (``kv0``).  With ``force`` (request -> the greedy tokens of another
    run) each row samples that run's token: greedy sampling takes the
    row's argmax, so the logits returned to the scheduler carry +inf at
    the forced token (the kept row is the model's own)."""

    def __init__(self, torch, model, sched, force: dict | None = None):
        self.torch, self.model, self.sched, self.force = torch, model, sched, force or {}
        self.orig = model.decode
        self.rows: dict = {}
        self.kv0: dict = {}

    def __enter__(self):
        self.model.decode = self.decode
        return self

    def __exit__(self, *exc):
        del self.model.decode

    def decode(self, params, token, cache, **kw):
        logits, cache = self.orig(params, token, cache, **kw)
        out = logits
        for i, s in enumerate(self.sched._slots):
            if s is None or s.prefilling:
                continue
            rid, j = s.req.rid, len(s.req.output) + 1
            self.rows[(rid, j)] = logits[i]
            forced = self.force.get(rid, ())
            if j < len(forced):
                out = logits.clone() if out is logits else out
                out[i, forced[j]] = math.inf
            if j == s.req.max_new_tokens:
                self.kv0[rid] = self._layer0(cache, i)
        return out, cache

    def _layer0(self, cache, i: int) -> tuple:
        n = int(cache["len"][i])
        k, v = cache["k"][0, i, :n], cache["v"][0, i, :n]
        if "sk" in cache:
            base = int(cache["sbase"][i])
            k = self.torch.cat([k[:base], cache["sk"][0, i, :n - base]])
            v = self.torch.cat([v[:base], cache["sv"][0, i, :n - base]])
        return k.clone(), v.clone()


def serve_staged(torch, model, params, cfg, reqs, watch: bool = False,
                 force: dict | None = None) -> dict:
    """One phase-3t run: counts reset just before, read just after; the
    staging windows each request folded back (from the backend's slots,
    every step) and, with ``watch``, the run's decode rows under a
    ``_DecodeRows`` (teacher-forced with ``force``)."""
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, cfg, device=params["embed"]["table"].device)
    for m in launch_modules():
        m.reset_launches()
    folded, rows = {}, None
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if watch:
            rows = stack.enter_context(_DecodeRows(torch, model, sched, force))
        for r in reqs:
            sched.submit(r)
        while sched.has_work():
            sched.step()
            ws = model.cfg.decode_staging
            for st in sched.backend._slots.values():
                if ws:
                    folded[st.rid] = (st.stage_base - len(reqs[st.rid].prompt)) // ws
        if sched.device.type == "cuda":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    if not all(r.done and not r.truncated and len(r.output) == r.max_new_tokens for r in reqs):
        raise AssertionError("phase 3t: not every request completed")
    # the scheduler (and its device cache) is not kept: later phases need
    # the card's memory (phase 8c takes all 60 of LLaVA's layers only when
    # 6 GiB stay free)
    return {"reqs": reqs, "rep": sched.report(), "launches": launches,
            "encodes": dict(sched.backend.page_encodes), "folded": folded, "wall": wall,
            "rows": rows}


def staged_agree(staged: dict, unstaged: dict) -> dict:
    """3t (a)'s check of a staged run teacher-forced with an unstaged run's
    tokens: the greedy tokens equal (the first, from the prefill, is not
    forced); every decode row of the one within STAGED_ROW_STEPS bf16
    steps of the other's at its largest logit; layer 0's keys and values
    of every request equal bit for bit (layer 0's projections see the
    same tokens in both runs, so a row the ring dropped, doubled or folded
    to the wrong place shows here exactly).  Returns the rows' count, the
    rows whose own argmax is the forced token (a row parts from it only
    where its top two logits lie within twice the rows' difference), the
    worst difference in steps and the requests whose layer 0 was held."""
    import torch

    a, b = staged["rows"], unstaged["rows"]
    if [r.output for r in staged["reqs"]] != [r.output for r in unstaged["reqs"]]:
        raise AssertionError("phase 3t: the staged run's greedy tokens differ from the "
                             "unstaged run's it was forced with (the prefill's first token)")
    if a.rows.keys() != b.rows.keys():
        raise AssertionError(f"phase 3t: decode rows {sorted(a.rows.keys() ^ b.rows.keys())[:8]} "
                             f"of one run only")
    keys = sorted(b.rows)
    got = torch.stack([a.rows[key] for key in keys])
    want = torch.stack([b.rows[key] for key in keys])
    steps = row_bf16_steps(got, want)
    if not steps <= STAGED_ROW_STEPS:
        raise AssertionError(f"phase 3t: a staged decode row lies {steps:.2f} bf16 steps from "
                             f"the unstaged one (> {STAGED_ROW_STEPS})")
    argmax = int((got.argmax(-1) == want.argmax(-1)).sum())
    if a.kv0.keys() != b.kv0.keys() or not a.kv0:
        raise AssertionError(f"phase 3t: layer 0 kept for requests {sorted(a.kv0)} and "
                             f"{sorted(b.kv0)}")
    bad = [rid for rid in b.kv0 if not all(torch.equal(x, y) for x, y in zip(a.kv0[rid],
                                                                              b.kv0[rid]))]
    if bad:
        raise AssertionError(f"phase 3t: layer 0's keys or values of requests {bad} differ "
                             f"between the staged and the unstaged cache")
    return {"rows": len(keys), "argmax": argmax, "steps": steps, "kv0": len(b.kv0)}


def run_staged_padded_phase(torch, model, params, n: int = STAGED_REQUESTS,
                            max_batch: int = B, max_ctx: int = S, phase: str = "phase 3t",
                            requests=None) -> dict:
    """3t on ``model`` (SmolLM-135M at full width on the card): (a) the
    paged backend with dense device KV, decode_staging STAGED_WS,
    teacher-forced with the same trace's unstaged tokens (``staged_agree``),
    every request folding at least two staging windows back,
    no paged-attention, pack or unpack launch, flash once a layer a
    prefill chunk; (b) prefill_mode="padded" with bit-plane device KV and
    the fused kernel: flash once a layer a padded prefill, one encode a
    page-writing span, the fused kernel once a layer a decode step, one
    pack a layer a decode step and one an adoption; against a bucketed run
    of the same trace, tok/s and prefill tokens."""
    import dataclasses

    from repro_torch.core.quantization import PrecisionLadder
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig

    from repro_torch.serving.kv_cache import PAGE_TOKENS

    make = requests or (lambda: make_requests(STAGED_REQUESTS)[:n])
    n_layers = model.cfg.n_layers
    on_card = params["embed"]["table"].device.type == "cuda"
    # one stored layer (as phase 8's): the staged rows a page write reads
    # come from any stored layer, and the tier's per-layer host work would
    # otherwise dominate the four runs
    dense = EngineConfig(max_batch=max_batch, max_ctx=max_ctx, ladder=PrecisionLadder(LADDER),
                         codec="lz4", device_kv="dense", backend="paged", store_layers=1)
    staged = build_model(dataclasses.replace(model.cfg, decode_staging=STAGED_WS))
    runs = {"unstaged": serve_staged(torch, model, params, dense, make(), watch=True)}
    runs["staged"] = serve_staged(torch, staged, params, dense, make(), watch=True,
                                  force={r.rid: r.output for r in runs["unstaged"]["reqs"]})
    agree = staged_agree(runs["staged"], runs["unstaged"])
    for run in runs.values():
        run["rows"] = None  # the rows' logits, freed
    folded = runs["staged"]["folded"]
    if len(folded) != n or min(folded.values()) < 2:
        raise AssertionError(f"{phase}: staging windows folded a request {folded}, "
                             f"expected 2 or more each")
    for name, run in runs.items():
        rep, launches = run["rep"], run["launches"]
        if on_card:
            # dense device KV: no paged kernel; the page writes still pack
            # their planes (one pack an encode, inside encode_kv)
            expect_launches(f"{phase} [{name}]", launches, {
                "flash_attention": n_layers * rep["prefill_chunks"],
                "paged_attention_fused": 0, "paged_attention_rung": 0,
                "bitplane_pack": sum(run["encodes"].values()),
                "exp_delta_encode": sum(run["encodes"].values())})
        log(f"{phase} (a) [{name}]: {len(run['reqs'])} requests, {rep['decode_steps']} decode "
            f"steps, {rep['prefill_chunks']} prefill chunks, decode {rep['decode_tokens']} tok "
            f"at {rep['decode_tok_per_s']:.1f} tok/s, wall {run['wall']:.2f} s, launches "
            f"{ {k: v for k, v in launches.items() if v} }")
    log(f"{phase} (a): staged (ws {STAGED_WS}), teacher-forced with the unstaged run's "
        f"tokens: greedy tokens equal; its {agree['rows']} decode rows within "
        f"{agree['steps']:.2f} bf16 steps of the unstaged rows' largest logits (bound "
        f"{STAGED_ROW_STEPS}), {agree['argmax']} of them with the forced token as their own "
        f"argmax (the rest near ties); layer 0's keys and values equal bit for bit for all "
        f"{agree['kv0']} requests; windows folded a request {folded}")

    bitplane = dataclasses.replace(dense, device_kv="bitplane", decode_kernel="fused")
    runs["padded"] = serve_staged(torch, model, params,
                                  dataclasses.replace(bitplane, prefill_mode="padded"), make())
    runs["bucketed"] = serve_staged(torch, model, params, bitplane, make())
    rep, launches = runs["padded"]["rep"], runs["padded"]["launches"]
    padded_lens = {-(-len(r.prompt) // PAGE_TOKENS) * PAGE_TOKENS for r in runs["padded"]["reqs"]}
    if rep["prefill_tokens"] != sum(-(-len(r.prompt) // PAGE_TOKENS) * PAGE_TOKENS
                                   for r in runs["padded"]["reqs"]) or \
            rep["prefill_compiles"] != len(padded_lens) or rep["prefill_chunks"] != 0:
        raise AssertionError(f"{phase} (b): padded prefill tokens {rep['prefill_tokens']}, "
                             f"compiles {rep['prefill_compiles']}, chunks {rep['prefill_chunks']}")
    if on_card:
        steps = rep["decode_steps"]
        expect_launches(f"{phase} [padded]", launches, {
            "flash_attention": n_layers * n, "paged_attention_fused": n_layers * steps,
            "paged_attention_rung": 0,
            "exp_delta_encode": sum(runs["padded"]["encodes"].values()), "exp_delta_decode": 0})
        # a pack a layer a decode step, one an adoption, one a page write
        if launches["bitplane_pack"] < n_layers * steps + n:
            raise AssertionError(f"{phase} [padded]: {launches['bitplane_pack']} packs, fewer "
                                 f"than the decode steps' and the adoptions' {n_layers * steps + n}")
    for name in ("padded", "bucketed"):
        r = runs[name]["rep"]
        log(f"{phase} (b) [{name}, bit-plane KV, fused]: prefill {r['prefill_tokens']} tokens "
            f"in {r['prefill_s']:.3f} s ({r['prefill_chunks']} chunks, {r['prefill_compiles']} "
            f"prefill shapes), decode {r['decode_tokens']} tok at {r['decode_tok_per_s']:.1f} "
            f"tok/s, wall {runs[name]['wall']:.2f} s, kv_stored/logical "
            f"{r['kv_stored_bytes']}/{r['kv_logical_bytes']}, launches "
            f"{ {k: v for k, v in runs[name]['launches'].items() if v} }")
    launch_sum = collections.Counter()
    for run in runs.values():
        launch_sum.update(run["launches"])
    return {"runs": runs, "agree": agree, "folded": folded, "launches": dict(launch_sum)}


@contextlib.contextmanager
def plain_flash_train():
    """Route the differentiable flash call's forward and backward through
    their plain PyTorch versions on the card (the kernels' references), for
    one comparison: the wrappers ``ops.FlashAttention`` calls are replaced
    for the duration."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    saved = FK.flash_attention, FK.flash_attention_bwd

    def forward(q, k, v, q_pos, kv_valid, *, causal, window, valid=None, kv_pos=None,
                lse=False):
        return FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid, causal=causal,
                                      window=window, kv_pos=kv_pos, return_lse=lse)

    def backward(q, k, v, out, dout, lse, q_pos, kv_valid, *, causal, window):
        return FR.flash_attention_bwd_ref(q, k, v, out, dout, lse, q_pos=q_pos,
                                          kv_valid=kv_valid, causal=causal, window=window)

    FK.flash_attention, FK.flash_attention_bwd = forward, backward
    try:
        yield
    finally:
        FK.flash_attention, FK.flash_attention_bwd = saved


def flash_bwd_case(torch, dev, case: tuple, seed: int = 9) -> tuple:
    """Random inputs of one FLASH_BWD_CASES case: q, k, v, dout, q_pos,
    kv_valid (all rows valid up to kv_valid, or causal to the query)."""
    _, b, sq, skv, hp, hkv, hd, causal, window, valid = case
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, k, v, dout = randn(b, sq, hp, hd), randn(b, skv, hkv, hd), randn(b, skv, hkv, hd), \
        randn(b, sq, hp, hd)
    pos = torch.arange(sq, dtype=torch.int32, device=dev)[None].expand(b, sq).contiguous()
    kv_valid = torch.full((b,), sq if valid is None else valid, dtype=torch.int32, device=dev)
    return q, k, v, dout, pos, kv_valid


def bf16_steps_of_max(got, want) -> float:
    """The largest difference in bf16 steps of ``want``'s largest magnitude."""
    w = want.float()
    return float((got.float() - w).abs().max()) / bf16_step(w)


def check_flash_bwd(torch, dev, cases=FLASH_BWD_CASES, phase: str = "phase 9a") -> dict:
    """9a: at each case, the forward's lse (kernel) against the plain
    forward's, and the backward kernel's dq, dk and dv against the plain
    backward's from the same (out, lse): each within FLASH_BWD_STEPS bf16
    steps of its largest magnitude and FLASH_BWD_FROBENIUS in relative
    Frobenius norm.  Returns the worst steps and the first case's inputs
    and largest absolute error."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    out = {}
    with uncounted():
        for case in cases:
            name, causal, window = case[0], case[7], case[8]
            q, k, v, dout, pos, kv = flash_bwd_case(torch, dev, case)
            o, lse = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=kv, causal=causal,
                                            window=window, return_lse=True)
            o = o.contiguous()
            _, k_lse = FK.flash_attention(q, k, v, pos, kv, causal=causal, window=window,
                                          lse=True)
            got = FK.flash_attention_bwd(q, k, v, o, dout, lse, pos, kv, causal=causal,
                                         window=window)
            want = FR.flash_attention_bwd_ref(q, k, v, o, dout, lse, q_pos=pos, kv_valid=kv,
                                              causal=causal, window=window)
            torch.cuda.synchronize()
            steps = [bf16_steps_of_max(g, w) for g, w in zip(got, want)]
            frob = [float((g.float() - w.float()).norm() / w.float().norm())
                    for g, w in zip(got, want)]
            lse_err = float((k_lse - lse).abs().max())
            err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
            log(f"{phase} [{name}]: B {case[1]}, Sq {case[2]}, Skv {case[3]}, {case[4]}/{case[5]} "
                f"heads of {case[6]}, {'causal' if causal else 'bidirectional'}"
                f"{f', window {window}' if window else ''}: dq, dk, dv within {steps} bf16 steps "
                f"of their largest, relative Frobenius {[round(f, 5) for f in frob]}, max abs "
                f"{err:.3e}; the forward's lse within {lse_err:.2e} of plain")
            if max(steps) > FLASH_BWD_STEPS or max(frob) > FLASH_BWD_FROBENIUS or lse_err > 1e-3:
                raise AssertionError(f"{phase} [{name}]: the backward kernel disagrees")
            out[name] = {"steps": max(steps), "frobenius": max(frob), "max_abs_err": err,
                         "lse_err": lse_err}
    return out


def sdpa_case(torch, q, k, v, dout, pos, kv, case) -> tuple:
    """PyTorch's SDPA at a FLASH_BWD_CASES case, the same function the
    kernels compute: (forward, (q, k, v) in SDPA's layout needing grad,
    dout in its layout).  A causal case with Sq = Skv, no window and every
    key valid takes ``is_causal``; the others a boolean mask of the same
    visible pairs.  A yardstick the port never calls."""
    import torch.nn.functional as F

    _, b, sq, skv, hp, hkv, hd, causal, window, valid = case
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dt = dout.transpose(1, 2).contiguous()
    plain_causal = causal and window == 0 and sq == skv and valid in (None, skv)
    mask = None
    if not plain_causal:
        keys = torch.arange(skv, device=q.device)
        qp = pos.long()[:, None, :, None]
        mask = keys < kv.long()[:, None, None, None]
        if causal:
            mask = mask & (keys <= qp)
        if window > 0:
            mask = mask & (keys > qp - window)

    def forward():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              is_causal=plain_causal, enable_gqa=hp != hkv)

    return forward, (qt, kt, vt), dt


def sdpa_backward_ms(torch, q, k, v, dout, pos, kv, case, iters: int) -> tuple:
    """(CUDA-event ms, device ms) of SDPA's backward alone at a
    FLASH_BWD_CASES case (``sdpa_case``): its forward run once with the
    graph kept, then ``torch.autograd.grad`` over it timed."""
    forward, leaves, dt = sdpa_case(torch, q, k, v, dout, pos, kv, case)
    y = forward()

    def grad(i):
        return torch.autograd.grad(y, leaves, dt, retain_graph=True)

    return cuda_time_ms(grad, iters=iters), device_ms(grad, "", iters)


def time_flash_bwd_case(torch, dev, case: tuple, plain: bool) -> dict:
    """The backward kernel at one FLASH_BWD_CASES case: CUDA events and
    profiler device time (its three kernels a call, in all and each apart),
    the bound (five products of 2 hd operations over the visible pairs at
    the bf16 tensor-core peak, against q, k, v, out, dout and lse read once
    and dq, dk, dv written once), SDPA's backward alone and its forward and
    backward, the kernels' own forward (with lse) and backward, and, when
    ``plain``, the plain backward's times."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ref as FR

    name, b, sq, skv, hp, hkv, hd, causal, window, _ = case
    q, k, v, dout, pos, kv = flash_bwd_case(torch, dev, case)
    with uncounted():
        o, lse = FK.flash_attention(q, k, v, pos, kv, causal=causal, window=window, lse=True)
        run = lambda i: FK.flash_attention_bwd(q, k, v, o, dout, lse, pos, kv,  # noqa: E731
                                               causal=causal, window=window)

        def both(i):
            o2, l2 = FK.flash_attention(q, k, v, pos, kv, causal=causal, window=window,
                                        lse=True)
            return FK.flash_attention_bwd(q, k, v, o2, dout, l2, pos, kv, causal=causal,
                                          window=window)

        forward, leaves, dt = sdpa_case(torch, q, k, v, dout, pos, kv, case)

        def lib_both(i):
            return torch.autograd.grad(forward(), leaves, dt)

        per_call = kernels_per_call(run, "flash_attention_bwd")
        k_ms = cuda_time_ms(run, iters=10)
        split = {re.search(r"flash_attention_bwd\w*", n).group(0): t for n, t in
                 device_ms_by_kernel(run, "flash_attention_bwd", 10, per_call).items()}
        k_dev = sum(split.values())
        out = {}
        if plain:
            fn = lambda i: FR.flash_attention_bwd_ref(  # noqa: E731
                q, k, v, o, dout, lse, q_pos=pos, kv_valid=kv, causal=causal, window=window)
            out["plain_ms"] = cuda_time_ms(fn, iters=2, warmup=1)
            out["plain_device_ms"] = device_ms(fn, "", 2)
        both_ms = cuda_time_ms(both, iters=10)
        lib_ms, lib_dev = sdpa_backward_ms(torch, q, k, v, dout, pos, kv, case, 10)
        lib_both_ms, lib_both_dev = cuda_time_ms(lib_both, iters=10), device_ms(lib_both, "", 10)
    fwd_flops = flash_work(pos, kv, hp, hd, causal=causal, window=window)
    flops = fwd_flops // 2 * 5  # five products of 2 hd operations a visible pair
    nbytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
    b_ms, b_by = bound_ms(nbytes, flops, BF16_TENSOR_FLOPS)
    log(f"phase 6: flash_attention_bwd [{name}] {k_ms:.4f} / {k_dev:.4f} ms (events / "
        f"device, {per_call} kernels a call) at B={b} L={sq} {hp}/{hkv} heads of {hd}: bound "
        f"{b_ms:.4f} ms by {b_by} ({flops} bf16 operations, {nbytes} B), {b_ms / k_dev:.3f} of "
        f"the bound; by kernel { {n: round(t, 4) for n, t in split.items()} }; "
        + (f"plain {out['plain_ms']:.4f} / {out['plain_device_ms']:.4f} ms; " if plain else "")
        + f"SDPA backward alone {lib_ms:.4f} / {lib_dev:.4f} ms (kernel / SDPA by device "
        f"{k_dev / lib_dev:.3f}); the kernels' forward (lse) and backward {both_ms:.4f} ms; "
        f"SDPA forward and backward {lib_both_ms:.4f} / {lib_both_dev:.4f} ms")
    return {"case": name, "ms": k_ms, "device_ms": k_dev, "device_ms_by_kernel": split,
            "kernels_per_call": per_call,
            "bound_ms": b_ms, "bound_by": b_by, "bound_flops": flops, "bound_bytes": nbytes,
            "library_ms": lib_ms, "library_device_ms": lib_dev,
            "forward_and_backward_ms": both_ms,
            "library_forward_and_backward_ms": lib_both_ms,
            "library_forward_and_backward_device_ms": lib_both_dev, **out}


def time_flash_bwd(torch, dev, checks: dict, train: dict) -> dict:
    """The backward kernel's row at SmolLM-135M's training shape
    (``time_flash_bwd_case`` with the plain backward's times), its library
    time SDPA's backward alone; the FLASH_BWD_TIMED cases under
    ``shapes``."""
    by_name = {c[0]: c for c in FLASH_BWD_CASES}
    case = FLASH_BWD_CASES[0]
    row = time_flash_bwd_case(torch, dev, case, plain=True)
    shapes = [time_flash_bwd_case(torch, dev, by_name[n], plain=False) for n in FLASH_BWD_TIMED]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/models/attention.py:147",
            "replaces_note": "the reference's custom VJP _flash_bwd; no Pallas kernel",
            "launches": train["launches"]["flash_attention_bwd"],
            "launches_per_train_step": train["launches"]["flash_attention_bwd"],
            "max_abs_err": checks[case[0]]["max_abs_err"],
            "bf16_steps": max(c["steps"] for c in checks.values()),
            **{key: val for key, val in row.items() if key != "case"},
            "library": "torch.nn.functional.scaled_dot_product_attention backward alone "
                       "(autograd.grad over a kept forward graph)",
            "shapes": shapes, "cases": checks}


# 9b's and 9f's step device time by kernel: (group, name fragments,
# lowercased), the first group whose fragment a kernel's name holds; the
# rest is "other"
TRAIN_SPLIT = (("ssd backward", ("ssd_bwd_",)),
               ("ssd forward", ("::ssd_",)),
               ("flash backward", ("flash_attention_bwd",)),
               ("flash forward", ("flash_attention",)),
               ("matrix products", ("gemm", "xmma", "nvjet", "cutlass")))


def device_split(rows, groups) -> dict:
    """Device ms of a profiler window's rows (``device_rows``) by kernel
    name group, rounded to the microsecond."""
    out = dict.fromkeys([name for name, _ in groups] + ["other"], 0.0)
    for e in rows:
        key = e.key.lower()
        name = next((n for n, frags in groups if any(f in key for f in frags)), "other")
        out[name] += e.self_device_time_total / 1e3
    return {k: round(v, 3) for k, v in out.items()}


def _to(batch: dict, dev) -> dict:
    import torch

    return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}


def _grad_compare(torch, got: dict, want: dict) -> dict:
    """Global norms and the worst per-leaf cosine of two gradient trees
    (an empty leaf, such as a hybrid's tail of no layers, has none)."""
    from repro_torch.optim.grad_utils import global_norm
    from repro_torch.tree import leaves_with_paths

    worst = (math.inf, "")
    for (path, g), (_, w) in zip(leaves_with_paths(got), leaves_with_paths(want)):
        if g.numel() == 0:
            continue
        g, w = g.float().flatten(), w.float().flatten()
        cos = float(torch.dot(g, w) / (g.norm() * w.norm()).clamp(min=1e-30))
        worst = min(worst, (cos, "/".join(path)))
    return {"norm": float(global_norm(got)), "plain_norm": float(global_norm(want)),
            "cosine": worst[0], "worst_leaf": worst[1]}


def train_corpus(vocab: int, n: int = 2_000_000):
    """The reference's synthetic Zipf corpus (``n`` tokens, seed 0) over
    ``vocab``.  It takes seconds of host time, so phases 9b, 9c and 9d
    share one: SmolLM-135M's (its tokens lie below Whisper-tiny's
    vocabulary too)."""
    from repro_torch.data import DataConfig, synthetic_corpus

    return synthetic_corpus(DataConfig(vocab=vocab, seq_len=1, global_batch=1), n)


def run_training_phase(torch, dev, corpus, arch: str = "smollm-135m", smoke: bool = False,
                       b: int = TRAIN_B, l: int = TRAIN_L, n_micro: int = TRAIN_MICRO,
                       steps: int = TRAIN_STEPS, lr: float = TRAIN_LR, slots: int | None = None,
                       phase: str = "phase 9b") -> dict:
    """9b and 9f: ``arch`` (``slots`` cuts its depth, as 9f cuts
    Zamba2-7B's) through ``make_train_step``: one step's loss and gradients
    (``accumulate_grads`` over ``n_micro`` micro-batches of a ShardedLoader
    batch of b x l), counts reset just before and read just after
    (``train_launches``), against the same step through the plain versions
    (``plain_flash_train`` and ``plain_ssd_train``) within 9b's bounds; a
    profiler window over one training step (host and device ms, tokens/s,
    device time by kernel); then ``steps`` AdamW steps at ``lr`` (warmup 1)
    on that batch, whose loss must fall.  Returns the model and its initial
    parameters beside the readings."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.launch import make_train_step
    from repro_torch.optim import AdamWConfig, accumulate_grads, adamw_init
    from repro_torch.tree import leaves

    model, params = family_model(torch, dev, arch, smoke,
                                 **({"n_layers": slots} if slots else {}))
    cfg = model.cfg
    if int(corpus.max()) >= cfg.vocab:
        raise ValueError(f"{phase}: the corpus holds tokens past the vocabulary {cfg.vocab}")
    n_params = sum(t.numel() for t in leaves(params))
    cut = ""
    if slots:
        # the full depth's count: this one's and the Mamba2 layers it cut
        full = get_config(arch, smoke=smoke)
        per = sum(t[0, 0].numel() for t in leaves(params["seg_layers"]))
        n_full = n_params + per * (layer_counts(full)[0] - layer_counts(cfg)[0])
        cut = (f", depth cut from {full.n_layers} to {cfg.n_layers} slots ({layer_counts(cfg)[0]} "
               f"Mamba2 layers, {layer_counts(cfg)[1]} shared-block calls; at 16 B a parameter "
               f"{16 * n_params / 1e9:.1f} GB, where the full depth's {n_full / 1e9:.3f} B "
               f"parameters would take {16 * n_full / 1e9:.1f} GB of the card's 80)")
    loader = ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=l, global_batch=b), corpus=corpus)
    batch = _to(loader.batch_at(0), dev)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    for m in launch_modules():
        m.reset_launches()
    t0 = time.perf_counter()
    loss, grads = accumulate_grads(model.loss, params, batch, n_micro)
    sync()
    first_s = time.perf_counter() - t0
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    expect = train_launches(cfg, n_micro)
    if on_card:
        expect_launches(phase, launches, expect)
    t0 = time.perf_counter()
    with uncounted(), plain_flash_train(), plain_ssd_train():
        p_loss, p_grads = accumulate_grads(model.loss, params, batch, n_micro)
    cmp = _grad_compare(torch, grads, p_grads)
    plain_s = time.perf_counter() - t0
    del grads, p_grads
    log(f"{phase}: {cfg.name}, {cfg.n_layers} {'slots' if slots else 'layers'}, width "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters{cut}; {n_micro} micro-batches of "
        f"{b // n_micro} x {l}: loss {float(loss):.6f} through the kernels, {float(p_loss):.6f} "
        f"plain; gradient norm {cmp['norm']:.6f} against {cmp['plain_norm']:.6f}; worst leaf "
        f"cosine {cmp['cosine']:.6f} ({cmp['worst_leaf']}); launches "
        f"{dict((k, v) for k, v in launches.items() if v)} (expected {expect}); first step "
        f"{first_s:.2f} s, the plain step and the comparison {plain_s:.2f} s")
    if not (abs(float(loss) - float(p_loss)) <= TRAIN_LOSS_RTOL * abs(float(p_loss))
            and abs(cmp["norm"] - cmp["plain_norm"]) <= TRAIN_GNORM_RTOL * cmp["plain_norm"]
            and cmp["cosine"] >= TRAIN_COSINE):
        raise AssertionError(f"{phase}: the step through the kernels parts from the plain one")

    step = make_train_step(model, AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps), n_micro)
    state = adamw_init(params)
    device_ms = split = None
    t0 = time.perf_counter()
    if on_card:
        rows = device_rows(lambda: step(params, state, batch), f"{phase} one training step",
                           repeatable=True)
        device_ms = sum(e.self_device_time_total for e in rows) / 1e3
        split = device_split(rows, TRAIN_SPLIT)
    window_s = time.perf_counter() - t0
    losses, times = [], []
    p = params
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        p, state, met = step(p, state, batch)
        losses.append(float(met["loss"]))
        times.append(time.perf_counter() - t0)
    del p, state
    host_ms = 1e3 * sum(times[1:]) / max(1, len(times) - 1)
    peak = torch.cuda.max_memory_allocated() / 2**30 if on_card else None
    log(f"{phase}: {steps} AdamW steps on one batch (lr {lr}, warmup 1): losses "
        f"{[round(x, 4) for x in losses]}; host {host_ms:.1f} ms a step, device "
        f"{'not measured' if device_ms is None else f'{device_ms:.1f} ms'} a step (one profiler "
        f"window of {window_s:.2f} s; by kernel {split}), {b * l / host_ms * 1e3:.0f} tokens/s; "
        f"peak {'not measured' if peak is None else f'{peak:.1f} GiB'} allocated")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    return {"launches": launches, "expect": expect, "loss": float(loss),
            "plain_loss": float(p_loss), **cmp, "losses": losses, "host_ms": host_ms,
            "device_ms": device_ms, "device_split": split, "tokens_per_s": b * l / host_ms * 1e3,
            "n_params": n_params, "model": model, "params": params}


def run_whisper_training(torch, dev, corpus, smoke: bool = False, b: int = WHISPER_B,
                         text: int = WHISPER_TEXT, steps: int = WHISPER_TRAIN_STEPS,
                         phase: str = "phase 9c") -> dict:
    """9c: Whisper-tiny through ``make_train_step`` on B ``b`` x (1,500
    frames + ``text`` tokens), ``steps`` steps on one batch: losses finite
    and falling; flash forward and backward once an attention sub-layer a
    step."""
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.launch import make_train_step
    from repro_torch.models.frontends import fake_frames
    from repro_torch.optim import AdamWConfig, adamw_init

    model, params = family_model(torch, dev, "whisper-tiny", smoke)
    cfg = model.cfg
    if int(corpus.max()) >= cfg.vocab:
        raise ValueError(f"{phase}: the corpus holds tokens past the vocabulary {cfg.vocab}")
    batch = _to(ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=text, global_batch=b),
                              corpus=corpus).batch_at(0), dev)
    batch["frames"] = fake_frames(torch.Generator(device=dev).manual_seed(5), cfg, b)
    step = make_train_step(model, AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=steps))
    state = adamw_init(params)
    for m in launch_modules():
        m.reset_launches()
    losses, t0 = [], time.perf_counter()
    for _ in range(steps):
        params, state, met = step(params, state, batch)
        losses.append(float(met["loss"]))
    wall = time.perf_counter() - t0
    launches = {k: v for m in launch_modules() for k, v in m.LAUNCHES.items()}
    n_attn = cfg.n_enc_layers + 2 * cfg.n_layers
    if dev.type == "cuda":
        expect_launches(phase, launches, {"flash_attention": n_attn * steps,
                                          "flash_attention_bwd": n_attn * steps})
    log(f"{phase}: {cfg.name} ({cfg.n_enc_layers} + {cfg.n_layers} layers, width "
        f"{cfg.d_model}), B {b} x ({cfg.enc_seq} frames + {text} tokens): losses "
        f"{[round(x, 4) for x in losses]} in {wall:.2f} s ({steps} steps); launches "
        f"{dict((k, v) for k, v in launches.items() if v)}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{phase}: the loss did not fall: {losses}")
    return {"losses": losses, "launches": launches, "wall": wall}


def ssd_bwd_case(torch, dev, shape: tuple, nonzero: bool, seed: int = 11) -> tuple:
    """One SSD_BWD_CASES case: ``ssd_case``'s inputs (h0 nonzero or zero)
    with b and c rounded to bf16 values, a unit-normal dy and dh_final
    (or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    xdt, da, b, c, h0 = ssd_case(torch, dev, gen, shape, h0=nonzero)
    bsz, l, h, p, n, _ = shape
    if h0 is None:
        h0 = torch.zeros((bsz, h, n, p), device=dev)
    dy = torch.randn((bsz, l, h, p), generator=gen, device=dev)
    dhf = torch.randn((bsz, h, n, p), generator=gen, device=dev) if nonzero else None
    return xdt, da, b.bfloat16().float(), c.bfloat16().float(), h0, dy, dhf


def ssd_bwd_work(bsz: int, l: int, h: int, p: int, n: int, q: int, g: int,
                 with_dh: bool) -> tuple:
    """(bytes, causal operations of each product) of one backward call:
    each input read once (xdt, dy, b and c per group, the forward's cum and
    states, h_final and dh_final when given) and each output written once
    (dxdt, dda, db, dc, dh0), float32; per (batch, head, chunk) 2 Q(Q+1)/2
    N for the scores c.b, 2 Q(Q+1)/2 P each for dy.xdt and dxdt's intra
    part, 2 Q(Q+1)/2 N each for db's and dc's, and 2 Q N P each for the
    four state products (dxdt's and db's G terms, dc's h term, the reverse
    pass's input).  Each product counted once: the kernel computes each
    tile pair's scores once.  SSD_BWD_PASSES gives the TF32 passes of each
    on the models' inputs."""
    nc = l // q
    nbytes = 4 * (3 * bsz * l * h * p + 4 * bsz * l * g * n + 2 * bsz * h * l
                  + bsz * nc * h * n * p + (3 if with_dh else 1) * bsz * h * n * p)
    blocks, tri = bsz * h * nc, q * (q + 1) // 2
    return nbytes, tuple(2 * k * blocks for k in (tri * n, tri * p, tri * p, tri * n, tri * n,
                                                  q * n * p, q * n * p, q * n * p, q * n * p))


def check_ssd_bwd(torch, dev, cases=SSD_BWD_CASES, phase: str = "phase 9e") -> dict:
    """9e: at each case the forward kernel's workspaces, then the backward
    kernel against ``ref.ssd_bwd_ref`` on them: every gradient finite and
    within SSD_BWD_FROBENIUS, and a second call the same bits; the kernel
    timed (CUDA events, and the profiler's device time of its six kernels)
    beside the plain backward's events and the bounds (SSD_BWD_PASSES, and
    the count before, SSD_BWD_PASSES_SCORES_ONLY).  Launches here are left
    out of the counts."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as SR

    q, out = 256, {}
    with uncounted():
        for name, shape, nonzero in cases:
            xdt, da, b, c, h0, dy, dhf = ssd_bwd_case(torch, dev, shape, nonzero)
            _, hf, cum, states = SK.ssd(xdt, da, b, c, h0, chunk=q, workspaces=True)
            got = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
            again = SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)
            same_bits = all(torch.equal(u, v) for u, v in zip(got, again))
            del again
            want = SR.ssd_bwd_ref(xdt, b, c, dy, dhf, cum, states, q)
            torch.cuda.synchronize()
            frob = {k: float((gr - w).norm() / w.norm())
                    for k, gr, w in zip(SSD_BWD_FROBENIUS, got, want)}
            err = max(float((gr - w).abs().max()) for gr, w in zip(got, want))
            finite = all(bool(torch.isfinite(gr).all()) for gr in got)
            del got, want
            run = lambda i: SK.ssd_bwd(xdt, b, c, dy, cum, states, hf, dhf, chunk=q)  # noqa: E731
            plain = lambda i: SR.ssd_bwd_ref(xdt, b, c, dy, dhf, cum, states, q)  # noqa: E731
            k_ms = cuda_time_ms(run, iters=10)
            split = {re.search(r"ssd_bwd_\w+?_kernel", key).group(0): ms for key, ms in
                     device_ms_by_kernel(run, "::ssd_bwd_", 10, SSD_BWD_KERNELS).items()}
            k_dev = sum(split.values())
            p_ms = cuda_time_ms(plain, iters=2, warmup=1)
            bsz, l, h, p, n, g = shape
            nbytes, products = ssd_bwd_work(bsz, l, h, p, n, q, g, nonzero)
            bounds = ssd_bounds(nbytes, products, SSD_BWD_PASSES)
            before = ssd_bounds(nbytes, products, SSD_BWD_PASSES_SCORES_ONLY)
            all3 = ssd_bounds(nbytes, products, (3,) * len(products))
            log(f"{phase}: ssd backward, {name} B L H P N G = {shape}, h0 and dh_final "
                f"{'nonzero' if nonzero else 'zero'}: relative Frobenius "
                f"{ {k: float(f'{v:.3g}') for k, v in frob.items()} } (bounds "
                f"{SSD_BWD_FROBENIUS}), max abs err {err:.3g}; {k_ms:.4f} / {k_dev:.4f} ms "
                f"(events / device, {SSD_BWD_KERNELS} kernels a call); bound "
                f"{bounds['bound_ms']:.4f} ms by {bounds['bound_by']} ({bounds['bound_flops']} "
                f"TF32 operations: passes {list(SSD_BWD_PASSES)} over {list(products)}; all "
                f"3xTF32 {all3['bound_ms']:.4f} ms; {nbytes} B), "
                f"{bounds['bound_ms'] / k_dev:.3f} of it; against the bound with passes "
                f"{list(SSD_BWD_PASSES_SCORES_ONLY)} {before['bound_ms']:.4f} ms, "
                f"{before['bound_ms'] / k_dev:.3f} of it; float32 CUDA-core bound "
                f"{bounds['f32_bound_ms']:.4f} ms; plain {p_ms:.4f} ms (events); two calls "
                f"{'the same bits' if same_bits else 'DIFFERENT bits'}; device ms by kernel "
                f"{ {k: round(v, 4) for k, v in split.items()} }")
            if not finite or any(frob[k] > SSD_BWD_FROBENIUS[k] for k in frob):
                raise AssertionError(f"{phase}: the SSD backward kernel differs from plain "
                                     f"at {name}: {frob}")
            if not same_bits:
                raise AssertionError(f"{phase}: two calls of the SSD backward kernel at {name} "
                                     f"gave different bits")
            out[name] = {"shape": list(shape), "chunk": q, "kernels_per_call": SSD_BWD_KERNELS,
                         "frobenius": frob, "max_abs_err": err, "ms": k_ms, "device_ms": k_dev,
                         "plain_ms": p_ms, **bounds, "bound_ms_3xtf32": all3["bound_ms"],
                         "bound_ms_scores_only": before["bound_ms"],
                         "bound_share": bounds["bound_ms"] / k_dev,
                         "bound_share_scores_only": before["bound_ms"] / k_dev,
                         "same_bits": same_bits, "device_ms_by_kernel": split}
            del xdt, da, b, c, h0, dy, dhf, hf, cum, states
    return out


@contextlib.contextmanager
def plain_ssd_train():
    """Route the differentiable SSD scan's forward and backward
    (``ops.SSDScan``) through their plain PyTorch versions on the card, for
    one comparison: the kernel wrappers it calls are replaced for the
    duration."""
    from repro_torch.kernels.ssd import kernel as SK
    from repro_torch.kernels.ssd import ref as SR

    saved = SK.ssd, SK.ssd_bwd

    def forward(xdt, da, b, c, h0, *, chunk, workspaces=False):
        return SR.ssd_chunked(xdt, da, b, c, h0, chunk, workspaces=workspaces)

    def backward(xdt, b, c, dy, cum, states, h_final, dh_final, *, chunk):
        return SR.ssd_bwd_ref(xdt, b, c, dy, dh_final, cum, states, chunk)

    SK.ssd, SK.ssd_bwd = forward, backward
    try:
        yield
    finally:
        SK.ssd, SK.ssd_bwd = saved


def layer_counts(cfg) -> tuple:
    """(Mamba2 layers, attention layers) of a config: a hybrid's attention
    layers are its shared-block calls."""
    from repro_torch.models.hybrid import hybrid_counts

    if cfg.family == "ssm":
        return cfg.n_layers, 0
    if cfg.family == "hybrid":
        n_attn, seg_m, tail = hybrid_counts(cfg)
        return n_attn * seg_m + tail, n_attn
    return 0, cfg.n_layers


def train_launches(cfg, n_micro: int) -> dict:
    """The launches one ``accumulate_grads`` over ``n_micro`` micro-batches
    makes: each attention layer's flash forward and backward once a
    micro-batch (remat's checkpoint segments leave flash out); each Mamba2
    layer's scan forward once and, under ``cfg.remat`` (each layer a
    checkpoint segment, run again in the backward), twice, its backward
    once."""
    mamba, n_attn = layer_counts(cfg)
    return {"ssd": mamba * n_micro * (2 if cfg.remat else 1), "ssd_bwd": mamba * n_micro,
            "flash_attention": n_attn * n_micro, "flash_attention_bwd": n_attn * n_micro}


def time_ssd_bwd(checks: dict, trains: dict) -> dict:
    """The SSD backward's row: 9e's Mamba2-1.3B case (its times, bounds and
    errors), Zamba2-7B's under ``shapes``; its launches those of 9f's
    Mamba2 step."""
    first, *rest = checks.values()
    per_step = {arch: t["launches"]["ssd_bwd"] for arch, t in trains.items()}
    return {"name": "ssd_bwd", "route": "cuda", "source": "src/repro_torch/csrc/ssd_bwd.cu",
            "replaces": "src/repro/models/ssm.py:116",
            "replaces_note": "JAX's autodiff of _ssd_scan_body under jax.checkpoint "
                             "(ssd_scan, :81); no Pallas kernel",
            "launches": per_step["mamba2-1.3b"], "launches_per_train_step": per_step,
            **first, "library_ms": None, "library": "none", "shapes": rest,
            "cases": list(checks)}


def run_supervisor_phase(torch, model, params, tmp: str, corpus, b: int = SUPERVISOR_B,
                         l: int = TRAIN_L, phase: str = "phase 9d") -> dict:
    """9d: ``TrainSupervisor`` with a ``CheckpointManager`` on ``tmp`` over
    (b)'s model, its top layer and final norm trained (the rest frozen),
    SUPERVISOR_STEPS steps, a checkpoint every SUPERVISOR_EVERY and a
    ``SimulatedFailure`` at call SUPERVISOR_FAIL: one recovery, from the last
    checkpoint; the batches replayed exactly once (the loader's state is
    one integer); every restored tree equal, bit for bit, to the tree that
    was saved; each save's and load's seconds with the card's default
    codec."""
    from repro_torch.checkpoint import CheckpointManager, load_checkpoint
    from repro_torch.compression import default_codec
    from repro_torch.data import DataConfig, ShardedLoader
    from repro_torch.launch import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime.fault_tolerance import SimulatedFailure, TrainSupervisor
    from repro_torch.tree import leaves, tree_map

    cfg = model.cfg
    top = cfg.n_layers - 1
    frozen = tree_map(lambda t: t[:top].detach(), params["layers"])
    trainable = {"layer": tree_map(lambda t: t[top].detach().clone(), params["layers"]),
                 "final_norm": tree_map(lambda t: t.detach().clone(), params["final_norm"])}

    class TopLayer:
        """The model with its top layer and final norm taken from the
        trained tree."""

        @staticmethod
        def loss(tp, batch):
            layers = tree_map(lambda f, t: torch.cat([f, t[None]]), frozen, tp["layer"])
            return model.loss({**params, "layers": layers, "final_norm": tp["final_norm"]},
                              batch)

    train = make_train_step(TopLayer, AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                                                  total_steps=SUPERVISOR_STEPS))
    dev = params["embed"]["table"].device
    seen, calls, saved, timing = [], {"n": 0}, {}, {"save_s": [], "load_s": []}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == SUPERVISOR_FAIL:
            raise SimulatedFailure(f"injected at call {SUPERVISOR_FAIL}")
        seen.append(batch["tokens"][:, :8].copy())
        p, opt, met = train(state["params"], state["opt"], _to(batch, dev))
        return {"params": p, "opt": opt}, met

    class Manager(CheckpointManager):
        def maybe_save(self, step, tree, extra=None):
            t0 = time.perf_counter()
            path = super().maybe_save(step, tree, extra)
            if path is not None:
                timing["save_s"].append(time.perf_counter() - t0)
                saved[step] = [t.detach().cpu().clone() for t in leaves(tree)]
            return path

        def restore_latest(self, tree_like):
            t0 = time.perf_counter()
            tree, extra, step = super().restore_latest(tree_like)
            if tree is not None:
                timing["load_s"].append(time.perf_counter() - t0)
                check_bits(f"{phase} restore of step {step}", leaves(tree), saved[step])
            return tree, extra, step

    def check_bits(what, got, want):
        def bits(t):
            return t.detach().cpu().reshape(-1).view(torch.uint8)

        for g, w in zip(got, want):
            if g.dtype != w.dtype or not torch.equal(bits(g), bits(w)):
                raise AssertionError(f"{what}: a leaf differs from the saved one")

    loader = ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=l, global_batch=b, seed=1),
                           corpus=corpus)
    mgr = Manager(tmp, every_steps=SUPERVISOR_EVERY)
    sup = TrainSupervisor(step_fn, loader, mgr, max_restarts=1)
    init = {"params": trainable, "opt": adamw_init(trainable)}
    t0 = time.perf_counter()
    state, step = sup.run(init, SUPERVISOR_STEPS)
    wall = time.perf_counter() - t0
    final, extra = load_checkpoint(f"{tmp}/step_{step:010d}", init)
    check_bits(f"{phase} the last checkpoint", leaves(final), [t.detach().cpu() for t in leaves(state)])
    # the loader steps whose batches the successful calls consumed: steps
    # before the failing call, then, from the checkpoint before it, the
    # lost steps again, each once
    fail_step = SUPERVISOR_FAIL - 1
    resume = fail_step // SUPERVISOR_EVERY * SUPERVISOR_EVERY
    lineage = list(range(fail_step)) + list(range(resume, SUPERVISOR_STEPS))
    want = [loader.batch_at(s)["tokens"][:, :8] for s in lineage]
    if step != SUPERVISOR_STEPS or sup.restarts != 1 or extra != {"loader": {"step": step}} \
            or len(seen) != len(want) or not all((a == w).all() for a, w in zip(seen, want)):
        raise AssertionError(f"{phase}: step {step}, restarts {sup.restarts}, loader {extra}, "
                             f"{len(seen)} batches consumed, expected loader steps {lineage}")
    nbytes = sum(t.numel() * t.element_size() for t in leaves(init))
    log(f"{phase}: TrainSupervisor over {cfg.name}'s top layer and final norm "
        f"({sum(t.numel() for t in leaves(trainable))} parameters, checkpoint of {nbytes} B "
        f"with codec {default_codec()}): {SUPERVISOR_STEPS} steps of {b} x {l}, a "
        f"SimulatedFailure at call {SUPERVISOR_FAIL}, {sup.restarts} recovery from step "
        f"{resume}, batches consumed in loader steps {lineage}; restored trees "
        f"equal the saved ones bit for bit; saves {[round(s, 2) for s in timing['save_s']]} s, "
        f"loads {[round(s, 2) for s in timing['load_s']]} s; wall {wall:.2f} s")
    return {"wall": wall, **timing, "checkpoint_bytes": nbytes, "restarts": sup.restarts}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    if not all((ROOT / "src" / "repro_torch" / "csrc" / src).is_file() for src in SOURCES):
        print("chip_smoke: run it from a checkout (src/repro_torch missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    marks = {}

    def mark(name):
        marks[name] = round(time.perf_counter() - t_start, 1)

    log(nvidia_smi_line())
    build_kernels()
    mark("1")

    dev = torch.device("cuda")
    errs = check_kernels(torch, dev)
    errs.update(check_bitplane_kernels(torch, dev))
    ssd_checks = check_ssd_kernel(torch, dev)
    errs["ssd"] = ssd_checks["mamba2"][0]
    errs["flash_attention"], flash_inputs = check_flash_kernel(torch, dev)
    exp_delta_errs, exp_delta_span, exp_delta_view = check_exp_delta_kernels(torch, dev)
    errs.update(exp_delta_errs)
    mark("2")

    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    fused_reqs, fused_rep, fused_launches, _, _ = serve(torch, model, params, "fused")
    rung_reqs, rung_rep, rung_launches, _, _ = serve(torch, model, params, "rung")
    same = sum(a == b for fr, rr in zip(fused_reqs, rung_reqs)
               for a, b in zip(fr.output, rr.output))
    total = sum(len(r.output) for r in fused_reqs)
    log(f"phase 3: fused and rung runs agree on {same}/{total} greedy tokens "
        f"({same / total:.3f})")
    log(f"phase 3 digest of greedy tokens and counters: fused "
        f"{phase3_digest(fused_reqs, fused_rep)}, rung {phase3_digest(rung_reqs, rung_rep)} "
        f"(the counters reports had before shared-prefix pages); of the full report: fused "
        f"{phase3_digest(fused_reqs, fused_rep, True)}, rung "
        f"{phase3_digest(rung_reqs, rung_rep, True)}")
    first = first_divergences(fused_reqs, rung_reqs)
    checks = {}
    for kernel, timed in (("fused", (fused_reqs, fused_rep)), ("rung", (rung_reqs, rung_rep))):
        c_reqs, c_rep, _, watch, ledger = serve(torch, model, params, kernel, first)
        check_repeat(kernel, timed, (c_reqs, c_rep))
        checks[kernel] = (c_rep, ledger, watch)
    check_fused_against_rung(torch, fused_reqs, rung_reqs, first, checks["fused"][2],
                             checks["rung"][2])
    check_write_drift(checks["fused"][:2], checks["rung"][:2])
    paged_ledger = checks["fused"][1]
    del checks
    per_step = profile_decode(torch, model, params)
    cache, tok, keeps = snapshot(torch, model, params)
    spans = write_span_kernels(torch, model, params)
    prefill = prefill_chunk_launches(torch, model, params, cache)
    decode = decode_launches(torch, model, params, cache, tok, keeps)
    teacher_forced(torch, model, params, cache, tok, keeps)
    mark("3")
    round_trip = memory_tier_round_trip(torch, cache)
    mark("3c")
    sharded_runs = run_sharded_phase(torch, model, params, fused_reqs, paged_ledger)
    mark("3s")
    staged = run_staged_padded_phase(torch, model, params)
    mark("3t")
    prefix_runs = run_prefix_phase(torch, model, params)
    mark("3p")
    qs_launches = run_quickstart(torch)
    mark("4")
    del model, params
    mamba = run_mamba(torch, dev)
    torch.cuda.empty_cache()
    mark("5")
    zamba = run_zamba(torch, dev)
    torch.cuda.empty_cache()
    mark("5b")
    mixtral, mixtral_params = mixtral_model(torch, dev)
    log(f"phase 7: mixtral-8x7b at full width (d {mixtral.cfg.d_model}, "
        f"{mixtral.cfg.n_heads}/{mixtral.cfg.n_kv_heads} heads of {mixtral.cfg.head_dim}, "
        f"{mixtral.cfg.n_experts} experts of d_ff {mixtral.cfg.d_ff}, top-"
        f"{mixtral.cfg.moe_top_k}, window {mixtral.cfg.attn_window}, vocab "
        f"{mixtral.cfg.vocab}), depth cut from 32 to {MIXTRAL_LAYERS} layers "
        f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card after init)")
    ring = run_ring_phase(torch, mixtral, mixtral_params)
    del mixtral, mixtral_params
    torch.cuda.empty_cache()
    mark("7")
    phase8 = run_phase8(torch, dev, mark)
    flash_bwd_checks = check_flash_bwd(torch, dev)
    mark("9a")
    corpus = train_corpus(get_config("smollm-135m").vocab)
    train = run_training_phase(torch, dev, corpus)
    mark("9b")
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        run_supervisor_phase(torch, train.pop("model"), train.pop("params"), tmp, corpus)
    torch.cuda.empty_cache()
    mark("9d")
    whisper_train = run_whisper_training(torch, dev, corpus)
    torch.cuda.empty_cache()
    mark("9c")
    ssd_bwd_checks = check_ssd_bwd(torch, dev)
    torch.cuda.empty_cache()
    mark("9e")
    ssm_train = {}
    zamba_corpus = train_corpus(get_config("zamba2-7b").vocab, 16 * SSM_TRAIN_B * SSM_TRAIN_L)
    for arch, tokens, slots, phase in (("mamba2-1.3b", corpus, None, "phase 9f"),
                                       ("zamba2-7b", zamba_corpus, ZAMBA_TRAIN_SLOTS,
                                        "phase 9f zamba2")):
        run = run_training_phase(torch, dev, tokens, arch, b=SSM_TRAIN_B, l=SSM_TRAIN_L,
                                 n_micro=SSM_TRAIN_MICRO, steps=SSM_TRAIN_STEPS,
                                 lr=SSM_TRAIN_LR, slots=slots, phase=phase)
        del run["model"], run["params"]
        ssm_train[arch] = run
        torch.cuda.empty_cache()
    mark("9f")

    # phase 6, its parts marked 6.1 to 6.7
    kernels = time_kernels(torch, cache, keeps, errs, {
        "fused": fused_launches, "rung": rung_launches,
        "steps": {"fused": fused_rep["decode_steps"], "rung": rung_rep["decode_steps"]}})
    mark("6.1 paged")
    kernels += time_bitplane_kernels(torch, dev, errs, fused_launches, per_step,
                                     prefill, decode, round_trip, qs_launches)
    mark("6.2 bitplane")
    kernels.append(time_ssd_kernel(torch, ssd_checks, mamba, zamba))
    mark("6.3 ssd")
    kernels.append(time_flash_kernel(torch, errs["flash_attention"], flash_inputs, zamba,
                                     prefill))
    mark("6.4 flash")
    kernels[-1]["ring"] = time_ring_flash(torch, dev)
    kernels[-1]["ring_dominant_keys"] = check_ring_dominant_keys(torch, dev)
    next(k for k in kernels if k["name"] == "paged_attention_fused")["ring"] = \
        time_ring_paged(torch, dev)
    mark("6.5 ring")
    kernels += time_exp_delta_kernels(torch, exp_delta_span, exp_delta_view, errs,
                                      fused_launches, per_step, round_trip, spans)
    mark("6.6 exp_delta")
    by_name = {k["name"]: k for k in kernels}
    by_name["flash_attention"]["phase8_shapes"] = time_flash_phase8(torch, dev)
    for name, rows in time_paged_phase8(torch, dev).items():
        by_name[name]["phase8_shapes"] = rows
    mark("6.7 phase 8 shapes")
    kernels.append(time_flash_bwd(torch, dev, flash_bwd_checks, train))
    mark("6.8 flash backward")
    kernels.append(time_ssd_bwd(ssd_bwd_checks, ssm_train))
    train_launches = collections.Counter(train["launches"])
    train_launches.update(whisper_train["launches"])
    for run in ssm_train.values():
        train_launches.update(run["launches"])
    for k in kernels:
        # the kernel's launches over phase 3p's three timed runs
        k["launches_phase_3p"] = sum(run["launches"].get(k["name"], 0)
                                     for run in prefix_runs.values())
        # over phase 3s's two sharded runs and phase 7's two ring runs
        k["launches_phase_3s"] = sum(run["launches"].get(k["name"], 0)
                                     for run in sharded_runs.values())
        k["launches_phase_7"] = sum(run["launches"].get(k["name"], 0)
                                    for run in ring["runs"].values())
        # over phase 8: 8a's and 8b's serving runs, 8c's and 8d's prefill
        # and decode steps
        k["launches_phase_8"] = phase8["launches"].get(k["name"], 0)
        # phase 3t's four serving runs; phase 9b's step through the kernels,
        # 9c's three Whisper steps and 9f's two steps through the kernels
        k["launches_phase_3t"] = staged["launches"].get(k["name"], 0)
        k["launches_phase_9"] = train_launches.get(k["name"], 0)
        for key in ("ms", "plain_ms", "bound_ms", "library_ms", "max_abs_err"):
            if key == "library_ms" and k[key] is None and k.get("library") == "none":
                continue  # no single PyTorch call computes this function
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']}: {key} = {k[key]!r}")
        for key in ("device_ms", "plain_device_ms", "library_device_ms"):
            if key in k and not (math.isfinite(k[key]) and k[key] > 0):
                raise AssertionError(f"{k['name']}: the profiler recorded no {key}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its main path")
    log(f"profiler: {len(WINDOW_LOSSES)} windows lost {WINDOW_LOSSES} device records each "
        f"(a repeatable run's first window opens with {REPEATABLE_PAD} pad kernels, the others "
        f"with {PROFILER_PAD}; each closes with half as many); they took "
        f"{sum(WINDOW_SECONDS):.1f} s of host time, the longest {max(WINDOW_SECONDS):.2f} s")
    if INCOMPLETE_WINDOWS:
        raise AssertionError(f"profiler windows lost launches: {INCOMPLETE_WINDOWS}")
    mark("6")
    log(f"seconds since start at the end of each phase: {marks}")
    log(f"decode tok/s: fused {fused_rep['decode_tok_per_s']:.1f}, "
        f"rung {rung_rep['decode_tok_per_s']:.1f}; mixtral-8x7b ({MIXTRAL_LAYERS} layers) "
        f"ring fused {ring['runs']['fused']['rep']['decode_tok_per_s']:.1f}, rung "
        f"{ring['runs']['rung']['rep']['decode_tok_per_s']:.1f}; mamba2-1.3b prefill "
        f"{mamba['prefill_ms']:.2f} ms, decode {mamba['decode_ms']:.3f} ms/step; zamba2-7b "
        f"prefill {zamba['prefill_ms']:.2f} ms, decode {zamba['decode_ms']:.3f} ms/step; "
        f"deepseek-moe-16b fused {phase8['8a']['runs']['fused']['rep']['decode_tok_per_s']:.1f}, "
        f"rung {phase8['8a']['runs']['rung']['rep']['decode_tok_per_s']:.1f}; nemotron-4-15b "
        f"fused {phase8['8b']['runs']['fused']['rep']['decode_tok_per_s']:.1f}, rung "
        f"{phase8['8b']['runs']['rung']['rep']['decode_tok_per_s']:.1f}; llava-next-34b "
        f"({phase8['8c']['layers']} layers) prefill {phase8['8c']['prefill_ms']:.2f} ms, decode "
        f"{phase8['8c']['decode_ms']:.2f} ms/step; whisper-tiny prefill "
        f"{phase8['8d']['prefill_ms']:.2f} ms, decode {phase8['8d']['decode_ms']:.3f} ms/step; "
        f"phase 3t staged {staged['runs']['staged']['rep']['decode_tok_per_s']:.1f} (unstaged "
        f"{staged['runs']['unstaged']['rep']['decode_tok_per_s']:.1f}), padded "
        f"{staged['runs']['padded']['rep']['decode_tok_per_s']:.1f} (bucketed "
        f"{staged['runs']['bucketed']['rep']['decode_tok_per_s']:.1f}); smollm-135m training "
        f"{train['host_ms']:.1f} ms a step, {train['tokens_per_s']:.0f} tokens/s; "
        + "; ".join(f"{arch} training {r['host_ms']:.1f} ms a step, {r['tokens_per_s']:.0f} "
                    f"tokens/s" for arch, r in ssm_train.items())
        + f"; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
