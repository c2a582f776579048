#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and ``nvcc`` (on
PATH or under ``$CUDA_HOME/bin``); without a GPU, or without the port's
sources next to it, it exits non-zero and prints no result.  It imports
nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure exits non-zero; no phase's error is caught):

1. The card's name and power limit; build the six kernel libraries
   from ``src/repro_torch/csrc`` (paged attention, bit-plane pack/unpack,
   bit-plane matmul, the SSD scan, flash attention, exponent-delta
   encode/decode; one ``nvcc`` each, all started together) and report the
   build times and ptxas register lines.
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
6. Kernel times (CUDA events and profiler device time) beside their
   bound, the plain version's time and one PyTorch call's where one
   computes the same function (device time too for the paged rows and the
   matmul), printed as one ``{"kernels": [...]}`` line (nine rows: every
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
   device times cover them all.

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
import time
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
           "flash_attention.cu", "exp_delta.cu")

B, S, HKV, REP, HD, BITS = 8, 1024, 3, 3, 64, 16
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
    log(f"phase 1: {len(SOURCES)} libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


# A torch.profiler window on the card loses the device records of its
# first few kernel launches, and now and then of its first few hundred
# (matched launch by launch, as below; the cause lies inside the profiler
# and is not known).  So every window opens with PROFILER_PAD short sleep
# kernels, which its rows leave out, and is complete when every launch
# after them has its device record and it holds as many launches of each
# expected kernel as were made.  WINDOW_LOSSES keeps how many records each
# window lost; an incomplete window is logged and kept in
# INCOMPLETE_WINDOWS, and phase 6 fails on any.
PROFILER_PAD = 4096
INCOMPLETE_WINDOWS: list = []
WINDOW_LOSSES: list = []


def profile_window(run, what: str) -> tuple:
    """A torch.profiler window, host and device activity traced, around
    ``run()`` and a synchronise, opened with the pad kernels.  Each kernel
    launch the host traced is matched to its device record by correlation
    id; a lost record is allowed only among the pads.  Returns the
    profiler, its events and the fault (None when complete)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(1)
        run()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sorted((e for e in events if e.device_type == cpu and "LaunchKernel" in e.name),
                      key=lambda e: e.time_range.start)
    recorded = {e.id for e in events if e.device_type == cuda}
    lost = [i for i, e in enumerate(launches) if e.id not in recorded]
    WINDOW_LOSSES.append(len(lost))
    fault = None
    if len(launches) <= PROFILER_PAD or (lost and lost[-1] >= PROFILER_PAD):
        fault = (f"{len(launches)} launches traced, {len(lost)} records lost, the last "
                 f"at launch {lost[-1] if lost else None} (the pads are 0 to {PROFILER_PAD - 1})")
    return prof, events, fault


def incomplete(what: str, fault: str) -> None:
    INCOMPLETE_WINDOWS.append((what, fault))
    log(f"profiler: the window over {what} is incomplete ({fault})")


def device_rows(run, what: str, expect: dict | None = None) -> list:
    """The device rows (``key_averages``) of a ``profile_window`` around
    ``run()``, the pad kernels left out.  ``expect`` maps a kernel-name
    fragment to the launches the window must hold."""
    import torch

    prof, _, fault = profile_window(run, what)
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key]
    got = {m: sum(e.count for e in rows if m in e.key) for m in expect or {}}
    if fault is None and got != (expect or {}):
        fault = f"launches recorded {got}, made {expect}"
    if fault:
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
    fn(0)

    def run():
        for i in range(iters):
            fn(i)

    rows = [e for e in device_rows(run, match or "a plain call",
                                   {match: iters * per_call} if match else None)
            if match in e.key]
    return sum(e.self_device_time_total for e in rows) / iters / 1e3


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
        from repro_torch.kernels.bitplane import kernel as BK
        from repro_torch.kernels.exp_delta import kernel as EK
        from repro_torch.kernels.flash_attention import kernel as FK
        from repro_torch.kernels.paged_attention import kernel as K

        mods = (K, BK, FK, EK)
        saved = [dict(m.LAUNCHES) for m in mods]
        c = {k: v.clone() for k, v in cache.items()}
        c["len"] = cache["len"] - 1
        with plain_attention():
            plain, _ = self.orig(params, token, c, keeps=keeps, decode_kernel=decode_kernel)
        for m, s in zip(mods, saved):
            m.LAUNCHES.update(s)
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


def check_fused_against_rung(torch, fused_reqs, rung_reqs, first, fw, rw) -> None:
    """Phase 3's check of the two serving runs, from their check runs'
    watches.  Up to each request's first divergent output both fed the same
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

    split, faults = {}, []
    for rid, j in keys:  # in output order per request
        if rec[(rid, j)][4] and rid not in split:
            split[rid] = j
    outputs = {fr.rid: (fr.output, rr.output) for fr, rr in zip(fused_reqs, rung_reqs)}
    worst_plain = 0.0
    for (rid, j), (d_fp, s_fp, d_rp, s_rp, top_pf, top_pr) in zip(div, vs_plain):
        d, scale, gap_f, gap_r, _ = rec[(rid, j)]
        fo, ro = outputs[rid]
        moved = [name for name, tok, top in (("fused", fo[j], top_pf), ("rung", ro[j], top_pr))
                 if tok != int(top)]
        worst_plain = max(worst_plain, d_fp / s_fp, d_rp / s_rp)
        log(f"phase 3 divergence: request {rid} at output {j}/{len(fo)}: tokens fused {fo[j]} "
            f"rung {ro[j]}, plain on each run's cache {int(top_pf)} / {int(top_pr)} (left its "
            f"plain top: {', '.join(moved) or 'neither'}); top-2 gap fused {gap_f:.5f} rung "
            f"{gap_r:.5f}; max|fused-rung| {d:.5f} (tolerance {LOGITS_RTOL_OF_MAX * scale:.5f}), "
            f"max|fused-plain| {d_fp:.5f} ({LOGITS_RTOL_OF_MAX * s_fp:.5f}), max|rung-plain| "
            f"{d_rp:.5f} ({LOGITS_RTOL_OF_MAX * s_rp:.5f}); plane maps "
            + (f"differ since output {split[rid]}" if rid in split else "equal at every step"))
        if d_fp > LOGITS_RTOL_OF_MAX * s_fp or d_rp > LOGITS_RTOL_OF_MAX * s_rp:
            faults.append(("kernel vs plain", rid, j, d_fp, d_rp))
    clean = [key for key in keys if key[0] not in split or key[1] < split[key[0]]]
    worst = max((rec[key][0] / rec[key][1] for key in clean), default=0.0)
    faults += [("fused vs rung", *key, rec[key][0], LOGITS_RTOL_OF_MAX * rec[key][1])
               for key in clean if rec[key][0] > LOGITS_RTOL_OF_MAX * rec[key][1]]
    prefix = [first.get(fr.rid, len(fr.output)) for fr in fused_reqs]
    log(f"phase 3: first divergent output per request (agreeing prefix lengths) {prefix}; "
        f"{sum(rid not in split for rid in first)} first divergences on equal plane maps, "
        f"{sum(rid in split for rid in first)} after the maps split; {len(clean)} of "
        f"{len(keys)} decode rows with equal history read equal plane maps, max "
        f"|fused-rung| / max|logit| over them {worst:.5f}; at the {len(div)} first "
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
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.exp_delta import kernel as EK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config(kernel))
    reqs = make_requests()
    K.reset_launches()
    BK.reset_launches()
    FK.reset_launches()
    EK.reset_launches()
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
    launches = {**K.LAUNCHES, **BK.LAUNCHES, **FK.LAUNCHES, **EK.LAUNCHES}
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


def phase3_digest(reqs, rep) -> str:
    """A digest of a serving run's greedy tokens and its integer counters
    (bytes, pages, steps: everything but times and rates), equal for two
    runs that generated and moved the same."""
    import hashlib

    counters = {k: v for k, v in sorted(rep.items())
                if isinstance(v, int) and not isinstance(v, bool)}
    text = json.dumps([[list(map(int, r.output)) for r in reqs], counters])
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def teacher_forced(torch, model, params, cache, tok, keeps) -> None:
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
    log(f"phase 3 teacher-forced: max|logit| {scale:.4f}, max|fused-plain| {d_fp:.5f}, "
        f"max|rung-plain| {d_rp:.5f}, tolerance {tol:.5f}, fused/plain argmax agree {agree:.3f}")
    if not (d_fp <= tol and d_rp <= tol):
        raise AssertionError("teacher-forced logits disagree across fused/rung/plain")


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
    FO.flash_attention = lambda q, k, v, *, q_pos, kv_valid, causal=True, window=0: \
        FR.flash_attention_ref(q, k, v, q_pos=q_pos, kv_valid=kv_valid, causal=causal,
                               window=window, chunk=chunk or 512)
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
                               "a Mamba2 prefill")
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
                                **{name: n_mamba for name in SSD_KERNELS}})
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
    rows = device_rows(lambda: fn(0), f"one call ({match})")
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
        lib_names = sorted({e.key for e in device_rows(lambda: lib(0), "one SDPA call")})
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
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(), kv_valid.data_ptr(),
        out.data_ptr(), None, b, sq, k.shape[1], hp, k.shape[2], hd, 1, 0, p["tokens"], 1,
        p["key_tiles"], torch.cuda.current_stream(q.device).cuda_stream)
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
    for (sq, start, end), n in sorted(chunks.items()):
        q = torch.randn((1, sq, hp, hd), generator=gen, device=dev).to(torch.bfloat16)
        pos = (start + torch.arange(sq, device=dev, dtype=torch.int32))[None].contiguous()
        kv_valid = torch.full((1,), end, dtype=torch.int32, device=dev)
        p = FK.plan(1, sq, S, hp, hkv, hd, end)
        run = lambda i: FK.flash_attention(q, k, v, pos, kv_valid, causal=True, window=0,  # noqa: E731,B023
                                           valid=end)
        whole = lambda i: flash_unsplit(torch, q, k, v, pos, kv_valid)  # noqa: E731,B023
        want = FR.flash_attention_ref(q, k, v, q_pos=pos, kv_valid=end)
        for fn in (run, whole):
            got = fn(0)
            steps = row_bf16_steps(got, want)
            if not (torch.isfinite(got.float()).all() and steps <= FLASH_BF16_STEPS):
                raise AssertionError(f"flash kernel differs from plain at chunk {sq} at {start}")
        per_call = 1 + (p["splits"] > 1)
        t_plan = device_ms(run, "flash_attention_", 20, per_call)
        t_whole = device_ms(whole, "flash_attention_", 20)
        b_ms, b_by = bound_ms(2 * (2 * q.numel() + 2 * end * hkv * hd),
                              flash_work(pos, kv_valid, hp, hd, causal=True, window=0),
                              BF16_TENSOR_FLOPS)
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
        f"{phase3_digest(fused_reqs, fused_rep)}, rung {phase3_digest(rung_reqs, rung_rep)}")
    first = first_divergences(fused_reqs, rung_reqs)
    checks = {}
    for kernel, timed in (("fused", (fused_reqs, fused_rep)), ("rung", (rung_reqs, rung_rep))):
        c_reqs, c_rep, _, watch, ledger = serve(torch, model, params, kernel, first)
        check_repeat(kernel, timed, (c_reqs, c_rep))
        checks[kernel] = (c_rep, ledger, watch)
    check_fused_against_rung(torch, fused_reqs, rung_reqs, first, checks["fused"][2],
                             checks["rung"][2])
    check_write_drift(checks["fused"][:2], checks["rung"][:2])
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
    qs_launches = run_quickstart(torch)
    mark("4")
    del model, params
    mamba = run_mamba(torch, dev)
    torch.cuda.empty_cache()
    mark("5")
    zamba = run_zamba(torch, dev)
    torch.cuda.empty_cache()
    mark("5b")

    kernels = time_kernels(torch, cache, keeps, errs, {
        "fused": fused_launches, "rung": rung_launches,
        "steps": {"fused": fused_rep["decode_steps"], "rung": rung_rep["decode_steps"]}})
    kernels += time_bitplane_kernels(torch, dev, errs, fused_launches, per_step,
                                     prefill, decode, round_trip, qs_launches)
    kernels.append(time_ssd_kernel(torch, ssd_checks, mamba, zamba))
    kernels.append(time_flash_kernel(torch, errs["flash_attention"], flash_inputs, zamba,
                                     prefill))
    kernels += time_exp_delta_kernels(torch, exp_delta_span, exp_delta_view, errs,
                                      fused_launches, per_step, round_trip, spans)
    for k in kernels:
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
    log(f"profiler: {len(WINDOW_LOSSES)} windows lost the device records of their first "
        f"{WINDOW_LOSSES} launches (each opens with {PROFILER_PAD} pad kernels)")
    if INCOMPLETE_WINDOWS:
        raise AssertionError(f"profiler windows lost launches: {INCOMPLETE_WINDOWS}")
    mark("6")
    log(f"seconds since start at the end of each phase: {marks}")
    log(f"decode tok/s: fused {fused_rep['decode_tok_per_s']:.1f}, "
        f"rung {rung_rep['decode_tok_per_s']:.1f}; mamba2-1.3b prefill "
        f"{mamba['prefill_ms']:.2f} ms, decode {mamba['decode_ms']:.3f} ms/step; zamba2-7b "
        f"prefill {zamba['prefill_ms']:.2f} ms, decode {zamba['decode_ms']:.3f} ms/step; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
