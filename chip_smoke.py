#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It needs a CUDA device and ``nvcc`` (on
PATH or under ``$CUDA_HOME/bin``); without a GPU, or without the port's
sources next to it, it exits non-zero and prints no result.  It imports
nothing of JAX and nothing of the JAX package ``repro``.

Phases (any failure exits non-zero; no phase's error is caught):

1. The card's name and power limit; build the three kernel libraries
   from ``src/repro_torch/csrc`` (paged attention, bit-plane pack/unpack,
   bit-plane matmul; one ``nvcc`` each, all started together) and report
   the build times and ptxas register lines.
2. Each kernel against its plain PyTorch version on the card.  Paged
   attention at the serving shapes of full-width SmolLM-135M (B=8,
   S=1024, Hkv=3, rep=3, hd=64): mixed plane counts {8, 12, 16} with
   keep-0 pages, ragged valid lengths and one row with nothing valid.
   Pack and unpack bit for bit at the decode token rows, one slot's full
   cache per layer (keep 16, 12, 8, 4) and an odd length; the bit-plane
   matmul at the quickstart's shape and every SmolLM-135M projection.
3. Serve 16 requests through ``ContinuousScheduler`` on full-width
   SmolLM-135M (random weights from a seeded ``torch.Generator``, 30
   layers) with bit-plane device KV and a precision ladder, once through
   the fused kernel and once through the rung kernel, with launch counts
   reset before and read after each run (attention, pack and unpack
   kernels); a torch.profiler window of steady decode steps (device
   kernel time against host wall time, and launches per decode step);
   the launches of one prefill chunk; then one teacher-forced decode step
   from a snapshot of the serving cache, three ways (fused, rung, plain),
   whose logits must agree.
4. The paper-pipeline quickstart (``repro_torch.quickstart``) on the card,
   launch counts reset before and read after: its byte counts must equal
   the CPU run's and its matmul error the plain version's.
5. Kernel times (CUDA events) beside their bound, the plain version's
   time and one PyTorch call's where one computes the same function,
   printed as one ``{"kernels": [...]}`` line.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

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

SOURCES = ("paged_attention.cu", "bitplane.cu", "bitplane_matmul.cu")

B, S, HKV, REP, HD, BITS = 8, 1024, 3, 3, 64, 16
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
# Quickstart: the top-8-plane matmul's relative error on the card against
# the CPU run's (float32 norms of sums taken in another order).
QUICKSTART_REL_TOL = 1e-3
# Full-width SmolLM-135M projections (K, N): q/o, k/v, gate/in, out
PROJECTIONS = [(576, 576), (576, 192), (576, 1536), (1536, 576)]


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
    from repro_torch.kernels.paged_attention import kernel as K

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
    for mod in (K, BK, MK):
        mod._library()
    log(f"phase 1: {len(SOURCES)} libraries built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")


def device_ms(fn, match: str = "", iters: int = 50) -> float:
    """Device time per call of ``fn(i)``: the summed time of the CUDA
    kernels whose name contains ``match`` (all of them when empty) in a
    torch.profiler window of ``iters`` calls.  Unlike CUDA events around
    back-to-back calls, it leaves out the gaps in which the host was still
    issuing the next launch."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(iters):
            fn(i)
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and match in e.key)
    return total_us / iters / 1e3


def random_case(torch, dev, gen):
    """Kernel inputs at the serving shapes: packed planes of random bf16 KV,
    mixed keeps {8, 12, 16} with keep-0 pages, ragged valid lengths, and
    row 3 with nothing valid."""
    from repro_torch.kernels.paged_attention.ref import pack_kv_ref

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q = randn(B, HKV, REP, HD)
    kp = pack_kv_ref(randn(B, S, HKV, HD))
    vp = pack_kv_ref(randn(B, S, HKV, HD))
    choice = torch.tensor([0, 8, 12, 16, 16], device=dev, dtype=torch.int32)
    keeps = choice[torch.randint(0, 5, (B, S // 16), generator=gen, device=dev)]
    valid = torch.tensor([1024, 700, 333, 0, 17, 1000, 512, 64], device=dev)
    tok_keep = keeps.repeat_interleave(16, dim=1)
    ok = torch.arange(S, device=dev)[None] < valid[:, None]
    mask = (ok & (tok_keep > 0)).to(torch.int8).contiguous()
    return q, kp, vp, keeps.contiguous(), mask, tok_keep


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
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.kernels.paged_attention import ops as O
    from repro_torch.kernels.paged_attention import ref as R

    gen = torch.Generator(device=dev).manual_seed(1)
    q, kp, vp, keeps, mask, tok_keep = random_case(torch, dev, gen)
    errs = {}
    got = K.paged_attention_fused(q, kp, vp, keeps, mask)
    want = R.paged_attention_fused_ref(q, kp, vp, keeps, mask)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL)
    if not (torch.all(got[3] == 0) and torch.all(want[3] == 0)):
        raise AssertionError("fused: the row with nothing valid is not exactly 0")
    errs["paged_attention_fused"] = float((got - want).abs().max())
    parts_k, parts_r = [], []
    for keep in (8, 12, 16):
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
    if not torch.all(merged_k[3] == 0):
        raise AssertionError("rung: the row with nothing valid is not exactly 0")
    errs["paged_attention_rung"] = max(
        float((merged_k - merged_r).abs().max()),
        *(float((a[0] / a[2].clamp(min=1e-30)[..., None]
                 - w[0] / w[2].clamp(min=1e-30)[..., None]).abs().max())
          for a, w in zip(parts_k, parts_r)))
    log(f"phase 2: kernels match plain on the card; max abs err {errs}")
    return errs


def check_bitplane_kernels(torch, dev) -> dict:
    """Pack and unpack bit for bit, the matmul within MATMUL_ATOL/RTOL,
    each against its plain version on the same CUDA inputs."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane import ref as BR
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.bitplane_matmul import ops as MM
    from repro_torch.kernels.bitplane_matmul import ref as MR

    gen = torch.Generator(device=dev).manual_seed(3)
    # decode token rows, one slot's full cache per layer, a length that is
    # a multiple of 8 but not of the reference's 32768-value block
    for m in (B * HKV * HD, S * HKV * HD, 8 * 12345):
        u = torch.randint(0, 2**16, (m,), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16)
        planes = BK.pack(u, BITS)
        if not torch.equal(planes, BR.pack_ref(u, BITS)):
            raise AssertionError(f"bitplane_pack differs from plain at m={m}")
        for keep in (16, 12, 8, 4):
            got = BK.unpack(planes[:keep].contiguous(), BITS, keep, torch.int16)
            if not torch.equal(got, BR.unpack_ref(planes, BITS, keep, torch.int16)):
                raise AssertionError(f"bitplane_unpack differs from plain at m={m}, keep={keep}")
    errs = {"bitplane_pack": 0.0, "bitplane_unpack": 0.0}
    worst = 0.0
    for m, k, n in [(8, 1024, 1024)] + [(m, k, n) for m in (8, 128) for k, n in PROJECTIONS]:
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        planes = MM.pack_weights(w)
        for keep in (16, 12, 8, 4):
            got = MK.bitplane_matmul(x, planes, keep=keep)
            want = MR.bitplane_matmul_ref(x, planes, keep)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=MATMUL_ATOL, rtol=MATMUL_RTOL)
            worst = max(worst, float((got - want).abs().max()))
    errs["bitplane_matmul"] = worst
    log(f"phase 2: bit-plane kernels match plain on the card (pack/unpack "
        f"bit-exact); bitplane_matmul max abs err {worst:.3g}")
    return errs


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


def serve(torch, model, params, kernel: str) -> tuple:
    """One main-path run: launch counts reset just before, read just after."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.paged_attention import kernel as K
    from repro_torch.serving import ContinuousScheduler

    sched = ContinuousScheduler(model, params, engine_config(kernel))
    reqs = make_requests()
    K.reset_launches()
    BK.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        sched.submit(r)
    sched.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**K.LAUNCHES, **BK.LAUNCHES}
    rep = sched.report()
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
    if not rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0:
        raise AssertionError(
            f"device_bytes_read {rep['device_bytes_read']} != kv_read_device_bytes "
            f"{rep['kv_read_device_bytes']}")
    if not rep["device_bytes_read"] < rep["kv_fetch_logical"]:
        raise AssertionError("the ladder did not cut device reads below full precision")
    log(f"phase 3 [{kernel}]: {len(reqs)} requests, {steps} decode steps, "
        f"{rep['prefill_chunks']} prefill chunks, launches {launches}, decode {rep['decode_tokens']} tok in "
        f"{rep['decode_s']:.3f} s = {rep['decode_tok_per_s']:.1f} tok/s, "
        f"prefill {rep['prefill_tokens']} tok in {rep['prefill_s']:.3f} s, "
        f"wall {wall:.2f} s, "
        f"device_bytes_read {rep['device_bytes_read']}, kv_fetch_logical "
        f"{rep['kv_fetch_logical']}, kv_stored/logical "
        f"{rep['kv_stored_bytes']}/{rep['kv_logical_bytes']}")
    return reqs, rep, launches


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


def profile_decode(torch, model, params, n: int = 8) -> dict:
    """Where a steady decode step's time goes: host wall time per step
    without the profiler, then device kernel time per step (and the top
    kernels) from a torch.profiler window of as many steps.  Eight slots
    decode throughout; no request retires inside either window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.bitplane import kernel as BK
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
    t0 = time.perf_counter()
    for _ in range(n):
        sched.step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    per_step = {k: v / n for k, v in {**K.LAUNCHES, **BK.LAUNCHES}.items()}
    log(f"phase 3 launches per steady decode step: {per_step}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            sched.step()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = [(getattr(e, "self_device_time_total", 0), e.key) for e in rows]
    busy_ms = sum(t for t, _ in dev_us) / n / 1e3
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
    page-store unpacks when a page fills)."""
    from repro_torch.kernels.bitplane import kernel as BK

    c = {k: v.clone() for k, v in cache.items()}
    dev = c["planes"].device
    tokens = (torch.arange(256, device=dev)[None] * 7) % model.cfg.vocab
    BK.reset_launches()
    model.prefill_chunk(params, tokens, c, 0, 0, 255)
    torch.cuda.synchronize()
    launches = dict(BK.LAUNCHES)
    if launches["bitplane_pack"] <= 0 or launches["bitplane_unpack"] <= 0:
        raise AssertionError(f"a prefill chunk ran no pack/unpack kernel: {launches}")
    log(f"phase 3 launches per prefill chunk (model): {launches}")
    return launches


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


def run_quickstart(torch) -> dict:
    """The quickstart entry point on the card, launch counts reset just
    before and read just after; then on the CPU (plain versions) for the
    comparison.  Returns the card run's launches."""
    from repro_torch import quickstart
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane_matmul import kernel as MK

    BK.reset_launches()
    MK.reset_launches()
    t0 = time.perf_counter()
    gpu = quickstart.run("cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {**BK.LAUNCHES, **MK.LAUNCHES}
    for line in gpu["lines"]:
        log(f"phase 4 quickstart: {line}")
    if launches["bitplane_matmul"] != 2 or launches["bitplane_pack"] != 1:
        raise AssertionError(f"quickstart launches {launches}: expected one weight "
                             f"pack and two bit-plane matmuls")
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
    in L2 (the real caller's case)."""
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
    lib_ms = cuda_time_ms(lambda i: F.scaled_dot_product_attention(qd, kd, vd, attn_mask=amask))

    # fused: one launch per layer
    f_ms = cuda_time_ms(lambda i: K.paged_attention_fused(
        q, kps[i % n_layers], vps[i % n_layers], page_keeps, mask), iters=60)
    f_plain = cuda_time_ms(lambda i: R.paged_attention_fused_ref(
        q, kps[i % n_layers], vps[i % n_layers], page_keeps, mask), iters=10)
    f_bytes = kernel_bytes(page_keeps, mask, HKV, hd8) + small + page_keeps.numel() * 4 + out_b
    f_bound, f_by = bound(f_bytes, flops)

    # rung: one launch per member of the rung set per layer; per-launch means
    masks = {k: (mask * (tok_keep == k)).to(torch.int8).contiguous() for k in keeps}
    r_ms = cuda_time_ms(lambda i: [K.paged_attention_rung(
        q, kps[i % n_layers], vps[i % n_layers], masks[k], keep=k) for k in keeps],
        iters=30) / len(keeps)
    r_plain = cuda_time_ms(lambda i: [R.paged_attention_rung_ref(
        q, kps[i % n_layers], vps[i % n_layers], masks[k], k) for k in keeps],
        iters=10) / len(keeps)
    r_bytes = sum(kernel_bytes(page_keeps, masks[k], HKV, hd8, k) for k in keeps) \
        / len(keeps) + small + out_b + 2 * B * HKV * REP * 4
    r_bound, r_by = bound(r_bytes, flops / len(keeps))
    steps = {k: launches[k]["paged_attention_" + k] / launches["steps"][k]
             for k in ("fused", "rung")}
    log(f"phase 5: fused {f_ms:.4f} ms/launch, {steps['fused']:.0f} launches per "
        f"decode step (bound {f_bound:.5f} ms, {f_bytes} B), rung {r_ms:.4f} "
        f"ms/launch, {steps['rung']:.0f} launches per decode step "
        f"(bound {r_bound:.5f} ms), "
        f"plain fused {f_plain:.4f} ms, plain rung {r_plain:.4f} ms, sdpa {lib_ms:.4f} ms; "
        f"valid tokens {int(mask.sum())}, plane map keeps {sorted(set(page_keeps.flatten().tolist()))}")
    src = "src/repro_torch/csrc/paged_attention.cu"
    return [
        {"name": "paged_attention_fused", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_attention/kernel.py:274",
         "launches": launches["fused"]["paged_attention_fused"],
         "max_abs_err": errs["paged_attention_fused"], "ms": f_ms,
         "plain_ms": f_plain, "bound_ms": f_bound, "bound_by": f_by,
         "library_ms": lib_ms},
        {"name": "paged_attention_rung", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/paged_attention/kernel.py:115",
         "launches": launches["rung"]["paged_attention_rung"],
         "max_abs_err": errs["paged_attention_rung"], "ms": r_ms,
         "plain_ms": r_plain, "bound_ms": r_bound, "bound_by": r_by,
         "library_ms": lib_ms},
    ]


def bound_ms(nbytes: float, nflops: float, flops_per_s: float) -> tuple:
    """The least time the card could take: bytes over the HBM rate or
    operations over the peak rate for their type, whichever is larger."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, nflops / flops_per_s * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def time_bitplane_kernels(torch, dev, errs, serve_launches, per_step, prefill,
                          qs_launches) -> list:
    """Pack at the decode token rows (one K or V row per slot, B=8), unpack
    at one slot's full cache per layer (what a prefill chunk unpacks, keep
    16, walking 160 distinct plane buffers so they come from HBM), and the
    matmul at the quickstart's shape at keep 8 (its weight is warm, as in
    the quickstart, which multiplies right after packing).  Each is timed
    twice: CUDA events around back-to-back calls (``ms``; at these sizes
    the host's issue time per call can exceed the kernel's) and the
    profiler's device time of the kernel alone (``device_ms``)."""
    from repro_torch.kernels.bitplane import kernel as BK
    from repro_torch.kernels.bitplane import ref as BR
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.bitplane_matmul import ops as MM
    from repro_torch.kernels.bitplane_matmul import ref as MR

    gen = torch.Generator(device=dev).manual_seed(4)
    m_dec = B * HKV * HD
    rows = [torch.randint(0, 2**16, (m_dec,), generator=gen, device=dev,
                          dtype=torch.int32).to(torch.int16) for _ in range(8)]
    pack = lambda i: BK.pack(rows[i % 8], BITS)  # noqa: E731
    pack_plain = lambda i: BR.pack_ref(rows[i % 8], BITS)  # noqa: E731
    p_ms, p_dev = cuda_time_ms(pack, iters=200), device_ms(pack, "::pack_kernel")
    p_plain, p_plain_dev = cuda_time_ms(pack_plain, iters=50), device_ms(pack_plain)
    # pack and unpack move bits with integer operations and no floating
    # point: their bound is the bytes
    p_bound, p_by = bound_ms(m_dec * 2 + BITS * m_dec // 8, 0, BF16_TENSOR_FLOPS)

    m_slot = S * HKV * HD
    bufs = torch.randint(0, 256, (160, BITS, m_slot // 8), generator=gen,
                         device=dev, dtype=torch.int32).to(torch.uint8)
    unpack = lambda i: BK.unpack(bufs[i % 160], BITS, BITS, torch.int16)  # noqa: E731
    unpack_plain = lambda i: BR.unpack_ref(bufs[i % 160], BITS, BITS, torch.int16)  # noqa: E731
    u_ms, u_dev = cuda_time_ms(unpack, iters=320), device_ms(unpack, "::unpack_kernel", 160)
    u_plain, u_plain_dev = cuda_time_ms(unpack_plain, iters=20), device_ms(unpack_plain, "", 20)
    u_bound, u_by = bound_ms(BITS * m_slot // 8 + m_slot * 2, 0, BF16_TENSOR_FLOPS)

    mm_m, mm_k, mm_n, keep = 8, 1024, 1024, 8
    w = (torch.randn((mm_k, mm_n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    x = torch.randn((mm_m, mm_k), generator=gen, device=dev).to(torch.bfloat16)
    planes = MM.pack_weights(w)
    dense = MR.reconstruct_ref(planes, keep)
    matmul = lambda i: MK.bitplane_matmul(x, planes, keep=keep)  # noqa: E731
    matmul_plain = lambda i: MR.bitplane_matmul_ref(x, planes, keep)  # noqa: E731
    matmul_lib = lambda i: torch.matmul(x, dense)  # noqa: E731
    mm_ms, mm_dev = cuda_time_ms(matmul, iters=100), device_ms(matmul, "bitplane_matmul_kernel")
    mm_plain, mm_plain_dev = cuda_time_ms(matmul_plain, iters=20), device_ms(matmul_plain, "", 20)
    mm_lib, mm_lib_dev = cuda_time_ms(matmul_lib, iters=100), device_ms(matmul_lib)
    mm_bytes = keep * mm_k * mm_n // 8 + mm_m * mm_k * 2 + mm_m * mm_n * 4
    mm_bound, mm_by = bound_ms(mm_bytes, 2 * mm_m * mm_k * mm_n, BF16_TENSOR_FLOPS)
    log(f"phase 5 (ms per call, CUDA events / profiler device time): bitplane_pack "
        f"{p_ms:.4f} / {p_dev:.4f} at m={m_dec} (bound {p_bound:.6f}, plain "
        f"{p_plain:.4f} / {p_plain_dev:.4f}); bitplane_unpack {u_ms:.4f} / {u_dev:.4f} "
        f"at m={m_slot} keep 16 (bound {u_bound:.6f}, plain {u_plain:.4f} / "
        f"{u_plain_dev:.4f}); bitplane_matmul {mm_ms:.4f} / {mm_dev:.4f} at "
        f"({mm_m},{mm_k})x({mm_k},{mm_n}) keep {keep} (bound {mm_bound:.6f}, "
        f"{mm_bytes} B; plain {mm_plain:.4f} / {mm_plain_dev:.4f}, torch.matmul over "
        f"the dense bf16 weight {mm_lib:.4f} / {mm_lib_dev:.4f})")
    src = "src/repro_torch/csrc/bitplane.cu"
    return [
        {"name": "bitplane_pack", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bitplane/kernel.py:53",
         "launches": serve_launches["bitplane_pack"],
         "launches_per_decode_step": per_step["bitplane_pack"],
         "launches_per_prefill_chunk": prefill["bitplane_pack"],
         "max_abs_err": errs["bitplane_pack"], "ms": p_ms, "device_ms": p_dev,
         "plain_ms": p_plain, "plain_device_ms": p_plain_dev,
         "bound_ms": p_bound, "bound_by": p_by, "library_ms": None,
         "library": "none"},
        {"name": "bitplane_unpack", "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/bitplane/kernel.py:73",
         "launches": serve_launches["bitplane_unpack"],
         "launches_per_decode_step": per_step["bitplane_unpack"],
         "launches_per_prefill_chunk": prefill["bitplane_unpack"],
         "max_abs_err": errs["bitplane_unpack"], "ms": u_ms, "device_ms": u_dev,
         "plain_ms": u_plain, "plain_device_ms": u_plain_dev,
         "bound_ms": u_bound, "bound_by": u_by, "library_ms": None,
         "library": "none"},
        {"name": "bitplane_matmul", "route": "cuda",
         "source": "src/repro_torch/csrc/bitplane_matmul.cu",
         "replaces": "src/repro/kernels/bitplane_matmul/kernel.py:49",
         "launches": qs_launches["bitplane_matmul"],
         "launches_per_quickstart_run": qs_launches["bitplane_matmul"],
         "max_abs_err": errs["bitplane_matmul"], "ms": mm_ms, "device_ms": mm_dev,
         "plain_ms": mm_plain, "plain_device_ms": mm_plain_dev,
         "bound_ms": mm_bound, "bound_by": mm_by, "library_ms": mm_lib,
         "library_device_ms": mm_lib_dev,
         "library": "torch.matmul (dense bf16 weight)"},
    ]


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
    log(nvidia_smi_line())
    build_kernels()

    dev = torch.device("cuda")
    errs = check_kernels(torch, dev)
    errs.update(check_bitplane_kernels(torch, dev))

    cfg = get_config("smollm-135m")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    fused_reqs, fused_rep, fused_launches = serve(torch, model, params, "fused")
    rung_reqs, rung_rep, rung_launches = serve(torch, model, params, "rung")
    same = sum(a == b for fr, rr in zip(fused_reqs, rung_reqs)
               for a, b in zip(fr.output, rr.output))
    total = sum(len(r.output) for r in fused_reqs)
    log(f"phase 3: fused and rung runs agree on {same}/{total} greedy tokens "
        f"({same / total:.3f})")
    per_step = profile_decode(torch, model, params)
    cache, tok, keeps = snapshot(torch, model, params)
    prefill = prefill_chunk_launches(torch, model, params, cache)
    teacher_forced(torch, model, params, cache, tok, keeps)
    qs_launches = run_quickstart(torch)

    kernels = time_kernels(torch, cache, keeps, errs, {
        "fused": fused_launches, "rung": rung_launches,
        "steps": {"fused": fused_rep["decode_steps"], "rung": rung_rep["decode_steps"]}})
    kernels += time_bitplane_kernels(torch, dev, errs, fused_launches, per_step,
                                     prefill, qs_launches)
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
    log(f"decode tok/s: fused {fused_rep['decode_tok_per_s']:.1f}, "
        f"rung {rung_rep['decode_tok_per_s']:.1f}; total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
