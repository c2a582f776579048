"""The card scripts' own logic on the CPU: ``chip_smoke.py``'s phase-3 check
of the fused and rung serving runs (check runs, ``DecodeWatch``, the
comparison at each first divergence) on a small model, where the kernel
wrappers run their plain versions; ``bitplane_matmul_ablation.py``'s
isolation and refusal without a GPU; and the flash rows' helpers (phase
3's prefill chunks, the SDPA backend's name, the split case and the chunk
shapes)."""

import ast
import dataclasses
import math
import contextlib
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.kernels import _build
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402


def _requests(vocab):
    rng = np.random.default_rng(0)
    return [Request(rid=i, max_new_tokens=int(rng.integers(6, 12)),
                    prompt=rng.integers(0, vocab, int(rng.integers(20, 60))).astype(np.int32))
            for i in range(6)]


@pytest.fixture(scope="module")
def small():
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    return model, model.init(torch.Generator().manual_seed(0))


def _serve(model, params, kernel, first=None):
    """A serving run as phase 3 makes it, on the CPU and at a small size;
    with ``first``, a check run under the watch and the write ledger."""
    sched = ContinuousScheduler(model, params, EngineConfig(
        max_batch=4, max_ctx=128, ladder=PrecisionLadder(C.LADDER), codec="lz4",
        device_kv="bitplane", decode_kernel=kernel, backend="paged"), device="cpu")
    reqs = _requests(model.cfg.vocab)
    watch = ledger = None
    with contextlib.ExitStack() as stack:
        if first is not None:
            ledger = stack.enter_context(C.write_job_ledger())
            watch = stack.enter_context(C.DecodeWatch(torch, model, sched, first))
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
    rep = {**sched.report(), "engine_jobs_cancelled": sched.stats["engine_jobs_cancelled"]}
    return reqs, rep, watch, ledger


@pytest.fixture(scope="module")
def phase3(small):
    """Timed and check runs of both kernels.  On the CPU both routes run the
    same plain attention, so no request diverges; the check's first
    divergences are set by hand to drive the comparison there."""
    model, params = small
    timed = {k: _serve(model, params, k)[:2] for k in ("fused", "rung")}
    first = C.first_divergences(timed["fused"][0], timed["rung"][0])
    forced = {0: 3, 2: 5, 4: 1}
    checks = {k: _serve(model, params, k, forced) for k in ("fused", "rung")}
    return timed, first, forced, checks


def test_check_runs_repeat_the_timed_runs_and_pass(phase3):
    timed, first, forced, checks = phase3
    assert first == {}
    for k in ("fused", "rung"):
        C.check_repeat(k, timed[k], checks[k][:2])
        assert set(checks[k][2].plain) == set(forced.items())
    C.check_fused_against_rung(torch, timed["fused"][0], timed["rung"][0], forced,
                               checks["fused"][2], checks["rung"][2])
    C.check_write_drift(checks["fused"][1::2], checks["rung"][1::2])


@pytest.mark.parametrize("fault", ["rung row off its plain row", "fused row off the rung row"])
def test_check_fails_on_a_row_beyond_the_bound(phase3, fault):
    """A run's row moved by more than the bound fails the check: at a first
    divergence against its own plain row, and before it against the other
    run's row on equal plane maps."""
    timed, _, forced, checks = phase3
    fw, rw = checks["fused"][2], checks["rung"][2]
    # request 2's first divergence is output 5; output 4 comes before it
    watch, key = (rw, (2, 5)) if fault.startswith("rung") else (fw, (2, 4))
    call, row = watch.rows[key]
    logits = watch.logits
    saved = logits[call]
    logits[call] = saved.clone()
    logits[call][row, 0] += 0.2 * saved[row].abs().max() + 1.0
    try:
        with pytest.raises(AssertionError, match="beyond the bound"):
            C.check_fused_against_rung(torch, timed["fused"][0], timed["rung"][0], forced,
                                       fw, rw)
    finally:
        logits[call] = saved


def test_check_repeat_fails_when_a_token_differs(phase3):
    timed, _, _, checks = phase3
    reqs, rep = checks["rung"][:2]
    changed = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
               for r in reqs]
    for a, b in zip(changed, reqs):
        a.output = list(b.output)
    changed[1].output[-1] += 1
    with pytest.raises(AssertionError, match="did not repeat"):
        C.check_repeat("rung", timed["rung"], (changed, rep))


def test_build_key_covers_extra_flags():
    plain = _build.library_path("bitplane_matmul.cu")
    ablated = _build.library_path("bitplane_matmul.cu", ("-DBPM_ABLATE=1",))
    assert plain != ablated and plain.parent == ablated.parent


def test_ablation_script_imports_nothing_of_jax_or_the_reference():
    tree = ast.parse((REPO / "bitplane_matmul_ablation.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


def test_ablation_script_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is for CPU-only hosts")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "bitplane_matmul_ablation.py")],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert '"rows"' not in proc.stdout


def test_serving_chunks_are_the_scheduler_cut_of_phase_3_requests():
    """Phase 6's serving mix is every prefill chunk of phase 3's requests:
    each prompt cut from 0 to its end in buckets of the scheduler's ladder,
    the first chunk at 0."""
    from repro_torch.serving.scheduler import prefill_buckets

    chunks = C.serving_chunks()
    reqs = C.make_requests()
    assert sum(chunks.values()) > len(reqs)
    assert sum(n for (_, start, _), n in chunks.items() if start == 0) == len(reqs)
    ends = sorted(end for (_, _, end), n in chunks.items() for _ in range(n))
    assert set(len(r.prompt) for r in reqs) <= set(ends)
    for (bucket, start, end), n in chunks.items():
        assert bucket in prefill_buckets(C.S) and 0 < end - start <= bucket and end <= C.S
    covered = sum(n * (end - start) for (_, start, end), n in chunks.items())
    assert covered == sum(len(r.prompt) for r in reqs)


def test_serving_mix_takes_the_split_and_the_serial_path():
    """Over phase 3's prefill chunks the launch plan splits the keys of
    the long-offset ones and walks the short ones in one range."""
    from repro_torch.kernels.flash_attention import kernel as FK

    plans = {c: FK.plan(1, c[0], C.S, 9, 3, C.HD, c[2]) for c in C.serving_chunks()}
    assert any(p["splits"] > 1 for p in plans.values())
    assert any(p["splits"] == 1 for p in plans.values())
    for (_, _, end), p in plans.items():
        assert (p["splits"] > 1) == (-(-end // FK.KEYS) >= FK.SPLIT_TILES)


@pytest.mark.parametrize("names,backend", [
    (["cudnn_generated_fort_native_sdpa_sm90_flash_fprop_wgmma_f16"], "cudnn"),
    (["void pytorch_flash::flash_fwd_kernel<Flash_fwd_kernel_traits>"], "flash"),
    (["fmha_cutlassF_bf16_aligned_64x64_rf_sm80"], "efficient"),
    (["void at::native::elementwise_kernel<128, 4>", "Memset (Device)"], "math"),
])
def test_sdpa_backend_is_named_from_its_kernels(names, backend):
    assert C.sdpa_backend(names) == backend


def test_flash_cases_hold_a_split_launch_and_chunks_match_the_serving_slot():
    """Phase 2 checks launches whose keys are split and merged and launches
    that are not; phase 6's chunk rows are SmolLM prefill chunks, the first
    of a prompt unsplit, the later ones split below their kv_valid."""
    from repro_torch.kernels.flash_attention import kernel as FK

    plans = [FK.plan(b, sq, skv, hp, hkv, hd, valid)
             for b, sq, skv, hp, hkv, hd, _, valid, *_ in C.FLASH_CASES]
    assert any(p["splits"] > 1 for p in plans) and any(p["splits"] == 1 for p in plans)
    for sq, skv, start, valid in C.FLASH_CHUNKS:
        assert start + sq <= skv and start < valid <= skv
        assert (FK.plan(1, sq, skv, 9, 3, C.HD, valid)["splits"] > 1) == (start > 0)


@pytest.mark.parametrize("shape,nbytes,causal,tc_ms,f32_ms,byte_ms", [
    # Mamba2-1.3B prefill: b and c read for one group
    (C.SSD_MAMBA, 156_237_824, 21_525_168_128, 0.1305, 0.3213, 0.0466),
    # Zamba2-7B prefill: two groups
    (C.SSD_ZAMBA, 489_160_704, 45_214_597_120, 0.2740, 0.6748, 0.1460),
])
def test_ssd_work_counts_b_and_c_per_group(shape, nbytes, causal, tc_ms, f32_ms, byte_ms):
    """Phase 6's SSD bound: the bytes read b and c per group, and the
    3xTF32 tensor-core bound (three times the causal operations at 495
    TFLOP/s) beside the float32 CUDA-core one (67 TFLOP/s)."""
    bsz, l, h, p, n, g = shape
    got_bytes, products, full = C.ssd_work(bsz, l, h, p, n, 256, g)
    assert (got_bytes, sum(products)) == (nbytes, causal) and full > causal
    b = C.ssd_bounds(got_bytes, products)
    assert b["bound_ms"] == pytest.approx(tc_ms, abs=5e-5) and b["bound_by"] == "operations"
    assert b["f32_bound_ms"] == pytest.approx(f32_ms, abs=5e-5)
    assert b["bound_flops"] == 3 * causal and b["bound_bytes"] == nbytes
    assert b["causal_flops"] == causal
    assert got_bytes / C.HBM_BYTES_PER_S * 1e3 == pytest.approx(byte_ms, abs=5e-5)
    # per head, b and c would take H / G times their bytes
    per_head, _, _ = C.ssd_work(bsz, l, h, p, n, 256, h)
    assert per_head - got_bytes == 2 * 4 * bsz * l * (h - g) * n


@pytest.mark.parametrize("shape,block_mflop,f32_ms,bf16_ms", [
    # Mamba2-1.3B prefill (N 128): 63.06 against 42.02 MFLOP a (batch,
    # chunk, head) block
    (C.SSD_MAMBA, (63.062016, 42.024960), 0.1305, 0.0869),
    # Zamba2-7B prefill (N 64)
    (C.SSD_ZAMBA, (37.847040, 27.328512), 0.2740, 0.1979),
])
def test_ssd_bounds_take_the_passes_of_each_product(shape, block_mflop, f32_ms, bf16_ms):
    """The tensor-core bound counts each product at the TF32 passes the
    kernel takes on its inputs: 3xTF32 throughout on drawn float32 b and c;
    on bf16-valued b and c one pass for the scores c.b, three for
    scores.xdt, two for c.state and three for the chunk state.  Both stay
    bound by operations, and the float32 CUDA-core bound does not move."""
    bsz, l, h, p, n, g = shape
    nbytes, products, _ = C.ssd_work(bsz, l, h, p, n, 256, g)
    q, blocks = 256, bsz * h * (l // 256)
    tri = q * (q + 1) // 2
    assert products == (2 * tri * n * blocks, 2 * tri * p * blocks,
                        2 * q * n * p * blocks, 2 * q * n * p * blocks)
    f32 = C.ssd_bounds(nbytes, products, C.SSD_PASSES_F32)
    bf16 = C.ssd_bounds(nbytes, products, C.SSD_PASSES_BF16_BC)
    assert C.SSD_PASSES_F32 == (3, 3, 3, 3) and C.SSD_PASSES_BF16_BC == (1, 3, 2, 3)
    assert f32 == C.ssd_bounds(nbytes, products)
    for b, mflop, ms in ((f32, block_mflop[0], f32_ms), (bf16, block_mflop[1], bf16_ms)):
        assert b["bound_flops"] / blocks / 1e6 == pytest.approx(mflop, abs=1e-6)
        assert b["bound_ms"] == pytest.approx(ms, abs=5e-5) and b["bound_by"] == "operations"
        assert b["bound_ms"] > nbytes / C.HBM_BYTES_PER_S * 1e3
    assert bf16["bound_flops"] == (products[0] + 3 * products[1] + 2 * products[2]
                                   + 3 * products[3])
    assert bf16["f32_bound_ms"] == f32["f32_bound_ms"]
    assert bf16["causal_flops"] == f32["causal_flops"] == sum(products)


def test_ssd_cases_hold_grouped_per_head_and_both_prefills():
    """Phase 2 checks the kernel with b and c per group at both models'
    prefill shapes, per head (the reference's contract), ragged and below
    one chunk; phase 6 times the two prefill shapes."""
    cases = {name: (shape, l, h0) for name, shape, l, h0 in C.ssd_cases()}
    assert cases["mamba2"][0] == C.SSD_MAMBA and cases["zamba2"][0] == C.SSD_ZAMBA
    assert cases["per-head"][0][5] == cases["per-head"][0][2]  # G = H
    assert C.SSD_MAMBA[5] == 1 and C.SSD_ZAMBA[5] == 2
    assert cases["ragged"][1] % 256 and cases["short"][1] < 256 and not cases["short"][2]
    mamba, zamba = get_config("mamba2-1.3b"), get_config("zamba2-7b")
    for cfg, (bsz, l, h, p, n, g) in ((mamba, C.SSD_MAMBA), (zamba, C.SSD_ZAMBA)):
        assert (h, p, n, g) == (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, cfg.ssm_groups)
    assert C.SSD_MAMBA[:2] == (C.SSM_B, C.SSM_L) and C.SSD_ZAMBA[:2] == (C.ZAMBA_B, C.ZAMBA_L)


def test_ssd_case_draws_b_and_c_per_group():
    gen = torch.Generator().manual_seed(0)
    xdt, da, b, c, h0 = C.ssd_case(torch, "cpu", gen, (1, 40, 6, 8, 4, 3), l=20, h0=False)
    assert xdt.shape == (1, 20, 6, 8) and da.shape == (1, 20, 6)
    assert b.shape == c.shape == (1, 20, 3, 4) and h0 is None
    assert bool((da < 0).all())


def test_precision_study_imports_nothing_of_jax_or_the_reference():
    tree = ast.parse((REPO / "ssd_precision_study.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


def test_precision_study_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is for CPU-only hosts")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "ssd_precision_study.py")],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert '"cases"' not in proc.stdout


def test_bitplane_bytes_and_the_cold_bound():
    """Phase 6's byte bounds: the cold shape moves 67 MB at keep 16 (20 us
    at 3.35 TB/s) and three quarters of it at keep 8; the decode append
    reads K, V and the positions and writes 16 planes of both."""
    m = C.COLD_VALUES
    assert C.bitplane_bytes(m, 2, 16) == 67_108_864
    assert C.bound_ms(C.bitplane_bytes(m, 2, 16), 0, C.BF16_TENSOR_FLOPS) == \
        pytest.approx((0.020032, "bytes"), abs=1e-6)
    assert C.bitplane_bytes(m, 2, 8) * 4 == C.bitplane_bytes(m, 2, 16) * 3
    r = C.HKV * C.HD
    assert C.bitplane_bytes(2 * C.B * r, 2, C.BITS) == 2 * C.B * r * 4
    assert C.SPAN_VALUES == 786_432


def _planes(gen, *shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.int32).to(torch.uint8)


def test_parent_routes_do_the_work_of_the_kv_entry_points():
    """Phase 6's yardsticks (the parent's append, chunk append and slot
    unpack, each stream on its own through the flat entry points and an
    indexed or sliced write) leave the same planes and rows as the KV
    entry points' plain versions."""
    from repro_torch.kernels.bitplane import ref as BR

    gen = torch.Generator().manual_seed(0)
    kp, vp = _planes(gen, 16, 4, 64, 3, 8), _planes(gen, 16, 4, 64, 3, 8)
    k, v = (torch.randn((4, 1, 3, 64), generator=gen).to(torch.bfloat16) for _ in range(2))
    lens = torch.tensor([0, 70, 63, -2], dtype=torch.int32)
    want = [kp.clone(), vp.clone()]
    BR.pack_kv_into_ref(k, v, *want, lens)
    C.parent_append(torch, k, v, kp, vp, lens)
    assert torch.equal(kp, want[0]) and torch.equal(vp, want[1])
    k, v = (torch.randn((1, 16, 3, 64), generator=gen).to(torch.bfloat16) for _ in range(2))
    slot = kp.narrow(1, 2, 1), vp.narrow(1, 2, 1)
    want = [t.clone() for t in slot]
    BR.pack_kv_into_ref(k, v, *want, 40)
    C.parent_chunk_append(k, v, *slot, 40)
    assert torch.equal(slot[0], want[0]) and torch.equal(slot[1], want[1])
    got = C.parent_unpack_pair(*slot, 16)
    pair = BR.unpack_kv_pair_ref(*slot, 16)
    assert torch.equal(torch.stack(got).view(torch.int16), pair.view(torch.int16))


def test_phase3_digest_reads_tokens_and_integer_counters_only():
    reqs = _requests(1000)
    for i, r in enumerate(reqs):
        r.output = [i, i + 1]
    rep = {"decode_steps": 5, "kv_stored_bytes": 100, "decode_s": 0.5, "tok_per_s": 3.0,
           "device_kv": "bitplane", "engine": {"x": 1}, "flag": True}
    d = C.phase3_digest(reqs, rep)
    assert d == C.phase3_digest(reqs, {**rep, "decode_s": 9.0, "tok_per_s": 1.0})
    assert d != C.phase3_digest(reqs, {**rep, "kv_stored_bytes": 101})
    reqs[2].output[1] += 1
    assert d != C.phase3_digest(reqs, rep)


def test_expect_launches_is_exact():
    C.expect_launches("x", {"bitplane_pack": 30, "bitplane_unpack": 0, "other": 7},
                      {"bitplane_pack": 30, "bitplane_unpack": 0})
    with pytest.raises(AssertionError, match="expected"):
        C.expect_launches("a prefill chunk", {"bitplane_pack": 60, "bitplane_unpack": 60},
                          {"bitplane_pack": 30, "bitplane_unpack": 30})


def test_bitplane_cases_cover_the_contract():
    """Phase 2 holds the flat kernels at 1-, 2- and 4-byte containers, at
    one octet and at a ragged last plane word, and the decode append at
    clamped positions past S and below 0 and prefill chunks at 0, mid and
    the end; unpack down to keep 0."""
    assert {w for w, _ in C.BITPLANE_WIDTHS} == {1, 2, 4}
    assert 8 in C.BITPLANE_LENGTHS and any((m // 8) % 4 for m in C.BITPLANE_LENGTHS)
    assert len(C.APPEND_POS) == C.B
    assert max(C.APPEND_POS) >= C.S and min(C.APPEND_POS) < 0 and C.S - 1 in C.APPEND_POS
    assert C.CHUNK_STARTS[0] == 0 and C.CHUNK_STARTS[-1] + C.CHUNK == C.S
    assert C.UNPACK_KEEPS == (16, 12, 8, 4, 0)


def test_digest_script_imports_nothing_of_jax_or_the_reference():
    tree = ast.parse((REPO / "phase3_digest.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


def test_digest_script_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is for CPU-only hosts")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "phase3_digest.py"), str(REPO)],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 2
    assert "digest" not in proc.stdout


@pytest.mark.parametrize("kind,shape,group,bits", C.EXP_DELTA_VIEWS)
def test_exp_delta_views_take_the_path_they_name(kind, shape, group, bits):
    """Phase 2's views of the fused cluster-and-encode hold the shapes they
    name, and the encode's plan takes the path phase 2 claims for each: the
    byte path at an unaligned start and at rows of no whole vectors (one
    channel's 2-byte rows with a ragged tail among them), the direct path
    for one channel of whole groups, 16-byte vectors elsewhere."""
    from repro_torch.kernels.exp_delta import kernel as EK

    n = shape[0] * (shape[1] + 8) if kind == "wide" else math.prod(shape) + 1
    u = torch.zeros(n, dtype={8: torch.uint8, 16: torch.int16, 32: torch.int32}[bits])
    view = C.encode_view(u, kind, shape)
    want = {"span": (shape[1], shape[0], *shape[2:]), "reactivated": shape[2:]}
    assert tuple(view.shape) == want.get(kind, shape)
    plan = EK.plan(EK.layout(view, group), u.element_size(), view.data_ptr())
    path = "bytes" if kind in ("offset", "wide") or shape[-1] == 1 else "vec"
    if shape[-1] == 1 and shape[-2] % group == 0:
        path = "direct"
    assert plan["path"] == path


def test_encode_bytes_count_each_value_once():
    """The encode's byte bound: the serving span reads and writes its 786,432
    bf16 values once and writes a base per channel of each of its 256
    pages; a ragged tail's repeated token is read once."""
    span = torch.zeros((2, 4, 512, 192), dtype=torch.int16).transpose(0, 1)
    assert C.encode_bytes(span) == 2 * 2 * 786_432 + 256 * 192 == 3_194_880
    assert C.encode_bytes(torch.zeros((37, 192), dtype=torch.int16)) == \
        37 * 192 * 2 + 3 * 192 * (16 * 2 + 1)


# ---------------------------------------------------------------------------
# Phase 3p on the CPU: shared-prefix pages and weight streaming
# ---------------------------------------------------------------------------

# phase 3p's classes cut to the smoke model's size: shared prefixes of 4
# and 2 pages, one class with none
SMALL_PREFIX_CLASSES = (("chat", 64, (4, 20), (4, 8), 0.6),
                        ("agentic", 32, (4, 12), (6, 10), 0.2),
                        ("longdoc", 0, (40, 70), (2, 4), 0.2))


def _prefix_trace():
    return C.prefix_trace(n=10, max_ctx=192, classes=SMALL_PREFIX_CLASSES)


def _prefix_base():
    return EngineConfig(max_batch=4, max_ctx=192, ladder=PrecisionLadder(C.LADDER),
                        codec="lz4", device_kv="bitplane", decode_kernel="fused",
                        backend="paged")


@pytest.fixture(scope="module")
def prefix_runs(small):
    """Phase 3p's three runs at the smoke size, as ``run_prefix_phase``
    makes them (no profiler window: the CPU has no device time)."""
    model, params = small
    return {name: C.serve_trace(torch, model, params,
                                C.prefix_config(_prefix_base(), sharing, weights),
                                _prefix_trace())
            for name, sharing, weights in (("a", False, "resident"), ("b", True, "resident"),
                                           ("c", True, "compressed"))}


def test_prefix_phase_checks_pass_on_a_small_model(prefix_runs):
    out = C.check_prefix_runs(prefix_runs["a"], prefix_runs["b"], prefix_runs["c"])
    b = prefix_runs["b"]
    assert out["adoptions"] == b["rep"]["prefix"]["requests_matched"] > 0
    assert out["exact"] is not None and out["weight_events"] > 0
    assert out["trace"]["events"] > 0 and out["prometheus_lines"] > 0
    # every registration took one snapshot read, or none where the prefix
    # was already indexed
    assert {r[0] for r in b["prefix"].registrations} <= {0, 1}
    assert C.once_per_layer(prefix_runs["c"]["weight_reads"],
                            prefix_runs["c"]["rep"]["weights"])


def test_prefix_phase_checks_fail_when_a_token_moves(prefix_runs):
    c = dict(prefix_runs["c"])
    c["reqs"] = [Request(rid=r.rid, prompt=r.prompt, max_new_tokens=r.max_new_tokens)
                 for r in prefix_runs["c"]["reqs"]]
    for a, b in zip(c["reqs"], prefix_runs["c"]["reqs"]):
        a.output = list(b.output)
    c["reqs"][0].output[-1] += 1
    with pytest.raises(AssertionError, match="changed greedy tokens"):
        C.check_prefix_runs(prefix_runs["a"], prefix_runs["b"], c)


def test_prefix_launch_check_is_exact(prefix_runs):
    run = dict(prefix_runs["b"])
    rep, n = run["rep"], 2
    good = {"flash_attention": n * rep["prefill_chunks"],
            "paged_attention_fused": n * rep["decode_steps"], "paged_attention_rung": 0,
            "exp_delta_encode": sum(run["encodes"].values()), "exp_delta_decode": 0}
    watch = C.PrefixWatch(torch, None)
    watch.registrations = [(1, 0, 1), (0, 0, 0)]
    watch.adoptions = [(3, 64, 1, 0)]
    C.check_prefix_launches("b", {**run, "launches": good, "prefix": watch}, n)
    with pytest.raises(AssertionError, match="expected"):
        C.check_prefix_launches("b", {**run, "launches": {**good, "flash_attention": 1},
                                      "prefix": watch}, n)
    watch.adoptions = [(3, 64, 2, 0)]
    with pytest.raises(AssertionError, match="one pack an adoption"):
        C.check_prefix_launches("b", {**run, "launches": good, "prefix": watch}, n)


def test_prefix_watch_fails_on_a_wrong_adoption(small):
    """A slot whose adopted rows differ from the donor snapshot fails the
    phase at the first adoption."""
    model, params = small
    sched = ContinuousScheduler(model, params, C.prefix_config(_prefix_base(), True, "resident"),
                                device="cpu")
    backend = sched.backend
    adopt = backend._adopt_prefix_rows

    def off_by_one(slot_id, entry, lo, m):
        adopt(slot_id, entry, lo, m)
        backend.cache["k_planes"][0, 15, slot_id, lo] ^= 1  # the lowest plane of one row

    backend._adopt_prefix_rows = off_by_one
    trace = _prefix_trace()
    with pytest.raises(AssertionError, match="differ from the donor snapshot"):
        with C.PrefixWatch(torch, backend):
            for it in trace:
                sched.submit(it.request)
                sched.run_until_drained()


def test_phase3_digest_leaves_out_the_sharing_counters_unless_full():
    reqs = _requests(1000)
    for i, r in enumerate(reqs):
        r.output = [i]
    rep = {"decode_steps": 5, "kv_stored_bytes": 100}
    more = {**rep, **{k: 7 for k in C.NEW_REPORT_KEYS}}
    assert C.phase3_digest(reqs, more) == C.phase3_digest(reqs, rep)
    assert C.phase3_digest(reqs, more, full=True) != C.phase3_digest(reqs, rep, full=True)


def test_prefix_launch_deltas_count_adoptions_and_snapshots():
    """Phase 3p's launch identity on the counts of the card run (24
    requests, 30 layers): (b) adds one pack an adoption and one unpack a
    snapshot beyond its chunks, decode steps and page transforms."""
    def run(pack, unpack, chunks, steps, spans, registrations, adoptions):
        watch = C.PrefixWatch(torch, None)
        watch.registrations, watch.adoptions = registrations, adoptions
        return {"launches": {"bitplane_pack": pack, "bitplane_unpack": unpack},
                "rep": {"prefill_chunks": chunks, "decode_steps": steps},
                "encodes": {"write_spans": spans, "reactivations": 0}, "prefix": watch}

    a = run(6737, 3035, 92, 126, 137, [(0, 0, 0)] * 24, [])
    b = run(5641, 2036, 59, 123, 104, [(1, 0, 1)] * 24, [(1, 384, 1, 0)] * 17)
    assert C.check_prefix_launch_deltas(a, b, 30) == {"bitplane_pack": 17,
                                                      "bitplane_unpack": 24}
    b["launches"]["bitplane_pack"] += 30  # a layer's pack too many
    with pytest.raises(AssertionError, match="one pack an adoption"):
        C.check_prefix_launch_deltas(a, b, 30)


# ---------------------------------------------------------------------------
# Phases 3s and 7 on the CPU: the sharded tier and the Mixtral ring, small
# ---------------------------------------------------------------------------


def test_sharded_phase_checks_pass_on_a_small_model(small):
    """Phase 3s at the smoke size: 2 kv heads take the head route on 2
    shards and, as 2 does not divide by 3, the sequence route on 3; tokens,
    queued write bytes and the shards' byte sums are checked against a
    paged run, as on the card."""
    model, params = small
    base = EngineConfig(max_batch=4, max_ctx=192, ladder=PrecisionLadder(C.LADDER),
                        codec="lz4", device_kv="bitplane", decode_kernel="fused",
                        backend="paged")
    sched = ContinuousScheduler(model, params, base, device="cpu")
    reqs = _requests(model.cfg.vocab)
    with C.write_job_ledger() as ledger:
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
    out = C.run_sharded_phase(torch, model, params, reqs, ledger,
                              requests=lambda: _requests(model.cfg.vocab), base=base,
                              runs=((2, "head"), (3, "seq")))
    assert {n: o["route"] for n, o in out.items()} == {2: "head", 3: "seq"}
    for o in out.values():
        shards = o["rep"]["shards"]
        assert o["rep"]["kv_logical_bytes"] == sum(s["kv_logical_bytes"] for s in shards)


def test_sharded_phase_fails_when_tokens_differ(small):
    model, params = small
    base = EngineConfig(max_batch=4, max_ctx=192, codec="lz4", backend="paged")
    reqs = _requests(model.cfg.vocab)
    sched = ContinuousScheduler(model, params, base, device="cpu")
    with C.write_job_ledger() as ledger:
        for r in reqs:
            sched.submit(r)
        sched.run_until_drained()
    reqs[1].output[2] += 1
    with pytest.raises(AssertionError, match="greedy tokens differ"):
        C.run_sharded_phase(torch, model, params, reqs, ledger,
                            requests=lambda: _requests(model.cfg.vocab), base=base,
                            runs=((2, "head"),))


# Phase 7's trace cut to Mixtral SMOKE (window 64): prompts inside the
# window, two crossing it while they decode, two starting beyond it
SMALL_RING_PROMPTS = (24, 48, 60, 62, 80, 120)
SMALL_RING_NEW = 24


@pytest.fixture(scope="module")
def ring_phase():
    model, params = C.mixtral_model(torch, torch.device("cpu"), layers=2, smoke=True, window=64)
    return C.run_ring_phase(torch, model, params, profile_steps=0, prompts=SMALL_RING_PROMPTS,
                            new=SMALL_RING_NEW, max_batch=4, max_ctx=192)


def _ring_snapshot(lens, w=64, layers=2, bits=16):
    pos = C.ring_positions(torch, torch.device("cpu"), len(lens), w, lens)
    return {"pos": pos[None].repeat(layers, 1, 1), "len": torch.tensor(lens),
            "planes": torch.full((len(lens), w // C.PAGE), bits, dtype=torch.int32),
            "live": [True] * len(lens)}


@pytest.mark.parametrize("fault", [None, "position", "stale", "head"])
def test_ring_snapshot_check_reads_positions_and_plane_map(fault):
    """Phase 7's ring glue check: the pos plane must be the one the
    lengths give, in every layer, and the plane map must read a keep in
    every column and full precision at the ring head."""
    model = SimpleNamespace(cfg=SimpleNamespace(attn_window=64))
    snap = _ring_snapshot([43, 67, 79, 130])
    snap["planes"][1, 2] = 8  # a ranked page away from slot 1's head column (67 % 64 // 16 = 0)
    if fault == "position":
        snap["pos"][1, 2, 5] += 64  # one layer's slot holds a dead position
    elif fault == "stale":
        snap["pos"][0, 0, 50] = 50  # past the length: a previous occupant's
    elif fault == "head":
        snap["planes"][3, 130 % 64 // C.PAGE] = 8
    if fault is None:
        C.check_ring_snapshot(torch, model, snap, (8, 12, 16))
    else:
        with pytest.raises(AssertionError, match="ring positions" if fault != "head"
                           else "plane map"):
            C.check_ring_snapshot(torch, model, snap, (8, 12, 16))


def test_ring_phase_checks_pass_on_the_smoke_model(ring_phase):
    runs = ring_phase["runs"]
    for run in runs.values():
        assert run["retired"] > 0 and run["rep"]["kv_evictions"] == 0
        assert all(len(r.output) == SMALL_RING_NEW for r in run["reqs"])
        # the 120-token prompt's first stored page: its chunks of 64 stored
        # pages 0-3 before the window slid past them (retired since)
        assert run["first_page"][5] == 0
    same, total = ring_phase["agree"]
    assert same == total  # on the CPU both routes take the plain attention


# ---------------------------------------------------------------------------
# Phase 8: the remaining model families, at smoke size on the CPU
# ---------------------------------------------------------------------------


def test_phase8_requests_follow_the_lengths_not_the_vocab():
    """8a's and 8b's traces: the prompt lengths (which set every count the
    card run is held to) are drawn before the tokens, so a SMOKE vocab
    gives the FULL run's lengths."""
    for arch, n, lo, hi in C.FAMILY_RUNS:
        full = C.family_requests(get_config(arch).vocab, n, lo, hi)
        smoke = C.family_requests(get_config(arch, smoke=True).vocab, n, lo, hi)
        assert [len(r.prompt) for r in full] == [len(r.prompt) for r in smoke]
        assert len(full) == n and all(lo <= len(r.prompt) <= hi for r in full)
        assert all(r.max_new_tokens == C.FAMILY_NEW for r in full)
        assert max(len(r.prompt) for r in full) + C.FAMILY_NEW <= C.FAMILY_CTX


def test_phase8_shapes_are_the_configs():
    """Phase 6's rows of phase 8 take the FULL configs' heads: Nemotron-4
    48/8, DeepSeek 16/16, LLaVA 56 padded to 64 over 8 (2,880 patches and
    1,024 tokens), Whisper 6/6 of 64 over 1,500 frames."""
    def heads(arch):
        c = get_config(arch)
        return c.n_q_heads_padded, c.n_kv_heads, c.head_dim

    flash = dict(C.FLASH_PHASE8)
    for name, arch in (("nemotron-4-15b chunk", "nemotron-4-15b"),
                       ("deepseek-moe-16b chunk", "deepseek-moe-16b"),
                       ("llava-next-34b prefill", "llava-next-34b"),
                       ("whisper-tiny encoder", "whisper-tiny"),
                       ("whisper-tiny cross", "whisper-tiny")):
        assert tuple(flash[name][3:6]) == heads(arch)
    vlm = get_config("llava-next-34b")
    assert flash["llava-next-34b prefill"][1] == vlm.n_patches + C.VLM_TEXT
    assert flash["whisper-tiny encoder"][2] == get_config("whisper-tiny").enc_seq
    for arch, (b, s, hkv, rep, hd) in C.PAGED_PHASE8:
        c = get_config(arch)
        assert (hkv, rep, hd) == (c.n_kv_heads, c.gqa_rep, c.head_dim)
        assert (b, s) == (C.FAMILY_BATCH, C.FAMILY_CTX)


def test_phase8_family_run_at_smoke_size():
    """8a's run at DeepSeek SMOKE width: every request served fused and
    rung, every layer's attention sub-layer within ATTN_BF16_STEPS of the
    plain one (equal here: both take the plain versions), device bytes the
    controller's, and the KV bytes a token printed."""
    model, params = C.family_model(torch, torch.device("cpu"), "deepseek-moe-16b", smoke=True)
    out = C.run_family_phase(torch, model, params, 4, 20, 70, "phase 8a", new=6,
                             profile_steps=0, max_batch=3, max_ctx=128)
    assert len(out["layers"]) == model.cfg.n_layers
    assert max(max(w) for w in out["layers"]) <= C.ATTN_BF16_STEPS
    assert out["agree"][0] == out["agree"][1] == 4 * 6
    assert out["forced"] is None  # the teacher-forced step runs on the card only
    for run in out["runs"].values():
        rep = run["rep"]
        assert rep["decode_steps"] > 0 and rep["prefill_chunks"] > 0
        assert run["bytes_a_token"]["kv_stored"] > 0


def test_phase8_prefill_families_at_smoke_size():
    """8c (LLaVA SMOKE with its heads padded 8 -> 16, as the FULL config
    pads 56 to 64) and 8d (Whisper SMOKE on 40 frames): every attention
    sub-layer checked, padded heads exactly zero before ``wo``, decode
    after prefill consistent with prefill."""
    dev = torch.device("cpu")
    v = C.run_vlm_phase(torch, dev, smoke=True, b=2, text=24, max_len=64, steps=3,
                        pad_heads_to=16)
    assert v["layers"] == 2 and v["attn_steps"] <= C.FLASH_BF16_STEPS
    assert v["consistency"] <= C.LOGITS_RTOL_OF_MAX
    assert v["prefill_device_ms"] is None  # no card: not measured
    w = C.run_whisper_phase(torch, dev, smoke=True, b=2, text=12, steps=3, enc_seq=40)
    assert w["attn_steps"] <= C.FLASH_BF16_STEPS and w["decode_device_ms"] is None


def test_padded_heads_watch_catches_an_unmasked_head(monkeypatch):
    """The 8c check fails where a padded head reaches ``wo`` unmasked."""
    from repro_torch.models import attention as A

    cfg = dataclasses.replace(get_config("llava-next-34b", smoke=True), pad_heads_to=16)
    monkeypatch.setattr(A, "mask_padded_heads", lambda out, c: out)
    out = torch.ones((1, 2, cfg.n_q_heads_padded, cfg.head_dim), dtype=torch.bfloat16)
    with C.padded_heads_watch(torch, cfg, []):
        with pytest.raises(AssertionError, match="padded q heads"):
            A.mask_padded_heads(out, cfg)


def test_pinned_routes_replay_the_plain_runs_experts():
    """8a's teacher-forced check pins a decode step's MoE routes: recording
    its own routes, the layer is ``moe_apply`` bit for bit (only the top-k
    choice is wrapped), and a replay with the recorded routes gives the
    same output whatever the router then says."""
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import layer_slice

    model, params = C.family_model(torch, torch.device("cpu"), "deepseek-moe-16b", smoke=True)
    cfg, lp = model.cfg, layer_slice(params["layers"], 0)["moe"]
    x = torch.randn((3, 1, cfg.d_model), generator=torch.Generator().manual_seed(2)).to(
        torch.bfloat16)
    want, _ = T.moe_apply(lp, x, cfg, inference=True)
    routes = []
    with C.pinned_routes(torch, routes, record=True):
        got, _ = T.moe_apply(lp, x, cfg, inference=True)
    assert len(routes) == 1 and tuple(routes[0].shape) == (3, 1, cfg.moe_top_k)
    assert torch.equal(got, want)
    with C.pinned_routes(torch, routes, record=False):
        again, _ = T.moe_apply(lp, x, cfg, inference=True)
    assert torch.equal(again, got) and len(routes) == 1  # replayed, not recorded anew
    # a router that would pick other experts is overruled by the recorded routes
    other = dict(lp, router=-lp["router"])
    own = torch.sort(torch.softmax((x @ other["router"]).float(), -1), dim=-1, descending=True,
                     stable=True)[1][..., :cfg.moe_top_k]
    assert not torch.equal(own.sort(-1).values, routes[0].sort(-1).values)
    with C.pinned_routes(torch, routes, record=False):
        pinned, _ = T.moe_apply(other, x, cfg, inference=True)
    unpinned, _ = T.moe_apply(other, x, cfg, inference=True)
    assert not torch.equal(pinned, unpinned)


def test_device_ms_each_splits_one_window_in_launch_order(monkeypatch):
    """Phase 6's serving mix times every chunk in one profiler window: the
    window's matching device kernels, in the order they started, are split
    into each call's ``iters * per_call`` and averaged over ``iters``; a
    window short of launches is measured once more, with the full pads."""
    from types import SimpleNamespace

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def event(name, start, us, device=cuda):
        return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(
            start=start, elapsed_us=lambda: us))

    # call a: 2 kernels a call at 1 us each; call b: 1 kernel at 5 us; a
    # host event and another kernel in between; listed out of order
    events = [event("flash_attention_merge", 30, 1), event("other", 5, 100),
              event("flash_attention_kernel", 10, 1), event("flash_attention_x", 0, 1),
              event("launch", 1, 7, cpu), event("flash_attention_kernel", 20, 1),
              event("flash_attention_b", 40, 5), event("flash_attention_b", 50, 5)]
    windows = []

    def window(run, what, pad):
        run()
        windows.append(pad)
        return None, events if len(windows) > 1 else events[:3], None

    monkeypatch.setattr(C, "profile_window", window)
    calls = []
    got = C.device_ms_each([(lambda i: calls.append(("a", i)), 2),
                            (lambda i: calls.append(("b", i)), 1)],
                           "flash_attention_", 2, "chunks")
    assert got == [pytest.approx(4 / 2 / 1e3), pytest.approx(10 / 2 / 1e3)]
    # the first window, with the timing loops' pads, was short: measured
    # again with the full pads
    assert windows == [C.REPEATABLE_PAD, C.PROFILER_PAD]
    assert calls[:2] == [("a", 0), ("b", 0)]  # warmed once each, then a, a, b, b
    assert calls[2:6] == [("a", 0), ("a", 1), ("b", 0), ("b", 1)]


@pytest.mark.parametrize("run, lost, complete", [
    (6, [], True),
    (6, [0, 1, 2, 1023], True),                          # among the leading pads
    (6, [1030 + C.TAIL_PAD - 1], True),                  # the last launch, a closing pad
    (6, [*range(900, 1024), *range(1030, 1030 + C.TAIL_PAD)], True),  # both runs of pads
    (6, [1024], False),                                  # the run's first launch
    (6, [5, 1029], False),                               # the run's last launch
    (0, [], False),                                      # nothing between the pads
])
def test_window_fault_allows_losses_only_among_the_pads(run, lost, complete):
    """A window of 1,024 leading pads, ``run`` launches of its run and
    TAIL_PAD closing pads is complete when its run launched something and
    no record of the run's launches was lost."""
    fault = C.window_fault(1024 + run + C.TAIL_PAD, lost, 1024)
    assert (fault is None) == complete, fault
