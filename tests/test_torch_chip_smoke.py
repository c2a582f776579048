"""The card scripts' own logic on the CPU: ``chip_smoke.py``'s phase-3 check
of the fused and rung serving runs (check runs, ``DecodeWatch``, the
comparison at each first divergence) on a small model, where the kernel
wrappers run their plain versions; ``bitplane_matmul_ablation.py``'s
isolation and refusal without a GPU; and the flash rows' helpers (phase
3's prefill chunks, the SDPA backend's name, the split case and the chunk
shapes)."""

import ast
import math
import contextlib
import os
import subprocess
import sys
from pathlib import Path

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
