"""The card scripts' own logic on the CPU: ``chip_smoke.py``'s phase-3 check
of the fused and rung serving runs (check runs, ``DecodeWatch``, the
comparison at each first divergence) on a small model, where the kernel
wrappers run their plain versions, and ``bitplane_matmul_ablation.py``'s
isolation and refusal without a GPU."""

import ast
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
