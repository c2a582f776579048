"""The PyTorch port's surface: it stands apart from JAX and the reference
package, it never falls back to the CPU on its own, every architecture of
the reference builds, and what the port does not serve raises a precise
error."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.quantization import PrecisionLadder
from repro_torch.models import build_model
from repro_torch.serving import ContinuousScheduler, EngineConfig, Request, ServingEngine

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: the reference's registry, in its order (src/repro/configs/base.py)
REFERENCE_ARCHS = ("yi-34b", "nemotron-4-15b", "smollm-135m", "yi-9b", "deepseek-moe-16b",
                   "mixtral-8x7b", "mamba2-1.3b", "zamba2-7b", "llava-next-34b",
                   "whisper-tiny")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=120)


def test_import_pulls_in_no_jax_and_no_reference():
    """Every module of the port, found by walking the package, imports
    without pulling in JAX, the reference package, ml_dtypes or zstandard."""
    proc = _run(
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes', 'zstandard')]\n"
        "print(len(names), bad)\n"
    )
    assert proc.returncode == 0, proc.stderr
    n, bad = proc.stdout.strip().split(" ", 1)
    assert bad == "[]"
    assert int(n) >= 50  # the walk found the port, not an empty path


def test_chip_smoke_imports_nothing_of_jax_or_the_reference():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro", "ml_dtypes"}, roots


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the refusal path is for CPU-only hosts")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                          capture_output=True, text=True, env=env, cwd=REPO,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


@pytest.fixture(scope="module")
def smoke():
    cfg = get_config("smollm-135m", smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    return model, params


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(smoke):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    model, params = smoke
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousScheduler(model, params, EngineConfig(max_ctx=64))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(model, params, EngineConfig(max_ctx=64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousScheduler(model, params, EngineConfig(max_ctx=64), device="cuda")
    ContinuousScheduler(model, params, EngineConfig(max_ctx=64), device="cpu")


@pytest.mark.parametrize("change,error,match", [
    (dict(backend="ring"), ValueError, "full attention"),
    (dict(backend="sharded", shards=7), ValueError, "divides neither"),
    (dict(prefix_sharing=True, prefill_mode="padded"), ValueError, "prefix_sharing"),
    (dict(weight_stream="streamed"), ValueError, "weight_stream"),
    (dict(prefill_mode="padded"), NotImplementedError, "padded"),
    (dict(decode_kernel="warp"), ValueError, "decode_kernel"),
    (dict(device_kv="planes"), ValueError, "device_kv"),
    (dict(max_ctx=72), ValueError, "multiple of PAGE_TOKENS"),
])
def test_unported_options_raise(smoke, change, error, match):
    model, params = smoke
    cfg = dataclasses.replace(EngineConfig(max_ctx=64), **change)
    with pytest.raises(error, match=match):
        ContinuousScheduler(model, params, cfg, device="cpu")


@pytest.mark.parametrize("change,match", [
    (dict(attn_window=32), "ring"),
    (dict(decode_staging=8), "staged decode"),
])
def test_unported_model_configs_raise(smoke, change, match):
    model, params = smoke
    other = build_model(dataclasses.replace(model.cfg, **change))
    with pytest.raises(NotImplementedError, match=match):
        ContinuousScheduler(other, params, EngineConfig(max_ctx=64), device="cpu")


@pytest.mark.parametrize("arch", REFERENCE_ARCHS)
def test_every_reference_architecture_is_ported(arch):
    """The registry is the reference's (its ten architectures, in its
    order); each FULL and SMOKE config equals the reference's field for
    field, and ``build_model`` builds its family."""
    import dataclasses as dc

    from repro.configs.base import get_config as ref_config

    from repro_torch.configs import ARCH_IDS
    from repro_torch.models.model import EncDecModel, HybridModel, Model, SSMModel

    assert ARCH_IDS == REFERENCE_ARCHS
    kinds = {"dense": Model, "moe": Model, "vlm": Model, "ssm": SSMModel,
             "hybrid": HybridModel, "encdec": EncDecModel}
    for smoke in (False, True):
        cfg = get_config(arch, smoke=smoke)
        assert dc.asdict(cfg) == dc.asdict(ref_config(arch, smoke=smoke))
        assert isinstance(build_model(cfg), kinds[cfg.family])


def test_params_stay_where_the_caller_put_them(smoke):
    model, params = smoke
    meta = dict(params, embed={"table": params["embed"]["table"].to("meta")})
    with pytest.raises(ValueError, match="move them first"):
        ContinuousScheduler(model, meta, EngineConfig(max_ctx=64), device="cpu")


def test_serves_on_cpu_with_torch_generator_weights(smoke):
    """The port alone, its own weights: requests complete, the ladder cuts
    device reads below full precision, and device bytes equal the
    controller's plane-scaled reads."""
    model, params = smoke
    cfg = EngineConfig(max_batch=2, max_ctx=96, device_kv="bitplane",
                       codec="lz4", ladder=PrecisionLadder([(1, 16), (-1, 4)]))
    eng = ServingEngine(model, params, cfg, device="cpu")
    reqs = eng.run([Request(rid=i, prompt=np.arange(20 + 17 * i) % 500,
                            max_new_tokens=20) for i in range(2)])
    assert all(r.done and len(r.output) == 20 for r in reqs)
    rep = eng.report()
    assert rep["device_bytes_read"] == rep["kv_read_device_bytes"] > 0
    assert rep["device_bytes_read"] < rep["kv_fetch_logical"]


def test_sampled_streams_do_not_depend_on_batch_composition(smoke):
    """temperature > 0: a request's tokens depend only on its own stream
    (seed, rid, draw), not on which neighbours share the batch."""
    from repro_torch.serving import SamplerConfig

    model, params = smoke
    cfg = EngineConfig(max_batch=2, max_ctx=64, codec="lz4", rng_seed=3,
                       sampler=SamplerConfig(temperature=1.0, top_k=20))

    def run(rids):
        eng = ServingEngine(model, params, cfg, device="cpu")
        reqs = eng.run([Request(rid=r, prompt=np.arange(10 + r) % 500,
                                max_new_tokens=8) for r in rids])
        return {r.rid: r.output for r in reqs}

    alone, paired = run([1]), run([1, 2])
    assert alone[1] == paired[1]
    assert run([2])[2] == paired[2]
    assert len(set(alone[1])) > 1  # it really sampled


def _tiny_engine(**kw):
    from repro_torch.memctl import MemCtlConfig

    return EngineConfig(max_batch=2, max_ctx=96, store_layers=2, codec="lz4",
                        engine=MemCtlConfig(lanes=1, step_cycles=64), **kw)


def _prompt(n, offset=0):
    return ((np.arange(n) + offset) % 500).astype(np.int32)


def test_admission_backpressure_defers_and_recovers(smoke):
    model, params = smoke
    sched = ContinuousScheduler(model, params, _tiny_engine(admit_latency_ns_max=200.0),
                                device="cpu")
    a = Request(rid=0, prompt=_prompt(80), max_new_tokens=12)
    b = Request(rid=1, prompt=_prompt(40, 5), max_new_tokens=4)
    sched.submit(a)
    for _ in range(3):
        sched.step()
    sched.submit(b)
    sched.run_until_drained()
    rep = sched.report()
    assert a.done and b.done
    assert rep["admits_deferred"] > 0 and rep["backpressure_steps"] > 0
    assert b.admit_step - b.arrival_step >= rep["backpressure_steps"]
    assert rep["admit_pressure_ns"] == 0.0  # drained by the end


def test_shed_latency_rejects_at_submit_with_reason(smoke):
    model, params = smoke
    sched = ContinuousScheduler(model, params, _tiny_engine(shed_latency_ns_max=200.0),
                                device="cpu")
    a = Request(rid=0, prompt=_prompt(80), max_new_tokens=8)
    sched.submit(a)
    for _ in range(3):
        sched.step()  # build a real backlog on the tiny lane window
    assert sched.backend.admit_pressure_ns() > 200.0
    b = Request(rid=1, prompt=_prompt(40, 5), max_new_tokens=4)
    sched.submit(b)
    assert b.done and b.shed and b.output == []
    assert "shed_latency_ns_max" in b.shed_reason
    sched.run_until_drained()
    c = Request(rid=2, prompt=_prompt(40, 5), max_new_tokens=4)
    sched.submit(c)
    sched.run_until_drained()
    assert a.done and c.done and not c.shed and len(c.output) == 4
    assert sched.report()["requests_shed"] == 1
