"""The paper-pipeline quickstart: the port's surrogates, DDR5 trace replay
and ``python -m repro_torch.quickstart`` against the reference's.

Surrogates, trace replays and the quickstart's byte counts are structural
and must match exactly; the quickstart's top-8-plane matmul error is a
float32 ratio of norms taken in another order, held within 1e-3.
"""

import re
import runpy
from pathlib import Path

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import surrogates as J
from repro.core.bitplane import BF16 as J_BF16
from repro.core.compressed_store import StoreConfig as JStoreConfig
from repro.core.controller import MemoryController as JController
from repro.memsim.trace import replay_controller_trace as j_replay

from repro_torch import quickstart
from repro_torch.core import surrogates as T
from repro_torch.core.bitplane import BF16
from repro_torch.core.compressed_store import StoreConfig
from repro_torch.core.controller import MemoryController
from repro_torch.memsim.trace import replay_controller_trace

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
REL_ERR_TOL = 1e-3

SURROGATES = [
    ("gaussian_weights", ((256, 512),), {"seed": 3}),
    ("ar1_kv_cache", (64, 96), {"seed": 4}),
    ("logmag_kv_cache", (128, 256), {"rope_frac": 0.5, "seed": 1}),
    ("quantized_weights_fp8", ((128, 256),), {"seed": 2}),
    ("quantized_weights_int4", ((64, 64),), {"seed": 5}),
]


@pytest.mark.parametrize("name,args,kw", SURROGATES, ids=[s[0] for s in SURROGATES])
def test_surrogates_match_reference_bit_for_bit(name, args, kw):
    want = getattr(J, name)(*args, **kw)
    got = getattr(T, name)(*args, **kw)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.view(got.dtype))


def test_layer_kv_suite_matches_reference():
    want = J.layer_kv_suite(n_layers=3, tokens=32, channels=64, seed=1)
    got = T.layer_kv_suite(n_layers=3, tokens=32, channels=64, seed=1)
    for w, g in zip(want, got, strict=True):
        np.testing.assert_array_equal(g, w.view(np.uint16))


def _trace(ctl_cls, cfg_cls, spec):
    mc = ctl_cls(cfg_cls(codec="lz4"))
    w = T.gaussian_weights((256, 256), seed=0)
    kv = T.logmag_kv_cache(64, 128, rope_frac=0.5, seed=1)
    if ctl_cls is JController:  # the reference stores bf16 values
        w, kv = w.view(ml_dtypes.bfloat16), kv.view(ml_dtypes.bfloat16)
    mc.write_weights("w", w, spec)
    mc.write_kv_page((0, 0, 0), kv, spec)
    for planes in (None, 8, 4):
        mc.read_weights("w", planes=planes)
        mc.read_kv_page((0, 0, 0), planes=planes)
    return mc.access_trace()


@pytest.mark.parametrize("reads_only", [True, False])
def test_replay_controller_trace_matches_reference(reads_only):
    want = j_replay(_trace(JController, JStoreConfig, J_BF16), reads_only=reads_only)
    got = replay_controller_trace(_trace(MemoryController, StoreConfig, BF16),
                                  reads_only=reads_only)
    assert got.bytes_moved == want.bytes_moved > 0
    assert got.elapsed_ns == want.elapsed_ns
    assert got.engine_elapsed_ns == want.engine_elapsed_ns
    assert got.energy == want.energy
    assert got.dram_stats == want.dram_stats


def _split(lines):
    """Each line with its rel err cut out, and the rel err."""
    rel = [float(m.group(1)) for line in lines
           if (m := re.search(r"rel err ([0-9.]+)", line))]
    return [re.sub(r"rel err [0-9.]+", "rel err", line) for line in lines], rel


def test_quickstart_prints_the_reference_lines(capsys):
    runpy.run_path(str(REPO / "examples" / "quickstart.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert [line.split()[0] for line in got] == [
        "[weights]", "[kv]", "[fetch]", "[kernel]", "[dram]"]
    (want_lines, want_rel), (got_lines, got_rel) = _split(want), _split(got)
    assert got_lines == want_lines
    assert len(got_rel) == len(want_rel) == 1
    assert abs(got_rel[0] - want_rel[0]) <= REL_ERR_TOL


def test_quickstart_needs_a_gpu_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quickstart.run()
