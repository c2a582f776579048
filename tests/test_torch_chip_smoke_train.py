"""``chip_smoke.py``'s phases 3t and 9 on the CPU at SMOKE size, where the
kernel wrappers run their plain versions: the staged and unstaged runs,
padded against bucketed admission, the training step, Whisper's training,
Mamba2's and Zamba2's training (9f) and the supervisor's recovery run their
checks end to end (the launch counts, which a CPU run does not make, are
the card's to check; their expected values are pinned here)."""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serving import Request

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke as C  # noqa: E402


@pytest.fixture(scope="module")
def small():
    model = build_model(get_config("smollm-135m", smoke=True))
    return model, model.init(torch.Generator().manual_seed(0))


def _requests(vocab, n=4):
    rng = np.random.default_rng(3)
    return [Request(rid=i, prompt=rng.integers(0, vocab, int(rng.integers(20, 50))).astype(np.int32),
                    max_new_tokens=2 * C.STAGED_WS + int(rng.integers(0, 6))) for i in range(n)]


def test_staged_and_padded_phase_runs_its_checks(small):
    model, params = small
    out = C.run_staged_padded_phase(torch, model, params, n=4, max_batch=4, max_ctx=128,
                                    requests=lambda: _requests(model.cfg.vocab))
    # the staged run, teacher-forced with the unstaged run's tokens: every
    # decode row compared (a request's max_new_tokens rows) and layer 0
    # held bit for bit for every request (staged_agree raises otherwise)
    agree = out["agree"]
    assert agree["rows"] == sum(r.max_new_tokens for r in _requests(model.cfg.vocab))
    assert agree["kv0"] == 4 and agree["steps"] <= C.STAGED_ROW_STEPS
    assert min(out["folded"].values()) >= 2
    padded, bucketed = out["runs"]["padded"]["rep"], out["runs"]["bucketed"]["rep"]
    assert padded["prefill_tokens"] > bucketed["prefill_tokens"]
    assert padded["prefill_chunks"] == 0 and bucketed["prefill_compiles"] >= 1


def _staged_run(outputs, row, k0):
    req = Request(rid=0, prompt=np.zeros(4, np.int32))
    req.output = outputs
    rows = SimpleNamespace(rows={(0, 1): torch.tensor([4.0, 3.0, 1.0]),
                                 (0, 2): torch.tensor(row)},
                           kv0={0: (torch.tensor(k0), torch.zeros(2))})
    return {"reqs": [req], "rows": rows}


@pytest.mark.parametrize("outputs, row, k0, fault", [
    ([1, 2, 3], [2.0, 3.0, 1.0], [1.0, 2.0], None),
    ([1, 2, 3], [2.0, 3.0 + 8 * 2 ** -6, 1.0], [1.0, 2.0], None),  # 8 steps of 3.0
    ([1, 2, 3], [2.0, 3.0 + 9 * 2 ** -6, 1.0], [1.0, 2.0], "bf16 steps"),
    ([1, 2, 3], [2.0, 3.0, 1.0], [1.0, 2.5], "layer 0"),
    ([1, 4, 3], [2.0, 3.0, 1.0], [1.0, 2.0], "greedy tokens"),
])
def test_staged_agreement_holds_every_row_and_layer_0(outputs, row, k0, fault):
    want = _staged_run([1, 2, 3], [2.0, 3.0, 1.0], [1.0, 2.0])
    got = _staged_run(outputs, row, k0)
    if fault is None:
        out = C.staged_agree(got, want)
        assert out["rows"] == 2 and out["argmax"] == 2 and out["kv0"] == 1
        return
    with pytest.raises(AssertionError, match=fault):
        C.staged_agree(got, want)


@pytest.fixture(scope="module")
def corpus():
    return C.train_corpus(get_config("smollm-135m", smoke=True).vocab, 20_000)


def test_training_phase_runs_its_checks(corpus):
    out = C.run_training_phase(torch, torch.device("cpu"), corpus, smoke=True, b=4, l=32,
                               n_micro=2, steps=4)
    assert out["losses"][-1] < out["losses"][0]
    assert out["loss"] == out["plain_loss"] and out["cosine"] > 0.9999
    assert out["device_ms"] is None


def test_whisper_training_runs_its_checks(corpus):
    out = C.run_whisper_training(torch, torch.device("cpu"), corpus, smoke=True, b=2, text=8,
                                 steps=3)
    assert len(out["losses"]) == 3
    with pytest.raises(ValueError, match="past the vocabulary"):
        C.run_whisper_training(torch, torch.device("cpu"), corpus + 10**6, smoke=True, b=2,
                               text=8, steps=1)


def test_supervisor_phase_recovers_and_replays_exactly_once(small, tmp_path, corpus):
    model, params = small
    out = C.run_supervisor_phase(torch, model, params, str(tmp_path), corpus, l=16)
    # saves at steps 2 and 4 (the replay of steps 2 and 3 saves at 4), one restore
    assert out["restarts"] == 1 and len(out["save_s"]) == 2 and len(out["load_s"]) == 1


def test_plain_flash_train_swaps_the_kernel_wrappers_and_restores_them():
    from repro_torch.kernels.flash_attention import kernel as FK

    before = FK.flash_attention, FK.flash_attention_bwd
    with C.plain_flash_train():
        assert FK.flash_attention is not before[0]
        q = torch.randn(1, 8, 2, 16).to(torch.bfloat16)
        pos = torch.arange(8, dtype=torch.int32)[None]
        out, lse = FK.flash_attention(q, q, q, pos, torch.tensor([8], dtype=torch.int32),
                                      causal=True, window=0, lse=True)
        grads = FK.flash_attention_bwd(q, q, q, out.contiguous(), q, lse, pos,
                                       torch.tensor([8], dtype=torch.int32), causal=True,
                                       window=0)
        assert [g.shape for g in grads] == [q.shape] * 3
    assert (FK.flash_attention, FK.flash_attention_bwd) == before


@pytest.mark.parametrize("arch,slots", [("mamba2-1.3b", None), ("zamba2-7b", 6)])
def test_ssm_training_phase_runs_its_checks(arch, slots):
    """9f at SMOKE size: the step through the wrappers (here the plain
    versions) equals the plain one; the loss falls; Zamba2 cut from 7 to 6
    slots (one shared-block call, no tail)."""
    cfg = get_config(arch, smoke=True)
    out = C.run_training_phase(torch, torch.device("cpu"), C.train_corpus(cfg.vocab, 20_000),
                               arch, smoke=True, b=2, l=64, n_micro=2, steps=3,
                               lr=C.SSM_TRAIN_LR, slots=slots)
    assert out["losses"][-1] < out["losses"][0]
    assert out["loss"] == out["plain_loss"] and out["cosine"] > 0.9999
    assert out["device_ms"] is None
    mamba = 5 if slots else cfg.n_layers
    assert out["expect"]["ssd"] == 2 * 2 * mamba and out["expect"]["ssd_bwd"] == 2 * mamba


def test_training_launches_at_full_width():
    """The counts 9b and 9f assert on the card: SmolLM-135M's 30 layers,
    Mamba2-1.3B's 48 and Zamba2-7B's 25 slots (21 Mamba2 layers, 4
    shared-block calls), two micro-batches, layer remat running each scan
    forward twice and flash once."""
    import dataclasses

    smol = C.train_launches(get_config("smollm-135m"), 2)
    mamba = C.train_launches(get_config("mamba2-1.3b"), 2)
    zamba = C.train_launches(dataclasses.replace(get_config("zamba2-7b"),
                                                 n_layers=C.ZAMBA_TRAIN_SLOTS), 2)
    assert smol == {"ssd": 0, "ssd_bwd": 0, "flash_attention": 60, "flash_attention_bwd": 60}
    assert mamba == {"ssd": 192, "ssd_bwd": 96, "flash_attention": 0, "flash_attention_bwd": 0}
    assert zamba == {"ssd": 84, "ssd_bwd": 42, "flash_attention": 8, "flash_attention_bwd": 8}


@pytest.mark.parametrize("shape,with_dh,gops,bound", [
    ((1, 4096, 64, 64, 128, 1), False, 51.674, 0.2261),
    ((1, 4096, 112, 64, 64, 2), True, 52.760, 0.2436),
])
def test_ssd_backward_bound_from_the_shapes(shape, with_dh, gops, bound):
    """The backward's work at 9e's shapes: nine products (three causal Q x Q
    x N, two Q x Q x P, four Q x N x P a chunk and head) at the TF32 passes
    the kernel takes on bf16-valued b and c: the scores one, the five
    products with b or c two, the rest three (0.2783 and 0.2893 ms with
    only the scores at fewer than three; 0.313 and 0.320 ms all at three)."""
    b, l, h, p, n, g = shape
    nbytes, products = C.ssd_bwd_work(b, l, h, p, n, 256, g, with_dh)
    assert abs(sum(products) / 1e9 - gops) < 1e-3
    bounds = C.ssd_bounds(nbytes, products, C.SSD_BWD_PASSES)
    assert bounds["bound_by"] == "operations" and abs(bounds["bound_ms"] - bound) < 1e-4
    before = C.ssd_bounds(nbytes, products, C.SSD_BWD_PASSES_SCORES_ONLY)
    assert abs(before["bound_ms"] - {False: 0.2783, True: 0.2893}[with_dh]) < 1e-4


def test_plain_ssd_train_swaps_the_kernel_wrappers_and_restores_them():
    from repro_torch.kernels.ssd import kernel as SK

    before = SK.ssd, SK.ssd_bwd
    with C.plain_ssd_train():
        assert SK.ssd is not before[0] and SK.ssd_bwd is not before[1]
        x = torch.randn(1, 64, 2, 4)
        bc = torch.randn(1, 64, 1, 8)
        y, hf, cum, states = SK.ssd(x, -torch.rand(1, 64, 2), bc, bc, torch.zeros(1, 2, 8, 4),
                                    chunk=32, workspaces=True)
        grads = SK.ssd_bwd(x, bc, bc, torch.ones_like(y), cum, states, hf, None, chunk=32)
        assert [t.shape for t in grads] == [x.shape, (1, 64, 2), bc.shape, bc.shape, hf.shape]
    assert (SK.ssd, SK.ssd_bwd) == before


def test_sources_build_the_backward_beside_the_forward():
    assert "flash_attention_bwd.cu" in C.SOURCES and "ssd_bwd.cu" in C.SOURCES
    assert all((REPO / "src" / "repro_torch" / "csrc" / s).is_file() for s in C.SOURCES)
