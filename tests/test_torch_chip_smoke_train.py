"""``chip_smoke.py``'s phases 3t and 9 on the CPU at SMOKE size, where the
kernel wrappers run their plain versions: the staged and unstaged runs,
padded against bucketed admission, the training step, Whisper's training
and the supervisor's recovery run their checks end to end (the launch
counts, which a CPU run does not make, are the card's to check)."""

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


def test_sources_build_the_backward_beside_the_forward():
    assert "flash_attention_bwd.cu" in C.SOURCES
    assert all((REPO / "src" / "repro_torch" / "csrc" / s).is_file() for s in C.SOURCES)
