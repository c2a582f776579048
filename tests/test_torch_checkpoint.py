"""The port's checkpoint and training supervisor against the JAX reference's,
on the CPU: leaf names, files and blobs byte for byte equal for the same
arrays (so a checkpoint written by either package loads in the other, bit
for bit), the two-phase commit, corruption detection, retention, and the
reference's ``tests/test_checkpoint_ft.py`` cases on the port.  Codecs are
pinned (``lz4`` on both sides): the default codec is zstd where the
zstandard package is installed and lz4 elsewhere (the GPU host)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as JC
from repro.configs.base import get_config as j_get_config
from repro.models.model import build_model as j_build_model
from repro.optim.adamw import adamw_init as j_adamw_init

from repro_torch.checkpoint import CheckpointManager, latest_step, load_checkpoint, save_checkpoint
from repro_torch.data import DataConfig, ShardedLoader
from repro_torch.models.convert import opt_state_from_jax, params_from_jax
from repro_torch.runtime.fault_tolerance import (
    SimulatedFailure,
    StragglerDetector,
    TrainSupervisor,
)
from repro_torch.tree import leaves

# the suite runs test files in parallel worker processes: one intra-op
# thread per worker keeps torch from oversubscribing the CPU
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    """The reference's SmolLM SMOKE params with an AdamW state (bf16 and
    float32 leaves of every size, an int32 scalar), small raw leaves, on
    both sides."""
    jp = j_build_model(j_get_config("smollm-135m", smoke=True)).init(jax.random.PRNGKey(0))
    js = j_adamw_init(jp)
    js = {**js, "m": jax.tree_util.tree_map(lambda m: m + 0.25, js["m"])}
    extra = {"small_f32": jnp.arange(12, dtype=jnp.float32) / 7,
             "ints": jnp.arange(2000, dtype=jnp.int32) * 3,
             "small_bf16": (jnp.arange(10, dtype=jnp.float32) / 3).astype(jnp.bfloat16)}
    jtree = {"params": jp, "opt": js, "misc": extra}
    np_tree = jax.tree_util.tree_map(np.asarray, jtree)
    ttree = {"params": params_from_jax(np_tree["params"], "cpu"),
             "opt": opt_state_from_jax(np_tree["opt"], "cpu"),
             "misc": params_from_jax(np_tree["misc"], "cpu")}
    return jtree, ttree


def _bits(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.contiguous().view(torch.uint8).numpy().copy() if x.dim() else \
            x.reshape(1).view(torch.uint8).numpy().copy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def test_files_and_blobs_equal_the_reference(tmp_path, trees):
    jtree, ttree = trees
    jdir = JC.save_checkpoint(str(tmp_path / "j"), 5, jtree, {"note": "x"}, codec="lz4")
    tdir = save_checkpoint(str(tmp_path / "t"), 5, ttree, {"note": "x"}, codec="lz4")
    assert os.path.basename(jdir) == os.path.basename(tdir) == "step_0000000005"
    jm = json.load(open(os.path.join(jdir, "MANIFEST.json")))
    tm = json.load(open(os.path.join(tdir, "MANIFEST.json")))
    for key in ("step", "extra", "logical_bytes", "stored_bytes", "ratio"):
        assert tm[key] == jm[key], key
    assert tm["leaves"] == jm["leaves"]  # names, files, dtypes, encodings, digests
    encodings = {e["encoding"] for e in tm["leaves"]}
    assert encodings == {"raw", "bitplane+lz4"}
    for entry in jm["leaves"]:
        assert open(os.path.join(tdir, entry["file"]), "rb").read() == \
            open(os.path.join(jdir, entry["file"]), "rb").read(), entry["name"]


def test_port_checkpoint_loads_in_the_reference(tmp_path, trees):
    jtree, ttree = trees
    path = save_checkpoint(str(tmp_path), 2, ttree, {"loader": {"step": 2}}, codec="lz4")
    restored, extra = JC.load_checkpoint(path, jtree)
    assert extra == {"loader": {"step": 2}}
    for a, b in zip(jax.tree_util.tree_leaves(jtree), jax.tree_util.tree_leaves(restored)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_reference_checkpoint_loads_in_the_port(tmp_path, trees):
    jtree, ttree = trees
    path = JC.save_checkpoint(str(tmp_path), 2, jtree, {"s": 1}, codec="lz4")
    restored, extra = load_checkpoint(path, ttree)
    assert extra == {"s": 1}
    for a, b in zip(leaves(ttree), leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_roundtrip_atomic_commit_and_corruption(tmp_path, trees):
    _, ttree = trees
    path = save_checkpoint(str(tmp_path), 1, ttree, codec="lz4")
    restored, _ = load_checkpoint(path, ttree)
    for a, b in zip(leaves(ttree), leaves(restored)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    man = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert man["ratio"] > 1.15  # bit-plane + codec on bf16 weights
    os.makedirs(tmp_path / "step_0000000002.tmp")  # a crashed write
    assert latest_step(str(tmp_path)) == 1
    victim = os.path.join(path, man["leaves"][0]["file"])
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(victim, "wb").write(bytes(blob))
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(path, ttree)


def test_manager_retention_and_restore(tmp_path, trees):
    _, ttree = trees
    mgr = CheckpointManager(str(tmp_path), every_steps=1, keep=2, codec="lz4")
    for s in (1, 2, 3, 4):
        mgr.maybe_save(s, ttree["misc"], {"s": s})
    assert len([d for d in os.listdir(tmp_path) if d.startswith("step_")]) == 2
    restored, extra, step = mgr.restore_latest(ttree["misc"])
    assert step == 4 and extra == {"s": 4}
    assert CheckpointManager(str(tmp_path / "none")).restore_latest(ttree) == (None, None, None)


def test_straggler_detector():
    det = StragglerDetector(n_hosts=4, warmup_steps=3)
    for _ in range(10):
        for h in range(4):
            det.record(h, 1.0 if h != 2 else 3.5)
    assert det.exclusion_list() == [2]
    assert det.healthy_hosts() == [0, 1, 3]


def test_supervisor_recovers_and_is_exactly_once(tmp_path):
    """A failure at the 7th call: restore from step 6's checkpoint, replay
    the same batches (the loader's state is one integer), finish at 8."""
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2)
    seen, calls = [], {"n": 0}

    def step_fn(state, batch):
        calls["n"] += 1
        if calls["n"] == 7:
            raise SimulatedFailure("preempted")
        seen.append(int(batch["tokens"][0, 0]))
        return state + 1, {}

    sup = TrainSupervisor(step_fn, ShardedLoader(cfg),
                          CheckpointManager(str(tmp_path), every_steps=2, codec="lz4"),
                          max_restarts=2)
    state, step = sup.run(torch.tensor(0, dtype=torch.int32), 8)
    assert step == 8 and int(state) == 8 and sup.restarts == 1
    loader = ShardedLoader(cfg)
    expected = [int(loader.batch_at(s)["tokens"][0, 0]) for s in range(8)]
    assert seen[-3:] == expected[-3:]
    assert len(seen) == 8  # steps 0-5, then 6 and 7 once each after the restore


def test_supervisor_gives_up(tmp_path):
    cfg = DataConfig(vocab=128, seq_len=16, global_batch=2)

    def step_fn(state, batch):
        raise SimulatedFailure("dead host")

    sup = TrainSupervisor(step_fn, ShardedLoader(cfg), CheckpointManager(str(tmp_path)),
                          max_restarts=1)
    with pytest.raises(SimulatedFailure):
        sup.run(torch.tensor(0, dtype=torch.int32), 4)
