"""Checkpointing (port of the reference's ``checkpoint/checkpoint.py``):
atomic, compressed with the paper's own pipeline, elastic.

* **Bit-plane + codec leaves.**  Every float leaf of 1,024 values or more
  is stored through :mod:`repro_torch.core.compressed_store` (bit-plane
  disaggregation, then codec blocks) at exact-bit fidelity; smaller and
  integer leaves are stored raw.  A bf16 leaf goes through NumPy as its
  raw bits (``uint16``), so the port needs no NumPy bf16 type.
* **Two-phase atomic commit.**  Files are written and fsynced under
  ``step_N.tmp/``, then one ``rename`` to ``step_N/`` commits them with a
  ``MANIFEST.json`` of content digests; a crash mid-write never corrupts
  the latest checkpoint.
* **The reference's format.**  Leaf names (dict keys sorted at every
  level, joined by ``__``), file names, encodings and blobs are byte for
  byte the reference's for the same arrays, so a checkpoint written by one
  package loads in the other; only the manifest's ``treedef`` string
  differs.
* **Elastic restore.**  Leaves are stored whole; :func:`load_checkpoint`
  returns tensors on each leaf of ``tree_like``'s device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil

import numpy as np
import torch

from repro_torch.core.bitplane import BF16, FP16, FP32, FP8_E4M3, FP8_E5M2
from repro_torch.core.compressed_store import (
    CompressedTensor,
    StoreConfig,
    compress_weights,
    decompress_weights,
)
from repro_torch.tree import leaves_with_paths, unflatten

#: torch dtype -> (the reference's manifest dtype string, NumPy dtype of
#: the stored values or raw bits, bit-plane spec)
_DTYPES = {
    torch.bfloat16: ("bfloat16", np.uint16, BF16),
    torch.float16: ("<f2", np.float16, FP16),
    torch.float32: ("<f4", np.float32, FP32),
    torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, FP8_E4M3),
    torch.float8_e5m2: ("float8_e5m2", np.uint8, FP8_E5M2),
}
#: a NumPy extension type's dtype string (the reference's ml_dtypes) ->
#: (torch dtype, NumPy dtype of its raw bits)
_EXTENSION = {name: (dt, np_dt) for dt, (name, np_dt, _) in _DTYPES.items()
              if not name.startswith("<")}
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _host(leaf) -> tuple:
    """A leaf -> (NumPy array of its values, or of its raw bits where NumPy
    has no such dtype; the manifest's dtype string; the bit-plane spec, or
    None where the reference stores the leaf raw: integers, and floats of
    fewer than 1,024 values)."""
    if torch.is_tensor(leaf) and leaf.dtype in _DTYPES:
        t = leaf.detach().cpu().contiguous()
        name, np_dt, spec = _DTYPES[t.dtype]
        arr = t.view(_BITS[t.element_size()]).numpy().view(np_dt)
        return arr, name, spec if arr.size >= 1024 else None
    arr = leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)
    if arr.dtype.kind != "f" or arr.size < 1024:
        return arr, arr.dtype.str, None
    spec = {np.dtype(np.float32): FP32, np.dtype(np.float16): FP16}.get(arr.dtype)
    if spec is None:  # the reference's spec_for_dtype refuses it too
        raise ValueError(f"no FloatSpec for dtype {arr.dtype}")
    return arr, arr.dtype.str, spec


def save_checkpoint(directory: str, step: int, tree, extra: dict | None = None,
                    codec: str | None = None) -> str:
    """Two-phase atomic save of a tree of tensors (or NumPy arrays, or
    Python numbers); returns the committed path.  ``codec`` None picks zstd
    where the zstandard package is installed, else the built-in lz4."""
    from repro_torch.compression import default_codec

    codec = codec or default_codec()
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = leaves_with_paths(tree)
    cfg = StoreConfig(codec=codec)
    manifest = {
        "step": step,
        "treedef": _treedef(tree),
        "extra": extra or {},
        "leaves": [],
    }
    logical = stored = 0
    for i, (path, leaf) in enumerate(flat):
        name = "__".join(path) or "leaf"
        arr, dtype, spec = _host(leaf)
        fname = f"{i:05d}_{name[:80]}.bin"
        entry = {"name": name, "file": fname, "dtype": dtype, "shape": list(arr.shape)}
        if spec is not None:
            ct = compress_weights(arr, spec, cfg)
            blob = _serialize_ct(ct)
            entry["encoding"] = "bitplane+" + codec
            entry["spec"] = spec.name
            entry["logical"] = ct.logical_bytes
            entry["stored"] = len(blob)
            logical += ct.logical_bytes
        else:
            blob = arr.tobytes()
            entry["encoding"] = "raw"
            entry["logical"] = entry["stored"] = len(blob)
            logical += len(blob)
        stored += len(blob)
        entry["sha256"] = hashlib.sha256(blob).hexdigest()[:16]
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append(entry)
    manifest["logical_bytes"] = logical
    manifest["stored_bytes"] = stored
    manifest["ratio"] = logical / max(1, stored)
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _treedef(tree) -> str:
    """A readable description of the tree's structure (the reference
    writes JAX's treedef string here; neither side reads it back)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return type(tree).__name__ + "(" + ", ".join(_treedef(v) for v in tree) + ")"
    return "*"


def _serialize_ct(ct: CompressedTensor) -> bytes:
    """Length-prefixed plane blobs behind a JSON header (one self-contained
    file), as the reference writes them."""
    header = {
        "shape": list(ct.shape),
        "spec": ct.spec_name,
        "n_values": ct.n_values,
        "layout": ct.config.layout,
        "codec": ct.config.codec,
        "block_bytes": ct.config.block_bytes,
        "segments": [[len(b) for b in seg] for seg in ct.segments],
    }
    hb = json.dumps(header).encode()
    out = [len(hb).to_bytes(4, "little"), hb]
    for seg in ct.segments:
        out.extend(seg)
    return b"".join(out)


def _deserialize_ct(blob: bytes) -> CompressedTensor:
    hlen = int.from_bytes(blob[:4], "little")
    header = json.loads(blob[4:4 + hlen])
    off = 4 + hlen
    segments = []
    for seg_lens in header["segments"]:
        seg = []
        for ln in seg_lens:
            seg.append(blob[off:off + ln])
            off += ln
        segments.append(seg)
    cfg = StoreConfig(codec=header["codec"], block_bytes=header["block_bytes"],
                      layout=header["layout"])
    return CompressedTensor(shape=tuple(header["shape"]), spec_name=header["spec"],
                            config=cfg, kind="weights", n_values=header["n_values"],
                            segments=segments)


def _to_torch(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """Stored values (or raw bits) -> a tensor of the stored dtype."""
    if dtype_str in _EXTENSION:
        dt, np_dt = _EXTENSION[dtype_str]
        return torch.from_numpy(np.ascontiguousarray(arr).view(np_dt).copy()).view(dt)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype_str)))


def load_checkpoint(path: str, tree_like):
    """Restore into the structure of ``tree_like`` (leaf count and shapes
    checked, every blob's digest verified): (tree, extra), each leaf a
    tensor of ``tree_like``'s leaf dtype on its device (a NumPy array or a
    Python number in ``tree_like`` gets a CPU tensor)."""
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    flat = leaves_with_paths(tree_like)
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, tree needs "
                         f"{len(flat)}")
    out = []
    for (_, leaf), entry in zip(flat, manifest["leaves"]):
        with open(os.path.join(path, entry["file"]), "rb") as f:
            blob = f.read()
        if hashlib.sha256(blob).hexdigest()[:16] != entry["sha256"]:
            raise IOError(f"checksum mismatch on {entry['name']}")
        if entry["encoding"].startswith("bitplane"):
            arr = decompress_weights(_deserialize_ct(blob))
        else:
            np_dt = _EXTENSION[entry["dtype"]][1] if entry["dtype"] in _EXTENSION \
                else np.dtype(entry["dtype"])
            arr = np.frombuffer(blob, np_dt).reshape(entry["shape"])
        t = _to_torch(arr, entry["dtype"])
        want = tuple(leaf.shape) if torch.is_tensor(leaf) else np.shape(leaf)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{entry['name']}: stored shape {tuple(t.shape)}, tree "
                             f"wants {tuple(want)}")
        if torch.is_tensor(leaf):
            t = t.to(device=leaf.device, dtype=leaf.dtype)
        else:
            t = t.to(torch.from_numpy(np.asarray(leaf)).dtype)
        out.append(t)
    return unflatten(tree_like, out), manifest["extra"]


def latest_step(directory: str) -> int | None:
    """The newest committed step under ``directory`` (a ``.tmp`` directory,
    a write that never committed, is ignored)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, d, "MANIFEST.json")):
                steps.append(int(d.split("_")[1]))
    return max(steps) if steps else None


@dataclasses.dataclass
class CheckpointManager:
    """Cadenced save, restart from the latest, retention."""

    directory: str
    every_steps: int = 100
    keep: int = 3
    codec: str | None = None

    def maybe_save(self, step: int, tree, extra: dict | None = None) -> str | None:
        if step % self.every_steps != 0:
            return None
        path = save_checkpoint(self.directory, step, tree, extra, codec=self.codec)
        self._gc()
        return path

    def restore_latest(self, tree_like):
        """(tree, extra, step), or (None, None, None) with no checkpoint."""
        step = latest_step(self.directory)
        if step is None:
            return None, None, None
        tree, extra = load_checkpoint(
            os.path.join(self.directory, f"step_{step:010d}"), tree_like)
        return tree, extra, step

    def _gc(self) -> None:
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:010d}"))
