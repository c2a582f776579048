"""Quickstart: the paper's memory-controller pipeline in five steps (port
of the reference's ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

1. Compress model weights with bit-plane disaggregation + ZSTD (Table III).
2. Compress a KV cache with cross-token clustering + exponent delta (Fig 7),
   transformed on the device (the exponent-delta and bit-plane pack
   kernels on the card); the codec runs on the host.
3. Fetch weights at reduced precision — bandwidth ∝ planes (Fig 5).
4. Run the same partial-plane fetch as a fused matmul kernel, on the card:
   the weight is packed by the bit-plane pack kernel and multiplied by the
   bit-plane matmul kernel.
5. Replay the access trace through the DDR5 timing/energy model (Fig 10/11).

Steps 1, 3 and 5 are the host-side controller model (NumPy); steps 2 and 4
run on the device, CUDA by default (``--device cpu`` takes the kernels'
plain versions).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.bitplane import BF16
from repro_torch.core.compressed_store import StoreConfig
from repro_torch.core.controller import MemoryController
from repro_torch.core.surrogates import gaussian_weights, logmag_kv_cache
from repro_torch.device import resolve_device
from repro_torch.kernels.bitplane_matmul import ops as mm
from repro_torch.memsim.trace import replay_controller_trace


def run(device=None) -> dict:
    """The five steps; returns ``{"lines": [five report lines], "rel_err":
    the top-8-plane matmul's relative error}``."""
    dev = resolve_device(device)
    mc = MemoryController(StoreConfig())  # zstd if installed, else lz4
    lines = []

    # 1. weights ------------------------------------------------------------
    w = gaussian_weights((1024, 1024), seed=0)  # bf16 as uint16 bits
    ct = mc.write_weights("layer0.mlp.w_in", w, BF16)
    lines.append(f"[weights] bf16 {ct.logical_bytes:,}B -> {ct.stored_bytes:,}B "
                 f"(ratio {ct.ratio:.2f}, saves {ct.savings:.1%})")

    # 2. KV cache -----------------------------------------------------------
    kv = logmag_kv_cache(512, 256, rope_frac=0.5, seed=1)  # bf16 as uint16 bits
    kvt = torch.from_numpy(kv.view(np.int16)).to(dev)
    ctk = mc.write_kv_page((0, 0, 0), kvt, BF16)  # transformed on the device
    lines.append(f"[kv]      bf16 {ctk.logical_bytes:,}B -> {ctk.stored_bytes:,}B "
                 f"(ratio {ctk.ratio:.2f}, saves {ctk.savings:.1%})")

    # 3. partial-plane fetch --------------------------------------------------
    full = mc.read_weights("layer0.mlp.w_in")           # exact bf16
    mc.read_weights("layer0.mlp.w_in", planes=8)        # "fp8" fetch
    reads = mc.stats.reads()
    lines.append(f"[fetch]   full={reads[0].physical_bytes:,}B  "
                 f"top-8-planes={reads[1].physical_bytes:,}B "
                 f"({reads[1].physical_bytes / reads[0].physical_bytes:.0%} of full)")
    if not np.array_equal(full, w):
        raise AssertionError("a full-precision weight read is not bit-exact")

    # 4. fused bitplane matmul kernel ----------------------------------------
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 1024))
                         .astype(np.float32)).to(torch.bfloat16).to(dev)
    wt = torch.from_numpy(w.view(np.int16)).view(torch.bfloat16).to(dev)
    planes = mm.pack_weights(wt)
    y8 = mm.bitplane_matmul(x, planes, keep=8)
    y16 = mm.bitplane_matmul(x, planes, keep=16)
    rel = float(torch.linalg.norm(y8 - y16) / torch.linalg.norm(y16))
    lines.append(f"[kernel]  top-8-plane matmul: {mm.weight_fetch_bytes(planes, 8):,}B "
                 f"weight traffic (vs {1024 * 1024 * 2:,}B), rel err {rel:.4f}")

    # 5. DRAM replay ----------------------------------------------------------
    res = replay_controller_trace(mc.access_trace())
    lines.append(f"[dram]    trace: {res.bytes_moved:,}B in {res.elapsed_ms:.3f} ms "
                 f"({res.effective_gbps:.1f} GB/s), energy {res.energy['total_uj']:.1f} uJ")
    return {"lines": lines, "rel_err": rel}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device of steps 2 and 4 (default: CUDA, which must be present)")
    args = ap.parse_args(argv)
    for line in run(args.device)["lines"]:
        print(line)


if __name__ == "__main__":
    main()
