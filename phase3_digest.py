#!/usr/bin/env python3
"""Phase 3's serving digest of any checkout of this repository, to compare
two trees on one card.

    python3 phase3_digest.py [DIR]

Builds the kernels of the checkout at DIR (default: this one) and serves
phase 3's 16 requests on full-width SmolLM-135M through that checkout's
``chip_smoke.serve``, once through the fused kernel and once through the
rung kernel, then prints the digest of each run's greedy tokens and
integer counters as this checkout's ``chip_smoke.phase3_digest`` computes
it: the line ``chip_smoke.py`` prints in its phase 3.  Two trees whose
kernels compute the same bits print the same digests.  It needs a CUDA
device and ``nvcc``; without a GPU it exits 2 and prints no digest.  It
imports nothing of JAX and nothing of the JAX package ``repro``.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("phase3_digest: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    root = Path(argv[1] if len(argv) > 1 else HERE).resolve()
    if not (root / "chip_smoke.py").is_file() or not (root / "src" / "repro_torch").is_dir():
        print(f"phase3_digest: {root} is no checkout of the port", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    digest = load(HERE / "chip_smoke.py", "chip_smoke_digest").phase3_digest
    target = load(root / "chip_smoke.py", "chip_smoke_target")
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    target.log(target.nvidia_smi_line())
    target.build_kernels()
    model = build_model(get_config("smollm-135m"))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    runs = {}
    for kernel in ("fused", "rung"):
        reqs, rep, *_ = target.serve(torch, model, params, kernel)
        runs[kernel] = digest(reqs, rep)
    print(f"phase 3 digest of greedy tokens and counters ({root.name}): fused "
          f"{runs['fused']}, rung {runs['rung']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
