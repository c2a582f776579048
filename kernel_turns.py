"""Kernel times from the port of one checkout, so that two versions of a
kernel can be timed in turns on one card (parent, tree, tree, parent).

The checkout is this one or the one given by --tree (for instance a
``git archive`` of a parent commit, unpacked); the rows' definitions are
this checkout's.  --only picks the kernels (all three by default):

- ``flash_bwd``: the flash-attention backward at phase 9a's shapes, each
  case of ``chip_smoke.FLASH_BWD_CASES`` through
  ``chip_smoke.time_flash_bwd_case``: device time (in all and by kernel),
  CUDA events, its bound, and PyTorch's ``scaled_dot_product_attention``
  backward alone and forward and backward, yardsticks the port never
  calls;
- ``ring``: the flash kernel with key positions at phase 6's ring chunk
  rows (``chip_smoke.time_ring_flash``: chunks of 512 and 4,096 over a
  full 4,096-slot ring and over one of which 3,000 slots were written,
  each held to the plain version, beside SDPA with the same mask), and
  what ptxas reported for its head-dim-128 instantiation (registers,
  spills, serialized wgmma) when it compiled the tree's source;
- ``ssd_bwd``: the SSD backward at phase 9e's two training micro-batches
  (``chip_smoke.check_ssd_bwd``: held to the plain backward, two calls
  the same bits).

--dominant also runs phase 6's dominant-key ring cases against the
tree's kernel.  Run it on a GPU host from the repository root:

    python3 kernel_turns.py [--tree DIR] [--only flash_bwd|ring|ssd_bwd ...] [--dominant]

It prints the card's name and power limit, the rows and, as its last
line, one JSON object with every row; it exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as C

KERNELS = ("flash_bwd", "ring", "ssd_bwd")
# the flash kernel's key-position instantiation at head dim 128, as ptxas
# names it (flash_attention_kernel<128, true>)
POS_KERNEL = "flash_attention_kernelILi128ELb1E"


def ptxas_report(log: str, fragment: str) -> list:
    """The lines of a ``-Xptxas -v`` log about the functions whose mangled
    names hold ``fragment``: each entry's properties, registers and
    spills, and any warning that names them."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if fragment not in line:
            continue
        out.append(line.strip())
        if "Compiling entry function" in line or "Function properties" in line:
            out += [t.strip() for t in lines[i + 1:i + 3] if "ptxas info    : Compiling" not in t]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=C.ROOT,
                    help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--only", choices=KERNELS, nargs="+", default=list(KERNELS),
                    help="the kernels to time (default: all three)")
    ap.add_argument("--dominant", action="store_true",
                    help="also run phase 6's dominant-key cases on the tree's kernel")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    C.log(C.nvidia_smi_line())
    C.log(f"kernel_turns: the port of {tree}")
    dev = torch.device("cuda")
    out = {"tree": str(tree)}
    if "ring" in args.only or args.dominant:
        _, flash_log = _build.build("flash_attention.cu")
        report = ptxas_report(flash_log, POS_KERNEL)
        C.log("ptxas on flash_attention_kernel<128, true>: "
              + (" | ".join(report) if report else "(built before; no report)"))
        out["ptxas_pos_128"] = report
    if args.dominant:
        out["dominant"] = C.check_ring_dominant_keys(torch, dev)
    if "flash_bwd" in args.only:
        out["flash_bwd"] = [C.time_flash_bwd_case(torch, dev, case, plain=False)
                            for case in C.FLASH_BWD_CASES]
    if "ring" in args.only:
        out["ring"] = C.time_ring_flash(torch, dev)
    if "ssd_bwd" in args.only:
        out["ssd_bwd"] = C.check_ssd_bwd(torch, dev, phase="ssd_bwd turns")
    C.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
