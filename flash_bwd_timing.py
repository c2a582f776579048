"""The flash-attention backward kernel's times at phase 9a's shapes, from
the port of one checkout: this one, or another one given by --tree (for
instance a ``git archive`` of a parent commit, unpacked), so that two
versions of the kernel can be timed in turns on one card.

For each case of ``chip_smoke.FLASH_BWD_CASES`` (read from this script's
checkout) it runs ``chip_smoke.time_flash_bwd_case`` against the tree's
port: the backward's device time (in all and by kernel) and CUDA events,
its bound, and PyTorch's ``scaled_dot_product_attention`` backward alone
and forward and backward, yardsticks the port never calls.

Run it on a GPU host from the repository root:

    python3 flash_bwd_timing.py [--tree DIR]

It prints the card's name and power limit, one line per case and, as its
last line, one JSON object with every row; it exits 2 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import chip_smoke as C


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=C.ROOT,
                    help="the checkout whose port is timed (default: this one)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_timing: no CUDA device; this script runs on a GPU", file=sys.stderr)
        return 2
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    C.log(C.nvidia_smi_line())
    C.log(f"flash_bwd_timing: the port of {tree}")
    dev = torch.device("cuda")
    rows = [C.time_flash_bwd_case(torch, dev, case, plain=False) for case in C.FLASH_BWD_CASES]
    C.log(json.dumps({"tree": str(tree), "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
