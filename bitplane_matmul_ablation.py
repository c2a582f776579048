"""Where the bit-plane matmul's decode path spends its time on the card.

Times, by the profiler's device time, the kernel as built and three
ablation builds of ``src/repro_torch/csrc/bitplane_matmul.cu``
(``BPM_ABLATE``: 1 without the rebuild, 2 without the product, 3 with only
the plane loads and the barriers) at the Zamba2-7B MLP up-projection,
x (8, 3584) x W (3584, 14336), cold (three weights rotated, 103 MB of bf16
each), through the port's wrapper and its launch plan.  The product kernel
and the kernel that adds the K splits are timed apart; ``torch.matmul``
over the dense bf16 weight is timed beside them.  The ablation builds'
results are wrong by design; the kernel's is checked against its plain
version.

Run it on a GPU host from the repository root:

    python3 bitplane_matmul_ablation.py [--keeps 16 8 4] [--iters 30]

It prints the card's name and power limit, one line per (build, keep) and,
as its last line, one JSON object with every row; it exits 2 without a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as C

BUILDS = {0: "kernel", 1: "no rebuild", 2: "no product", 3: "loads only"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keeps", type=int, nargs="+", default=[16, 8, 4])
    ap.add_argument("--iters", type=int, default=30)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bitplane_matmul_ablation: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(C.ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.bitplane_matmul import kernel as MK
    from repro_torch.kernels.bitplane_matmul import ops as MM
    from repro_torch.kernels.bitplane_matmul import ref as MR

    torch.backends.cuda.matmul.allow_tf32 = False
    C.log(C.nvidia_smi_line())

    def build(a):
        _build.build(MK.SOURCE, (f"-DBPM_ABLATE={a}",) if a else ())

    with ThreadPoolExecutor(len(BUILDS)) as pool:
        list(pool.map(build, BUILDS))
    libs = {a: MK._library((f"-DBPM_ABLATE={a}",) if a else ()) for a in BUILDS}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    m, k, n = C.ZAMBA_MLP[0]
    nbuf = 3
    dense = [(torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
             for _ in range(nbuf)]
    planes = [MM.pack_weights(w) for w in dense]
    x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    lib_ms = C.device_ms(lambda i: torch.matmul(x, dense[i % nbuf]), "", args.iters)
    C.log(f"torch.matmul over the dense bf16 weight ({m},{k})x({k},{n}), cold: "
          f"{lib_ms:.4f} ms device")

    rows = []
    library = MK._library
    try:
        for keep in args.keeps:
            plan = MK.plan(m, k, n, keep)
            if plan["bn"] != 512:
                raise AssertionError(f"keep {keep} does not take the decode path: {plan}")
            nbytes = keep * k * n // 8
            bound, _ = C.bound_ms(nbytes + 2 * m * k + 4 * m * n, 2 * m * k * n,
                                  C.BF16_TENSOR_FLOPS)
            expect = {"bitplane_matmul_decode_kernel": args.iters}
            if plan["splits"] > 1:
                expect["bitplane_matmul_reduce_kernel"] = args.iters
            for a, lib in libs.items():
                MK._library = lambda lib=lib: lib
                run = lambda i: MK.bitplane_matmul(x, planes[i % nbuf], keep=keep)  # noqa: E731
                if a == 0:
                    torch.testing.assert_close(run(0), MR.bitplane_matmul_ref(x, planes[0], keep),
                                               atol=C.MATMUL_ATOL, rtol=C.MATMUL_RTOL)
                run(0)

                def window():
                    for i in range(args.iters):
                        run(i)

                got = C.device_rows(window, f"{BUILDS[a]} keep {keep}", expect)
                ms = {name: sum(e.self_device_time_total for e in got if name in e.key)
                      / args.iters / 1e3 for name in expect}
                product = ms["bitplane_matmul_decode_kernel"]
                reduce = ms.get("bitplane_matmul_reduce_kernel", 0.0)
                row = {"build": BUILDS[a], "keep": keep, "plan": plan,
                       "product_ms": product, "reduce_ms": reduce,
                       "device_ms": product + reduce, "bound_ms": bound,
                       "bound_share": bound / (product + reduce),
                       "plane_bytes": nbytes, "plane_gb_per_s": nbytes / product / 1e6,
                       "library_device_ms": lib_ms}
                rows.append(row)
                C.log(f"keep {keep:2d} {BUILDS[a]:>10}: {product + reduce:.4f} ms device "
                      f"(product {product:.4f}, adding {plan['splits']} splits "
                      f"{reduce:.4f}); byte bound {bound:.5f} ms, share "
                      f"{row['bound_share']:.3f}; kept planes {nbytes} B at "
                      f"{row['plane_gb_per_s']:.1f} GB/s over the product kernel")
    finally:
        MK._library = library
    if C.INCOMPLETE_WINDOWS:
        raise AssertionError(f"profiler windows lost launches: {C.INCOMPLETE_WINDOWS}")
    C.log(json.dumps({"rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
