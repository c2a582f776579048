"""Hand-written Hopper kernel for the matrix product with bit-plane
weights: the binding and the launch wrapper.

The CUDA C++ source is ``src/repro_torch/csrc/bitplane_matmul.cu``, built
at first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.  The wrapper checks its inputs, allocates its
output (and, when K is split, the partial sums' workspace) with
``torch.empty``, launches on the current stream (the product kernel and,
when K is split, the kernel that adds the splits), raises if a launch did
not happen, and adds one to its count in :data:`LAUNCHES` per call.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import aligned, check, load, raise_on

SOURCE = "bitplane_matmul.cu"

#: launches since the last :func:`reset_launches`
LAUNCHES = {"bitplane_matmul": 0}

#: K splits are multiples of this many rows; on the decode path, of its
#: 32-row K tile
SPLIT_ROWS = 16
DECODE_SPLIT_ROWS = 32
#: blocks that run at once on the H100's 132 SMs, two per SM
SLOTS = 2 * 132


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library(extra: tuple = ()) -> ctypes.CDLL:
    """The kernel's library; ``extra`` nvcc flags select an ablation build
    (``-DBPM_ABLATE=n``, see the source)."""
    lib = load(SOURCE, extra)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bitplane_matmul_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.bitplane_matmul_launch.restype = i
    return lib


def plan(m: int, k: int, n: int, keep: int) -> dict:
    """The launch's shape for x (m, k) x W (k, n) at ``keep`` planes:
    ``mt`` 16-row slabs of x per block (1, 2, 4 or 8; larger m takes more
    slabs of 128 rows) and ``bn`` columns per block.  ``bn`` 512 is the
    decode path (mt <= 2, n % 128 == 0, k % 8 == 0, keep > 0, and enough
    512-column tiles x 32-row splits to fill SLOTS); it cuts K into the
    number of splits whose blocks fill whole waves of SLOTS best (the
    smallest within 5% of the best).  ``bn`` 128 is the general path; it
    cuts K so that the call has at least SLOTS blocks where K allows.
    Splits are ``chunk`` rows (a multiple of SPLIT_ROWS, of
    DECODE_SPLIT_ROWS on the decode path; the last may be shorter);
    ``blocks`` is column tiles x splits x slabs."""
    mt = next(t for t in (1, 2, 4, 8) if m <= 16 * t or t == 8)
    slabs = max(1, -(-m // (16 * mt)))
    most = max(1, -(-k // DECODE_SPLIT_ROWS))
    decode = (mt <= 2 and n % 128 == 0 and k % 8 == 0 and keep > 0
              and -(-n // 512) * slabs * most >= SLOTS)
    bn = 512 if decode else 128
    base = -(-n // bn) * slabs
    gran = DECODE_SPLIT_ROWS if decode else SPLIT_ROWS
    if decode:
        cost = {s: -(-base * s // SLOTS) / s for s in range(1, most + 1)}
        best = min(cost.values())
        want = min(s for s, c in cost.items() if c <= 1.05 * best)
    else:
        want = max(1, -(-SLOTS // base))
    chunk = max(gran, -(-k // want // gran) * gran)
    splits = max(1, -(-k // chunk))
    return {"mt": mt, "bn": bn, "slabs": slabs, "splits": splits, "chunk": chunk,
            "blocks": base * splits}


def bitplane_matmul(x: torch.Tensor, planes: torch.Tensor, *, keep: int,
                    bits: int = 16) -> torch.Tensor:
    """x (M, K) bf16 × weight planes (bits, K, N/8) uint8 -> (M, N)
    float32; the weight is rebuilt from planes [0, keep) only."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")
    if x.dim() != 2 or planes.dim() != 3:
        raise ValueError(f"x (M, K) and planes (bits, K, N/8), got {tuple(x.shape)} "
                         f"and {tuple(planes.shape)}")
    if not 0 < bits <= 16:
        raise ValueError(f"weights are 16-bit patterns; bits={bits}")
    if not 0 <= keep <= bits:
        raise ValueError(f"keep must be in [0, {bits}], got {keep}")
    m, k = x.shape
    n = planes.shape[2] * 8
    check("x", x, torch.bfloat16, (m, k), x.device)
    check("planes", planes, torch.uint8, (bits, k, n // 8), x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    x, planes = aligned(x), aligned(planes)
    p = plan(m, k, n, keep)
    work = (torch.empty((p["splits"], m, n), dtype=torch.float32, device=x.device)
            if p["splits"] > 1 else out)
    err = _library().bitplane_matmul_launch(
        x.data_ptr(), planes.data_ptr(), out.data_ptr(), work.data_ptr(), m, k, n, bits,
        keep, p["mt"], p["bn"], p["splits"], p["chunk"],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    raise_on(err, "bitplane_matmul")
    LAUNCHES["bitplane_matmul"] += 1
    return out
