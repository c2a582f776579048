"""Hand-written Hopper kernel for Mamba2's chunked SSD scan: the binding,
the launch plan and the launch wrapper.

The CUDA C++ source is ``src/repro_torch/csrc/ssd.cu``, built at first use
by :mod:`repro_torch.kernels._build`.  Nothing is built when this module is
imported.  One call launches three kernels (chunk states, the pass over
chunks, the outputs) and counts one launch in :data:`LAUNCHES`.  The
wrapper checks its inputs, allocates its outputs and the three workspaces
with ``torch.empty``, launches on the current stream and raises if a
launch did not happen.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "ssd.cu"

#: dynamic shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232_448
#: token tile of the chunk-state and output kernels (rows and columns)
TOKENS = 64
#: threads of a block of the pass over chunks, each four state elements
PASS_THREADS = 128
#: the output kernel holds at most 16 tiles of 8 p columns a warp
MAX_P = 128
#: 16 x 32 pieces of a chunk's state: 2 for each of the 8 warps at most
MAX_STATE_PIECES = 16

#: launches since the last :func:`reset_launches`
LAUNCHES = {"ssd": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan(bsz: int, l: int, h: int, g: int, p: int, n: int, q: int) -> dict:
    """The launch of one call, from the shapes alone: blocks of each
    kernel and the workspaces' shapes.  Raises ValueError on a shape the
    kernel cannot take (its shared memory is the library's to say:
    ``ssd_smem_bytes``, checked by the wrapper)."""
    if q <= 0 or l % q:
        raise ValueError(f"L={l} must be a positive multiple of chunk={q}")
    if g <= 0 or h % g:
        raise ValueError(f"{g} groups of b and c do not divide {h} heads")
    if n % 4 or p % 4:
        raise ValueError(f"N={n} and P={p} must be multiples of 4")
    if p > MAX_P:
        raise ValueError(f"P={p} is above the kernel's {MAX_P}")
    # the chunk-state kernel's p columns: 1, 2 or 4 pieces of 32
    state_pw = 32 * next(t for t in (1, 2, 4) if 32 * t >= p)
    pieces = _round_up(n, 16) // 16 * (state_pw // 32)
    if pieces > MAX_STATE_PIECES:
        raise ValueError(f"N={n}, P={p} make {pieces} state pieces, above {MAX_STATE_PIECES}")
    nc, nt = l // q, -(-q // TOKENS)
    return {"chunks": nc, "row_tiles": nt, "state_pieces": pieces,
            "state_blocks": bsz * nc * h,
            "pass_blocks": -(-(n * p // 4) // PASS_THREADS) * bsz * h,
            "output_blocks": bsz * nc * h * nt,
            "cum_shape": (bsz, h, l), "states_shape": (bsz, nc, h, n, p),
            "b_tf32_shape": (bsz, nc, h),
            "workspace_bytes": 4 * (bsz * h * l + bsz * nc * h * n * p + bsz * nc * h)}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.ssd_launch.restype = i
    lib.ssd_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


def ssd(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        h0: torch.Tensor, *, chunk: int):
    """xdt (B, L, H, P); da (B, L, H); b/c (B, L, G, N) with G dividing H
    (head h reads group h // (H / G)); h0 (B, H, N, P); all float32,
    contiguous, 16-byte aligned, on one CUDA device; L a multiple of
    ``chunk``; N and P multiples of 4, P <= 128, at most MAX_STATE_PIECES
    pieces (``plan``).  Returns (y (B, L, H, P), h_final (B, H, N, P))
    float32."""
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if xdt.dim() != 4 or b.dim() != 4:
        raise ValueError(f"xdt (B, L, H, P) and b (B, L, G, N), got "
                         f"{tuple(xdt.shape)} and {tuple(b.shape)}")
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    pl = plan(bsz, l, h, g, p, n, chunk)
    for name, t, shape in (("xdt", xdt, (bsz, l, h, p)), ("da", da, (bsz, l, h)),
                           ("b", b, (bsz, l, g, n)), ("c", c, (bsz, l, g, n)),
                           ("h0", h0, (bsz, h, n, p))):
        check(name, t, torch.float32, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for which, name in enumerate(("chunk-state", "output")):
        smem = _library().ssd_smem_bytes(which, n, p, chunk)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"N={n}, P={p}, chunk={chunk}: the {name} kernel needs {smem} B "
                             f"of shared memory per block, above {MAX_SMEM_BYTES}")
    y = torch.empty((bsz, l, h, p), dtype=torch.float32, device=dev)
    h_final = torch.empty((bsz, h, n, p), dtype=torch.float32, device=dev)
    if bsz * h * l == 0:
        return y, h_final
    cum = torch.empty(pl["cum_shape"], dtype=torch.float32, device=dev)
    states = torch.empty(pl["states_shape"], dtype=torch.float32, device=dev)
    b_tf32 = torch.empty(pl["b_tf32_shape"], dtype=torch.int32, device=dev)
    err = _library().ssd_launch(
        xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), cum.data_ptr(), states.data_ptr(), b_tf32.data_ptr(),
        bsz, l, h, g, p, n, chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return y, h_final
