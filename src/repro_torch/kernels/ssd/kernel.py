"""Hand-written Hopper kernels for Mamba2's chunked SSD scan and its
backward: the bindings, the launch plans and the launch wrappers.

The CUDA C++ sources are ``src/repro_torch/csrc/ssd.cu`` (the forward)
and ``csrc/ssd_bwd.cu`` (the backward), each built at first use by
:mod:`repro_torch.kernels._build`.  Nothing is built when this module is
imported.  A forward call launches three kernels (chunk states, the pass
over chunks, the outputs) and counts one ``"ssd"`` launch in
:data:`LAUNCHES`; a backward call launches six (the chunks' gradient
sums, the reverse pass over chunks, the column tiles, which compute each
tile pair's scores once, the row tiles, dda, the group sums) and counts
one ``"ssd_bwd"`` launch.  The wrappers check their
inputs, allocate their outputs and workspaces with ``torch.empty``,
launch on the current stream and raise if a launch did not happen.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "ssd.cu"
BWD_SOURCE = "ssd_bwd.cu"

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
LAUNCHES = {"ssd": 0, "ssd_bwd": 0}


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


def plan_bwd(bsz: int, l: int, h: int, g: int, p: int, n: int, q: int) -> dict:
    """The shapes of the backward's workspaces that follow from the shapes
    alone (D_c's partial sums also take the library's ``ssd_bwd_slices``
    a chunk): G_{c+1} a chunk, db and dc a head, the row and column sums
    of dcum, and what the column kernel hands the row kernel: each tile
    pair's decayed dy.xdt tile (``score_tiles_shape``: pairs i >= j of the
    chunk's TOKENS-token tiles, i (i + 1) / 2 + j, each TOKENS x TOKENS)
    and each column tile's part of M's row sums (``row_part_shape``).
    Raises ValueError on a shape the kernel cannot take (N and P at most
    128, at most MAX_STATE_PIECES state pieces as in :func:`plan`; its
    shared memory is the library's to say: ``ssd_bwd_smem_bytes``, checked
    by the wrapper)."""
    if q <= 0 or l % q:
        raise ValueError(f"L={l} must be a positive multiple of chunk={q}")
    if g <= 0 or h % g:
        raise ValueError(f"{g} groups of b and c do not divide {h} heads")
    if n % 4 or p % 4:
        raise ValueError(f"N={n} and P={p} must be multiples of 4")
    if n > MAX_P or p > MAX_P:
        raise ValueError(f"N={n} and P={p} must be at most {MAX_P}")
    # the chunks' gradient sums hold N x P in 16 x 32 pieces, as the
    # forward's chunk states do
    state_pw = 32 * next(t for t in (1, 2, 4) if 32 * t >= p)
    pieces = _round_up(n, 16) // 16 * (state_pw // 32)
    if pieces > MAX_STATE_PIECES:
        raise ValueError(f"N={n}, P={p} make {pieces} state pieces, above {MAX_STATE_PIECES}")
    nc, nt = l // q, -(-q // TOKENS)
    return {"gst_shape": (bsz, nc, h, n, p), "per_head_shape": (bsz, l, h, n),
            "term_shape": (bsz, h, l),
            "score_tiles_shape": (bsz, nc, h, nt * (nt + 1) // 2, TOKENS, TOKENS),
            "row_part_shape": (bsz, nc, h, nt, q)}


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p] * 10 + [i] * 7 + [p]
    lib.ssd_launch.restype = i
    lib.ssd_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    lib = load(BWD_SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_bwd_launch.argtypes = [p] * 21 + [i] * 7 + [p]
    lib.ssd_bwd_launch.restype = i
    lib.ssd_bwd_smem_bytes.argtypes = [i, i, i, i]
    lib.ssd_bwd_smem_bytes.restype = ctypes.c_longlong
    lib.ssd_bwd_slices.argtypes = [i, i]
    lib.ssd_bwd_slices.restype = i
    return lib


def ssd(xdt: torch.Tensor, da: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        h0: torch.Tensor, *, chunk: int, workspaces: bool = False):
    """xdt (B, L, H, P); da (B, L, H); b/c (B, L, G, N) with G dividing H
    (head h reads group h // (H / G)); h0 (B, H, N, P); all float32,
    contiguous, 16-byte aligned, on one CUDA device; L a multiple of
    ``chunk``; N and P multiples of 4, P <= 128, at most MAX_STATE_PIECES
    pieces (``plan``).  Returns (y (B, L, H, P), h_final (B, H, N, P))
    float32; with ``workspaces`` also the two the backward reads: cum (B,
    H, L), each chunk's inclusive cumsum of da, and states (B, L / chunk,
    H, N, P), the state before each chunk."""
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
    cum = torch.empty(pl["cum_shape"], dtype=torch.float32, device=dev)
    states = torch.empty(pl["states_shape"], dtype=torch.float32, device=dev)
    if bsz * h * l == 0:
        return (y, h_final, cum, states) if workspaces else (y, h_final)
    b_tf32 = torch.empty(pl["b_tf32_shape"], dtype=torch.int32, device=dev)
    err = _library().ssd_launch(
        xdt.data_ptr(), da.data_ptr(), b.data_ptr(), c.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_final.data_ptr(), cum.data_ptr(), states.data_ptr(), b_tf32.data_ptr(),
        bsz, l, h, g, p, n, chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd")
    LAUNCHES["ssd"] += 1
    return (y, h_final, cum, states) if workspaces else (y, h_final)


def ssd_bwd(xdt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, dy: torch.Tensor,
            cum: torch.Tensor, states: torch.Tensor, h_final: torch.Tensor,
            dh_final: torch.Tensor | None, *, chunk: int):
    """The backward of :func:`ssd` (``csrc/ssd_bwd.cu``; the plain version
    is ``ref.ssd_bwd_ref``).  xdt (B, L, H, P), b/c (B, L, G, N) as the
    forward took them; dy (B, L, H, P) the gradient of y; cum, states and
    h_final the forward's (``ssd(..., workspaces=True)``); dh_final (B, H,
    N, P) or None (zero); all float32, contiguous, 16-byte aligned, on one
    CUDA device; L a multiple of ``chunk``; N and P multiples of 4, at most
    128.  Returns (dxdt (B, L, H, P), dda (B, L, H), db, dc (B, L, G, N)
    summed over each group's heads, dh0 (B, H, N, P)), float32.  Every sum
    runs in a fixed order: the same inputs give the same bits.  The TF32
    passes of each product follow the bits of the b and c tiles it reads:
    three on float32 operands, one fewer for each TF32-valued one."""
    dev = xdt.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if xdt.dim() != 4 or b.dim() != 4:
        raise ValueError(f"xdt (B, L, H, P) and b (B, L, G, N), got "
                         f"{tuple(xdt.shape)} and {tuple(b.shape)}")
    bsz, l, h, p = xdt.shape
    g, n = b.shape[-2:]
    pl = plan_bwd(bsz, l, h, g, p, n, chunk)
    nc = l // chunk
    named = [("xdt", xdt, (bsz, l, h, p)), ("b", b, (bsz, l, g, n)), ("c", c, (bsz, l, g, n)),
             ("dy", dy, (bsz, l, h, p)), ("cum", cum, (bsz, h, l)),
             ("states", states, (bsz, nc, h, n, p)), ("h_final", h_final, (bsz, h, n, p))]
    if dh_final is not None:
        named.append(("dh_final", dh_final, (bsz, h, n, p)))
    for name, t, shape in named:
        check(name, t, torch.float32, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    lib = _library_bwd()
    for which, name in enumerate(("chunk-grad", "column", "row")):
        smem = lib.ssd_bwd_smem_bytes(which, n, p, chunk)
        if smem > MAX_SMEM_BYTES:
            raise ValueError(f"N={n}, P={p}, chunk={chunk}: the {name} kernel needs {smem} B "
                             f"of shared memory per block, above {MAX_SMEM_BYTES}")

    def empty(shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dx, dda, dh0 = empty((bsz, l, h, p)), empty((bsz, l, h)), empty((bsz, h, n, p))
    db, dc = empty((bsz, l, g, n)), empty((bsz, l, g, n))
    if bsz * h * l == 0:
        return dx, dda, db, dc, dh0
    gst, dpart = empty(pl["gst_shape"]), empty((bsz, nc, h, lib.ssd_bwd_slices(n, p)))
    db_h, dc_h = empty(pl["per_head_shape"]), empty(pl["per_head_shape"])
    rowterm, colterm = empty(pl["term_shape"]), empty(pl["term_shape"])
    escore, rowpart = empty(pl["score_tiles_shape"]), empty(pl["row_part_shape"])
    with_dh = dh_final is not None
    err = lib.ssd_bwd_launch(
        xdt.data_ptr(), b.data_ptr(), c.data_ptr(), dy.data_ptr(), cum.data_ptr(),
        states.data_ptr(), h_final.data_ptr() if with_dh else None,
        dh_final.data_ptr() if with_dh else None, dx.data_ptr(), dda.data_ptr(),
        db.data_ptr(), dc.data_ptr(), dh0.data_ptr(), gst.data_ptr(), db_h.data_ptr(),
        dc_h.data_ptr(), rowterm.data_ptr(), colterm.data_ptr(), dpart.data_ptr(),
        escore.data_ptr(), rowpart.data_ptr(),
        bsz, l, h, g, p, n, chunk, torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "ssd_bwd")
    LAUNCHES["ssd_bwd"] += 1
    return dx, dda, db, dc, dh0
