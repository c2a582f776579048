"""Hand-written Hopper kernels for bit-plane paged decode attention: the
binding, the launch plan and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/paged_attention.cu``, built
at first use by :mod:`repro_torch.kernels._build`.  Nothing is built or
imported when this module is imported.

Each wrapper checks device, dtype, shape, contiguity and 16-byte alignment,
allocates its outputs (and, when S is split, the partials' workspace) with
``torch.empty``, launches on the current stream, raises if the launch did
not happen, and adds one to its count in :data:`LAUNCHES`.  The
launch plan (:func:`plan`) comes from the shapes alone: the valid lengths
and plane maps stay on the device, and no wrapper reads a tensor's values.
When S is split, one C call launches the attention kernel and the kernel
that merges the splits; it counts as one launch.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "paged_attention.cu"

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"paged_attention_fused": 0, "paged_attention_rung": 0}

PAGE = 16
#: streaming multiprocessors of the H100; the plan aims at one block on
#: each of them at a time, two where head_dim <= 64 (the kernel's register
#: bound lets two share an SM, each in half its shared memory)
SMS = 132
#: compute warps of a block, one per (kv head, 16 query rows) tile; the
#: block also has 7 or 11 warps that rebuild the planes and one that loads
#: them
COMPUTE_WARPS = 4
MAX_SPLITS = 64
#: shared memory one block may take on the H100
SMEM_MAX = 227 * 1024
#: planes of a bf16 pattern; a ring stage of the fused kernel holds them all
BITS = 16
#: bf16 K/V tile buffers of a block (the source's kTileBufs)
TILE_BUFFERS = 3


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.paged_attention_fused_launch.argtypes = [p] * 7 + [i] * 10 + [f, p]
    lib.paged_attention_fused_launch.restype = i
    lib.paged_attention_rung_launch.argtypes = [p] * 8 + [i] * 11 + [f, p]
    lib.paged_attention_rung_launch.restype = i
    return lib


def _tile_width(hd: int) -> int:
    """The source's instantiated tile width for head_dim ``hd``."""
    return next(w for w in (16, 32, 64, 128, 256) if hd <= w)


def smem_bytes(heads: int, hd: int, qtiles: int, pps: int) -> int:
    """Dynamic shared memory of one block with one ring stage (the source's
    ``layout``): the mbarriers, three bf16 K/V tile buffers, the compute
    warps' query tiles, one stage of all 16 planes of K and V, then the
    live-page list.  The launcher adds stages while they fit."""
    ld = _tile_width(hd) + 8
    tiles = TILE_BUFFERS * (2 * heads * (PAGE * ld + 8)) * 2
    query = heads * qtiles * PAGE * ld * 2
    run = PAGE * heads * (hd // 8)
    return 256 + -(-tiles // 128) * 128 + query + 2 * BITS * run + pps * 24


def blocks_per_sm(hd: int) -> int:
    """Blocks the kernel fits on one SM at once: two up to 64 dims (each
    in half the SM's shared memory), one above."""
    return 2 if hd <= 64 else 1


def smem_budget(hd: int) -> int:
    """Shared memory one block may take (the source's ``budget``)."""
    return SMEM_MAX if blocks_per_sm(hd) == 1 else SMEM_MAX // 2 - 1024


def plan(b: int, s: int, hkv: int, rep: int, hd: int) -> dict:
    """The launch's shape, from the shapes alone.

    A block takes one batch row, ``heads`` kv heads (all ``hkv`` unless
    COMPUTE_WARPS 16-row query tiles or shared memory force head
    groups; the largest divisor of ``hkv`` that fits), ``qtiles`` query
    tiles of each, and ``pages`` consecutive 16-token pages (a split of S).
    Splits are as few as give a block to every SM (two where
    :func:`blocks_per_sm` says so), at most MAX_SPLITS and one page each;
    ``blocks`` = splits x b x head groups x query groups."""
    if hd % 8 != 0 or not 0 < hd <= 256:
        raise ValueError(f"head_dim must be a multiple of 8 up to 256, got {hd}")
    if s % PAGE != 0:
        raise ValueError(f"the kernel walks 16-token pages; S={s} is not a multiple")
    n_pages = s // PAGE
    q_all = -(-rep // 16)
    qtiles = min(q_all, COMPUTE_WARPS)
    qgroups = -(-q_all // qtiles)
    for heads in sorted((d for d in range(1, hkv + 1) if hkv % d == 0), reverse=True):
        if heads * qtiles > COMPUTE_WARPS:
            continue
        groups = hkv // heads * qgroups
        target = SMS * blocks_per_sm(hd)
        want = max(1, min(n_pages, MAX_SPLITS, -(-target // (b * groups))))
        pps = max(1, -(-n_pages // want))
        splits = max(1, -(-n_pages // pps))
        if smem_bytes(heads, hd, qtiles, pps) <= smem_budget(hd):
            return {"heads": heads, "qtiles": qtiles, "qgroups": qgroups, "pages": pps,
                    "splits": splits, "blocks": splits * b * groups}
    raise ValueError(f"no launch plan fits shared memory at hkv={hkv}, rep={rep}, hd={hd}")


def _aligned16(**tensors) -> None:
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start at a 16-byte aligned address")


def _geometry(q, k_planes, v_planes, mask, bits):
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {q.device}")
    if bits != BITS:
        raise ValueError(f"the kernel rebuilds 16-bit bf16 patterns, got bits={bits}")
    b, hkv, rep, hd = q.shape
    s = k_planes.shape[2]
    check("q", q, torch.bfloat16, (b, hkv, rep, hd), q.device)
    for name, t in (("k_planes", k_planes), ("v_planes", v_planes)):
        check(name, t, torch.uint8, (bits, b, s, hkv, hd // 8), q.device)
    check("mask", mask, torch.int8, (b, s), q.device)
    _aligned16(q=q, k_planes=k_planes, v_planes=v_planes, mask=mask)
    return b, s, hkv, rep, hd


def _launch_args(q, b, s, hkv, rep, hd, p):
    """The splits' workspace (None with one split), the plan's ints and
    the current stream."""
    ws = None
    if p["splits"] > 1:
        ws = torch.empty(p["splits"] * b * hkv * rep * (hd + 2), dtype=torch.float32,
                         device=q.device)
    ints = [b, s, hkv, rep, hd, p["heads"], p["qtiles"], p["qgroups"], p["pages"],
            p["splits"]]
    return ws, ints, torch.cuda.current_stream(q.device).cuda_stream


def paged_attention_fused(q, k_planes, v_planes, page_keeps, mask, *,
                          bits: int = 16, page_tokens: int = 16):
    """Normalised attention output (B, Hkv, rep, hd) float32 over the
    mixed-precision cache; page p of row b reads planes [0, page_keeps[b, p])."""
    if page_tokens != PAGE:
        raise ValueError(f"the kernel's pages are 16 tokens, got {page_tokens}")
    b, s, hkv, rep, hd = _geometry(q, k_planes, v_planes, mask, bits)
    check("page_keeps", page_keeps, torch.int32, (b, s // PAGE), q.device)
    p = plan(b, s, hkv, rep, hd)
    out = torch.empty((b, hkv, rep, hd), dtype=torch.float32, device=q.device)
    ws, ints, stream = _launch_args(q, b, s, hkv, rep, hd, p)
    err = _library().paged_attention_fused_launch(
        q.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(), page_keeps.data_ptr(),
        mask.data_ptr(), out.data_ptr(), None if ws is None else ws.data_ptr(), *ints,
        1.0 / math.sqrt(hd), stream,
    )
    raise_on(err, "paged_attention_fused")
    LAUNCHES["paged_attention_fused"] += 1
    return out


def paged_attention_rung(q, k_planes, v_planes, mask, *, keep: int,
                         bits: int = 16):
    """Unnormalised partials (o (B, Hkv, rep, hd), m, l (B, Hkv, rep))
    float32 of one precision rung: every masked-in token at ``keep`` planes."""
    b, s, hkv, rep, hd = _geometry(q, k_planes, v_planes, mask, bits)
    if not 0 < keep <= bits:
        raise ValueError(f"keep must be in [1, {bits}], got {keep}")
    p = plan(b, s, hkv, rep, hd)
    o = torch.empty((b, hkv, rep, hd), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hkv, rep), dtype=torch.float32, device=q.device)
    l = torch.empty((b, hkv, rep), dtype=torch.float32, device=q.device)
    ws, ints, stream = _launch_args(q, b, s, hkv, rep, hd, p)
    err = _library().paged_attention_rung_launch(
        q.data_ptr(), k_planes.data_ptr(), v_planes.data_ptr(), mask.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), None if ws is None else ws.data_ptr(),
        *ints, keep, 1.0 / math.sqrt(hd), stream,
    )
    raise_on(err, "paged_attention_rung")
    LAUNCHES["paged_attention_rung"] += 1
    return o, m, l
