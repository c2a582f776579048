"""Hand-written Hopper kernels for flash attention: the forward (prefill) and
the backward (training), their bindings, the forward's launch plan and the
launch wrappers.

The CUDA C++ sources are ``src/repro_torch/csrc/flash_attention.cu`` (the
forward, which also writes each row's log-sum-exp when asked) and
``src/repro_torch/csrc/flash_attention_bwd.cu`` (the backward: a pre-pass,
the main kernel that forms dK, dV and dQ's float32 sums, then dQ's
rounding, one C call counted as one launch; the source owns its row tiles
and its workspace's layout), built at first use by
:mod:`repro_torch.kernels._build`.  Nothing is built when this module is
imported.  The wrapper checks its inputs, allocates its
output (and, when the keys are split, the partials' workspace) with
``torch.empty``, launches on the current stream, raises if the launch did
not happen, and adds one to its count in :data:`LAUNCHES`.  The launch
plan (:func:`plan`) comes from the shapes and, where the caller passes it,
a host bound on kv_valid: q_pos and kv_valid stay on the device, and the
wrapper reads no tensor's values.  When the keys are split, one C call
launches the attention kernel and the kernel that merges the splits'
float32 partials from the workspace; it counts as one launch.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import check, load, raise_on

SOURCE = "flash_attention.cu"
SOURCE_BWD = "flash_attention_bwd.cu"

#: head dims the kernel is instantiated for
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)

#: launches since the last :func:`reset_launches`
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}

#: query rows of a block, (token, query head) pairs: 128 // rep tokens
#: times the rep query heads of one kv head (the source's kRows)
ROWS = 128
#: keys of a tile (the source's kKeys)
KEYS = 128
#: streaming multiprocessors of the H100; a block takes one of them
SMS = 132
MAX_SPLITS = 16
#: key tiles below which the plan does not split: a split adds the merge
#: kernel and float32 partials, about one tile's walk of device time, so
#: at 2 or 3 tiles it saves nothing (measured over the SmolLM serving
#: run's prefill chunks, PERF.md)
SPLIT_TILES = 4


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [p] * 9 + [i] * 11 + [p]
    lib.flash_attention_launch.restype = i
    return lib


@functools.cache
def _library_bwd() -> ctypes.CDLL:
    lib = load(SOURCE_BWD)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [p] * 12 + [i] * 8 + [p]
    lib.flash_attention_bwd_launch.restype = i
    lib.flash_attention_bwd_workspace.argtypes = [i] * 5
    lib.flash_attention_bwd_workspace.restype = ctypes.c_size_t
    return lib


def plan(b: int, sq: int, skv: int, hp: int, hkv: int, hd: int,
         valid: int | None = None) -> dict:
    """The launch's shape, from the shapes alone and, where the caller knows
    it on the host, ``valid``: a bound on kv_valid (a prefill chunk's end in
    its slot).

    A block takes ``tokens`` = ROWS // rep consecutive queries of one batch
    row with the rep query heads of one kv head (``qtiles`` blocks cover
    Sq, ``base`` = qtiles x hkv x b blocks in all), and a range of
    ``tiles_per_split`` consecutive KEYS-key tiles of the ``key_tiles``
    below min(Skv, valid); the last range runs on to the end of the keys.
    From SPLIT_TILES key tiles on, and where the card holds at least two
    blocks for each of the base ones, the keys are split as finely as one
    wave of blocks allows (at most one block an SM, MAX_SPLITS splits, one
    tile a split); ``blocks`` = base x splits.  Which tiles of a range a
    block visits (the masks) is decided on the device."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if hkv <= 0 or hp % hkv:
        raise ValueError(f"{hp} q heads over {hkv} kv heads")
    rep = hp // hkv
    if rep > ROWS:
        raise ValueError(f"{rep} q heads a kv head; a block holds at most {ROWS}")
    if b <= 0 or sq <= 0 or skv <= 0:
        raise ValueError(f"empty launch: B={b}, Sq={sq}, Skv={skv}")
    tokens = ROWS // rep
    qtiles = -(-sq // tokens)
    seen = skv if valid is None else max(1, min(skv, valid))
    key_tiles = -(-seen // KEYS)
    base = qtiles * hkv * b
    want = 1
    if key_tiles >= SPLIT_TILES:
        want = max(1, min(key_tiles, MAX_SPLITS, SMS // base))
    per = -(-key_tiles // want)
    splits = -(-key_tiles // per)
    return {"rep": rep, "tokens": tokens, "qtiles": qtiles, "key_tiles": key_tiles,
            "tiles_per_split": per, "splits": splits, "blocks": base * splits}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_valid: torch.Tensor, *,
                    causal: bool, window: int, valid: int | None = None,
                    kv_pos: torch.Tensor | None = None, lse: bool = False):
    """q (B, Sq, Hp, hd) bf16; k/v (B, Skv, Hkv, hd) bf16 with Hp a
    multiple of Hkv and at most 128 q heads a kv head; q_pos (B, Sq)
    int32; kv_valid (B,) int32; kv_pos, optional, (B, Skv) int32: the
    keys' absolute positions (-1 = unfilled), which the masks then test in
    place of the keys' indices and which turn the tile skipping off; all
    contiguous, 16-byte aligned, on one CUDA device; hd in
    :data:`HEAD_DIMS`.  ``valid``, where the caller knows it on the host,
    bounds kv_valid and shapes the launch plan (a larger kv_valid still
    attends right, at the last split's pace); with kv_pos it must be None.
    Returns (B, Sq, Hp, hd) bf16; with ``lse``, (out, lse (B, Hp, Sq)
    float32), each row's log-sum-exp for the backward."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q (B, Sq, Hp, hd) and k (B, Skv, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bsz, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if hkv == 0 or hp % hkv:
        raise ValueError(f"{hp} q heads over {hkv} kv heads")
    for name, t, dtype, shape in (
            ("q", q, torch.bfloat16, (bsz, sq, hp, hd)),
            ("k", k, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("v", v, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("q_pos", q_pos, torch.int32, (bsz, sq)),
            ("kv_valid", kv_valid, torch.int32, (bsz,)),
            ("kv_pos", kv_pos, torch.int32, (bsz, skv))):
        if t is None:
            continue
        check(name, t, dtype, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    if kv_pos is not None and valid is not None:
        raise ValueError("keys at their own positions take no bound on kv_valid")
    out = torch.empty((bsz, sq, hp, hd), dtype=torch.bfloat16, device=dev)
    lse_t = torch.empty((bsz, hp, sq), dtype=torch.float32, device=dev) if lse else None
    if out.numel() == 0:
        return (out, lse_t) if lse else out
    p = plan(bsz, sq, skv, hp, hkv, hd, valid)
    ws = None
    if p["splits"] > 1:
        ws = torch.empty(p["splits"] * bsz * sq * hp * (hd + 2), dtype=torch.float32,
                         device=dev)
    err = _library().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), kv_valid.data_ptr(),
        None if kv_pos is None else kv_pos.data_ptr(), out.data_ptr(),
        None if lse_t is None else lse_t.data_ptr(), None if ws is None else ws.data_ptr(),
        bsz, sq, skv, hp, hkv, hd,
        int(bool(causal)), int(window), p["tokens"], p["splits"], p["tiles_per_split"],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(err, "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return (out, lse_t) if lse else out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                        q_pos: torch.Tensor, kv_valid: torch.Tensor, *, causal: bool,
                        window: int) -> tuple:
    """The backward of :func:`flash_attention` (keys at their indices): q,
    out, dout (B, Sq, Hp, hd) bf16; k, v (B, Skv, Hkv, hd) bf16; lse (B,
    Hp, Sq) float32 from the forward; q_pos (B, Sq) and kv_valid (B,)
    int32; all contiguous, 16-byte aligned, on one CUDA device.  Returns
    (dq, dk, dv) bf16 in q's, k's and v's shapes, dk and dv summed over
    each kv head's query heads in the kernel.  Allocates the float32
    workspace whose size the library gives (dq's sums, the row tiles'
    records); one C call, on q's device, launches the three kernels and
    counts one launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q (B, Sq, Hp, hd) and k (B, Skv, Hkv, hd), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bsz, sq, hp, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one of {HEAD_DIMS}")
    if hkv == 0 or hp % hkv:
        raise ValueError(f"{hp} q heads over {hkv} kv heads")
    for name, t, dtype, shape in (
            ("q", q, torch.bfloat16, (bsz, sq, hp, hd)),
            ("k", k, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("v", v, torch.bfloat16, (bsz, skv, hkv, hd)),
            ("out", out, torch.bfloat16, (bsz, sq, hp, hd)),
            ("dout", dout, torch.bfloat16, (bsz, sq, hp, hd)),
            ("lse", lse, torch.float32, (bsz, hp, sq)),
            ("q_pos", q_pos, torch.int32, (bsz, sq)),
            ("kv_valid", kv_valid, torch.int32, (bsz,))):
        check(name, t, dtype, shape, dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    lib = _library_bwd()
    floats = lib.flash_attention_bwd_workspace(bsz, sq, hp, hkv, hd)
    if floats == 0:
        raise ValueError(f"the backward kernel takes no {hp // hkv} q heads a kv head "
                         f"(B={bsz}, Sq={sq}, {hp}/{hkv} heads of {hd})")
    ws = torch.empty(floats, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), q_pos.data_ptr(), kv_valid.data_ptr(), ws.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), bsz, sq, skv, hp, hkv, hd,
            int(bool(causal)), int(window), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
