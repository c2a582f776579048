"""Hand-written Hopper kernels for the exponent-delta transform: the
binding and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/exp_delta.cu``, built at
first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.

Raw bits travel in the bit-plane kernels' integer containers (``uint8``,
``int16``, ``int32``).  Two encode entry points, one kernel:

* :func:`cluster_encode`, the KV page write's: a token-major (..., tokens,
  channels) view, read in place through its strides, clustered into
  channel-major groups of G tokens (a ragged tail group repeats the last
  token) and encoded, in one launch (:func:`layout` and :func:`plan` are
  its addressing and tiles);
* :func:`encode`: (R, G) channel-major rows, the TPU kernel's contract,
  served as the (R, G, 1) view: pages of one channel.

Each wrapper checks its inputs, allocates its outputs with ``torch.empty``,
launches on the current stream, raises if the launch did not happen, and
adds one to its count in :data:`LAUNCHES`.  No wrapper reads a tensor's
values on the host.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels._build import aligned, check, load, raise_on
from repro_torch.kernels.bitplane.kernel import CONTAINERS

SOURCE = "exp_delta.cu"

#: the longest row (tokens per channel group) the kernels take
MAX_GROUP = 32
#: a block's threads at most, and a tile's (page, channel) units at most
THREADS = 256
#: a tile's staged token rows in shared memory, at most
MAX_TILE_BYTES = 32 * 1024
#: leading dims the encode addresses, after merging
MAX_LEADS = 3

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"exp_delta_encode": 0, "exp_delta_decode": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.exp_delta_encode_launch.argtypes = [p, p, p] + [ll] * 8 + [i] * 9 + [p]
    lib.exp_delta_encode_launch.restype = i
    lib.exp_delta_decode_launch.argtypes = [p, p, p, ll, i, i, i, i, p]
    lib.exp_delta_decode_launch.restype = i
    return lib


def _width(t: torch.Tensor) -> int:
    """The container width of a raw-bit tensor on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {t.device}")
    widths = {d: w for w, d in CONTAINERS.items()}
    if t.dtype not in widths:
        raise TypeError(f"raw bits ride in {list(CONTAINERS.values())}, got {t.dtype}")
    return widths[t.dtype]


def _rows(name: str, t: torch.Tensor) -> tuple:
    """(R, G, container width) of a raw-bit row tensor on a CUDA device."""
    width = _width(t)
    if t.dim() != 2 or not 1 <= t.shape[1] <= MAX_GROUP:
        raise ValueError(f"{name} is (R, G) with 1 <= G <= {MAX_GROUP}, got {tuple(t.shape)}")
    return t.shape[0], t.shape[1], width


def _field(width: int, man_bits: int, exp_mask: int) -> None:
    if not 0 < exp_mask <= 0xFF or (exp_mask << man_bits) >> (8 * width):
        raise ValueError(f"exponent field {exp_mask:#x} << {man_bits} does not fit "
                         f"a {width}-byte value with an 8-bit base")


def layout(u: torch.Tensor, group: int) -> dict:
    """The encode's addressing of a (..., t, C) raw-bit view, from its shape
    and strides (in values): the leading dims, size-1 dims dropped and
    neighbours merged where one steps over the other, padded in front to
    :data:`MAX_LEADS` with (1, 0) (``n``, ``s``); tokens ``t`` at stride
    ``st``, an inner leading dim that steps over whole groups of them
    folded in (its pages follow on); channels ``c`` (stride 1); pages of
    ``group`` tokens per leading index (``n_pages``) and in all
    (``pages``).  Pure Python; the kernel addresses token j of page p of
    leading index (i0, i1, i2), channel x, at i0 s0 + i1 s1 + i2 s2 +
    min(p group + j, t - 1) st + x."""
    shape, stride = tuple(u.shape), u.stride()
    if len(shape) < 2:
        raise ValueError(f"the encode takes (..., tokens, channels), got {shape}")
    *lead, t, c = shape
    *lead_s, st, sc = stride
    if c > 1 and sc != 1:
        raise ValueError(f"channels must be dense (stride 1), got strides {stride}")
    dims: list = []
    for n, s in zip(lead, lead_s):
        if n == 1:
            continue
        if dims and dims[-1][1] == n * s:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    while dims and t % group == 0 and dims[-1][1] == t * st:
        t *= dims.pop()[0]
    if 0 in lead:
        dims = [(0, 0)]
    if len(dims) > MAX_LEADS:
        raise ValueError(f"the encode addresses {MAX_LEADS} leading dims, this view needs "
                         f"{len(dims)}: shape {shape}, strides {stride}")
    dims = [(1, 0)] * (MAX_LEADS - len(dims)) + dims
    n_pages = -(-t // group)
    return {"n": tuple(n for n, _ in dims), "s": tuple(s for _, s in dims), "t": t,
            "st": st, "c": c, "g": group, "n_pages": n_pages,
            "pages": math.prod(n for n, _ in dims) * n_pages}


def plan(lay: dict, width: int, address: int) -> dict:
    """The launch of :func:`layout`'s view whose first value lies at byte
    ``address``.  Its ``path``: "direct" where a page is one channel of
    contiguous tokens and no tail is ragged (a thread loads each unit's
    row itself, as 16-byte vectors at G = 16, so there the address and the
    leading strides must keep them aligned), THREADS pages a block;
    otherwise one tile a block, ``tile_pages`` whole pages (at most
    ``THREADS`` units of (page, channel) and ``MAX_TILE_BYTES`` of staged
    rows) or, above ``THREADS`` channels, a ``chunk`` of one page's
    channels, the tile's token rows staged at ``row_bytes`` a row: "vec"
    (16-byte vectors) where the address and every stride that steps keep
    them aligned and rows are whole vectors, else "bytes" (value by
    value)."""
    g, c, pages = lay["g"], lay["c"], lay["pages"]
    leads_vec = all(n <= 1 or s * width % 16 == 0 for n, s in zip(lay["n"], lay["s"]))
    if (c == 1 and lay["st"] == 1 and lay["t"] % g == 0
            and (g != 16 or (address % 16 == 0 and leads_vec))):
        return {"path": "direct", "tile_pages": THREADS, "chunk": 1, "chunks": 1,
                "row_bytes": 16, "blocks": -(-pages // THREADS), "threads": THREADS,
                "smem": 0}
    chunk = min(c, THREADS)
    chunks = -(-c // chunk)
    row_bytes = -(-chunk * width // 16) * 16
    tile_pages = 1 if chunks > 1 else max(1, min(THREADS // c, MAX_TILE_BYTES // (g * row_bytes)))
    vec = (address % 16 == 0 and c * width % 16 == 0 and leads_vec
           and (lay["t"] <= 1 or lay["st"] * width % 16 == 0))
    return {"path": "vec" if vec else "bytes", "tile_pages": tile_pages, "chunk": chunk,
            "chunks": chunks, "row_bytes": row_bytes,
            "blocks": -(-pages // tile_pages) * chunks,
            "threads": -(-tile_pages * chunk // 32) * 32,
            "smem": tile_pages * g * row_bytes}


#: the launcher's code for each path
PATHS = {"bytes": 0, "vec": 1, "direct": 2}


def _encode(u: torch.Tensor, enc: torch.Tensor, base: torch.Tensor, group: int,
            width: int, man_bits: int, exp_mask: int) -> None:
    lay = layout(u, group)
    if lay["pages"] == 0:
        return
    if lay["pages"] * lay["c"] >= 2**31:
        raise ValueError(f"{lay['pages']} pages of {lay['c']} channels: units past 2^31")
    p = plan(lay, width, u.data_ptr())
    err = _library().exp_delta_encode_launch(
        u.data_ptr(), enc.data_ptr(), base.data_ptr(), *lay["n"], *lay["s"], lay["t"],
        lay["st"], lay["c"], group, p["tile_pages"], p["chunk"], p["row_bytes"],
        PATHS[p["path"]], width, man_bits, exp_mask,
        torch.cuda.current_stream(u.device).cuda_stream,
    )
    raise_on(err, "exp_delta_encode")
    LAUNCHES["exp_delta_encode"] += 1


def cluster_encode(u: torch.Tensor, group: int, man_bits: int, exp_mask: int) -> tuple:
    """(..., t, C) token-major raw bits, any strides with the channels dense
    -> (encoded (..., ceil(t / group), C, group) in u's container, base
    (..., ceil(t / group), C) uint8), both contiguous, in one launch: per
    leading index, the tokens cut into channel-major groups (a ragged tail
    group repeats token t - 1), each channel's smallest exponent field its
    base, subtracted from every value's.  The view is read in place."""
    width = _width(u)
    if not 1 <= group <= MAX_GROUP:
        raise ValueError(f"groups of 1 to {MAX_GROUP} tokens, got {group}")
    _field(width, man_bits, exp_mask)
    if u.dim() < 2:
        raise ValueError(f"the encode takes (..., tokens, channels), got {tuple(u.shape)}")
    *lead, t, c = u.shape
    n_pages = -(-t // group)
    enc = torch.empty((*lead, n_pages, c, group), dtype=u.dtype, device=u.device)
    base = torch.empty((*lead, n_pages, c), dtype=torch.uint8, device=u.device)
    _encode(u, enc, base, group, width, man_bits, exp_mask)
    return enc, base


def encode(u: torch.Tensor, man_bits: int, exp_mask: int) -> tuple:
    """(R, G) raw bits -> (encoded (R, G) in u's container, base (R,) uint8):
    each row's smallest exponent field is its base and is subtracted from
    every value's exponent field.  The rows are the (R, G, 1) view's pages,
    one channel each, read in place."""
    r, g, _ = _rows("u", u)
    enc, base = cluster_encode(u[:, :, None], g, man_bits, exp_mask)
    return enc.view(r, g), base.view(r)


def decode(enc: torch.Tensor, base: torch.Tensor, man_bits: int,
           exp_mask: int) -> torch.Tensor:
    """(R, G) encoded raw bits and (R,) uint8 bases -> (R, G) raw bits: each
    value's exponent field plus its row's base, modulo the field."""
    r, g, width = _rows("enc", enc)
    _field(width, man_bits, exp_mask)
    enc = aligned(enc)
    check("base", base, torch.uint8, (r,), enc.device)
    out = torch.empty_like(enc)
    if r == 0:
        return out
    err = _library().exp_delta_decode_launch(
        enc.data_ptr(), base.data_ptr(), out.data_ptr(), r, g, width, man_bits,
        exp_mask, torch.cuda.current_stream(enc.device).cuda_stream,
    )
    raise_on(err, "exp_delta_decode")
    LAUNCHES["exp_delta_decode"] += 1
    return out
