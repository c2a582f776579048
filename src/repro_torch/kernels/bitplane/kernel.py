"""Hand-written Hopper kernels for bit-plane pack and unpack: the binding
and the launch wrappers.

The CUDA C++ source is ``src/repro_torch/csrc/bitplane.cu``, built at
first use by :mod:`repro_torch.kernels._build`.  Nothing is built when
this module is imported.

Values travel as raw bits in integer containers of 1, 2 or 4 bytes
(``uint8``, ``int16``, ``int32``: torch's arithmetic on its unsigned 16-
and 32-bit types is partial, so the 16- and 32-bit patterns ride in the
signed types of the same width).  Two kernels serve every entry point:

* the flat ones, :func:`pack` and :func:`unpack`: one stream of m values;
* the KV cache's, :func:`pack_kv_into` and :func:`unpack_kv_pair`: K and V
  of a (bits, A, B, Hkv, hd/8) plane cache in one launch, the planes read
  or written in place through their strides (:func:`plane_rows`).

Each wrapper checks its inputs, allocates its output with ``torch.empty``
(``pack_kv_into`` writes into the caller's planes), launches on the current
stream, raises if the launch did not happen, and adds one to its count in
:data:`LAUNCHES`: a launch that packs or unpacks K and V counts once.
No wrapper reads a tensor's values on the host.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels._build import aligned, check, load, raise_on

SOURCE = "bitplane.cu"

#: raw-bit container per value width in bytes
CONTAINERS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}

#: launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"bitplane_pack": 0, "bitplane_unpack": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def _library() -> ctypes.CDLL:
    lib = load(SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bitplane_pack_launch.argtypes = [p, p, p, p, i] + [ll] * 6 + [i, i, p, ll, ll, p]
    lib.bitplane_pack_launch.restype = i
    lib.bitplane_unpack_launch.argtypes = [p, p, p, p, i] + [ll] * 6 + [i, i, i, p]
    lib.bitplane_unpack_launch.restype = i
    lib.bitplane_empty_launch.argtypes = [p]
    lib.bitplane_empty_launch.restype = i
    return lib


def _width(dtype: torch.dtype, bits: int) -> int:
    widths = {t: w for w, t in CONTAINERS.items()}
    if dtype not in widths:
        raise TypeError(f"raw bits ride in {list(CONTAINERS.values())}, got {dtype}")
    if not 0 < bits <= 8 * widths[dtype]:
        raise ValueError(f"{bits} bits do not fit a {dtype} container")
    return widths[dtype]


def _cuda(t: torch.Tensor, name: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {name} on {t.device}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def plane_rows(k_planes: torch.Tensor, v_planes: torch.Tensor) -> dict:
    """The row layout of a KV plane pair, (n, A, B, Hkv, hd/8) uint8 each
    (the cache's (bits, batch, positions, Hkv, hd/8), or any view of it
    whose last two dims are dense): A x B rows of r8 = Hkv * hd/8 bytes,
    row (a, b) of plane i at i * ps + a * sa + b * sb bytes.  Pure Python
    from shapes and strides; the kernels take both streams with one set."""
    if k_planes.dim() != 5:
        raise ValueError(f"KV planes are (n, A, B, Hkv, hd/8), got {tuple(k_planes.shape)}")
    if k_planes.dtype != torch.uint8:
        raise TypeError(f"KV planes are uint8, got {k_planes.dtype}")
    if v_planes.shape != k_planes.shape or v_planes.stride() != k_planes.stride() \
            or v_planes.dtype != k_planes.dtype or v_planes.device != k_planes.device:
        raise ValueError("K and V planes differ in shape, stride, dtype or device")
    n, a, b, hkv, hd8 = k_planes.shape
    ps, sa, sb, sh, sd = k_planes.stride()
    if sd != 1 or (hkv > 1 and sh != hd8):
        raise ValueError(f"a KV plane row (Hkv, hd/8) must be dense, strides {k_planes.stride()}")
    return {"planes": n, "n_a": a, "n_b": b, "r8": hkv * hd8, "ps": ps, "sa": sa, "sb": sb}


def _pack(srcs, dsts, n_a, n_b, r8, ps, sa, sb, width, bits, start, start0, s_max, dev):
    src1 = srcs[-1].data_ptr()
    dst1 = dsts[-1].data_ptr()
    err = _library().bitplane_pack_launch(
        srcs[0].data_ptr(), src1, dsts[0].data_ptr(), dst1, len(srcs), n_a, n_b, r8,
        ps, sa, sb, width, bits, None if start is None else start.data_ptr(), start0,
        s_max, _stream(dev))
    raise_on(err, "bitplane_pack")
    LAUNCHES["bitplane_pack"] += 1


def _unpack(srcs, out, n_a, n_b, r8, ps, sa, sb, width, bits, keep, dev):
    streams = len(srcs)
    second = out.data_ptr() + out.numel() // streams * out.element_size()
    err = _library().bitplane_unpack_launch(
        srcs[0].data_ptr(), srcs[-1].data_ptr(), out.data_ptr(), second, streams,
        n_a, n_b, r8, ps, sa, sb, width, bits, keep, _stream(dev))
    raise_on(err, "bitplane_unpack")
    LAUNCHES["bitplane_unpack"] += 1


def pack(u: torch.Tensor, bits: int) -> torch.Tensor:
    """(m,) raw bits, m % 8 == 0 -> (bits, m/8) uint8 planes, plane 0 = MSB."""
    _cuda(u, "u")
    width = _width(u.dtype, bits)
    m = u.numel()
    if m % 8 != 0:
        raise ValueError(f"bit-planes pack octets of values; m={m} is not a multiple of 8")
    check("u", u, u.dtype, (m,), u.device)
    planes = torch.empty((bits, m // 8), dtype=torch.uint8, device=u.device)
    if m == 0:
        return planes
    m8 = m // 8
    _pack((aligned(u),), (planes,), 1, 1, m8, m8, 0, 0, width, bits, None, 0, 0, u.device)
    return planes


def unpack(planes: torch.Tensor, bits: int, keep: int,
           dtype: torch.dtype) -> torch.Tensor:
    """planes (n, m/8) uint8 with n >= keep -> (m,) raw bits in ``dtype``
    from planes [0, keep) only; the low ``bits - keep`` bits are zero."""
    _cuda(planes, "planes")
    width = _width(dtype, bits)
    if planes.dim() != 2:
        raise ValueError(f"planes are (n, m/8), got {tuple(planes.shape)}")
    if not 0 <= keep <= min(bits, planes.shape[0]):
        raise ValueError(f"keep={keep} outside [0, {min(bits, planes.shape[0])}]")
    m8 = planes.shape[1]
    check("planes", planes, torch.uint8, (planes.shape[0], m8), planes.device)
    out = torch.empty((m8 * 8,), dtype=dtype, device=planes.device)
    if m8 == 0:
        return out
    _unpack((planes,), out, 1, 1, m8, m8, 0, 0, width, bits, keep, planes.device)
    return out


def pack_kv_into(k: torch.Tensor, v: torch.Tensor, k_planes: torch.Tensor,
                 v_planes: torch.Tensor, start) -> None:
    """Pack K and V rows, (A, c, Hkv, hd) bf16 each, into their plane
    caches, (bits, A, S, Hkv, hd/8) uint8 views, IN PLACE, in one launch.

    ``start`` is a Python int (a prefill chunk: rows [start, start + c)) or
    an (A,) integer tensor on the planes' device (decode, c == 1: row a at
    clamp(start[a], 0, S - 1), read by the kernel)."""
    for name, t in (("k", k), ("v", v), ("k_planes", k_planes), ("v_planes", v_planes)):
        _cuda(t, name)
    lay = plane_rows(k_planes, v_planes)
    bits, n_a, s = lay["planes"], lay["n_a"], lay["n_b"]
    if k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"k and v are (A, c, Hkv, hd), got {tuple(k.shape)}, {tuple(v.shape)}")
    a, c, hkv, hd = k.shape
    if (a, hkv, hd // 8) != tuple(k_planes.shape[i] for i in (1, 3, 4)) or hd % 8:
        raise ValueError(f"rows {tuple(k.shape)} do not fit planes {tuple(k_planes.shape)}")
    width = _width(torch.int16, bits)
    if torch.is_tensor(start):
        _cuda(start, "start")
        if start.shape != (a,) or c != 1:
            raise ValueError(f"a start per row, {tuple(start.shape)} for {a} rows, "
                             f"takes one token a row, got {c}")
        if start.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"start is an integer tensor, got {start.dtype}")
        start_t, start0 = start.to(torch.int32).contiguous(), 0
    else:
        start_t, start0 = None, int(start)
        if not 0 <= start0 <= start0 + c <= s:
            raise ValueError(f"rows [{start0}, {start0 + c}) outside the cache's {s}")
    if a * c == 0:
        return
    srcs = tuple(aligned(t.to(torch.bfloat16).view(torch.int16)) for t in (k, v))
    _pack(srcs, (k_planes, v_planes), a, c, lay["r8"], lay["ps"], lay["sa"], lay["sb"],
          width, bits, start_t, start0, s - 1, k.device)


def unpack_kv_pair(k_planes: torch.Tensor, v_planes: torch.Tensor, keep: int,
                   bits: int = 16) -> torch.Tensor:
    """K and V planes, (n >= keep, A, B, Hkv, hd/8) uint8 views -> (2, A, B,
    Hkv, hd) bf16 (K, then V) rebuilt from planes [0, keep) in one launch;
    the low planes read as zero."""
    _cuda(k_planes, "k_planes")
    lay = plane_rows(k_planes, v_planes)
    width = _width(torch.int16, bits)
    if not 0 <= keep <= min(bits, lay["planes"]):
        raise ValueError(f"keep={keep} outside [0, {min(bits, lay['planes'])}]")
    _, a, b, hkv, hd8 = k_planes.shape
    out = torch.empty((2, a, b, hkv, hd8 * 8), dtype=torch.bfloat16, device=k_planes.device)
    if out.numel() == 0:
        return out
    _unpack((k_planes, v_planes), out, a, b, lay["r8"], lay["ps"], lay["sa"], lay["sb"],
            width, bits, keep, k_planes.device)
    return out


def launch_empty() -> None:
    """Launch the library's empty kernel (the launch floor; not counted)."""
    raise_on(_library().bitplane_empty_launch(_stream(torch.cuda.current_device())),
             "bitplane_empty")
