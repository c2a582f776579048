"""Host-side compressed block store (paper Fig. 4/5: the controller's view of
memory).

Weights path:   flatten -> segment (32 K values => 4 KB/plane) -> bit-plane
                -> compress each plane block independently.
KV path:        cluster 16-token groups channel-major -> exponent delta ->
                bit-plane per group -> compress each plane block.

Every plane block is independently decodable, so a partial-precision fetch
(top-k planes) touches exactly the compressed bytes of those k planes — the
bandwidth-proportionality property the controller exploits (Fig. 5).  Base
exponents live in a separate (compressed) metadata stream, one byte per
channel per group, mirroring the paper's per-block header fields.
"""

# accounting-taint is suppressed line by line below: this module is the
# port's counterpart of repro/core/compressed_store.py, which the rule's allow-list exempts.

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.compression import default_codec, get_codec
from repro_torch.core import kv_clustering
from repro_torch.core.bitplane import (
    FloatSpec,
    SPECS,
    disaggregate_np,
    from_uint_np,
    reaggregate_np,
    to_uint_np,
)
from repro_torch.kernels.bitplane import ops as bitplane_ops


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    # zstd when the optional zstandard package is present, else built-in lz4
    codec: str = dataclasses.field(default_factory=default_codec)
    block_bytes: int = 4096  # compressed-block granularity (paper: 2/4 KB)
    layout: str = "bitplane"  # 'bitplane' (proposed) or 'raw' (baseline)
    kv_cluster: bool = True  # channel-wise grouping (Fig. 6 ①); False = paper's
    # Fig. 7 baseline (bit-plane over token-major KV, no clustering/delta)
    decorrelate: str = "delta"  # KV path: 'delta' | 'xor' | 'none'
    group: int = kv_clustering.DEFAULT_GROUP
    store_round_nearest: bool = True  # plane-aware rounding at store time

    @property
    def values_per_segment(self) -> int:
        # one plane of a segment occupies exactly block_bytes
        return self.block_bytes * 8


@dataclasses.dataclass
class CompressedTensor:
    shape: tuple
    spec_name: str
    config: StoreConfig
    kind: str  # 'weights' | 'kv'
    n_values: int  # un-padded element count
    # segments[s][p] = compressed bytes of plane p of segment s  (bitplane
    # layout), or segments[s][0] = compressed raw block (raw layout).
    segments: list
    base_blob: bytes = b""  # compressed exponent bases (KV path)
    base_shape: tuple = ()

    # ------------------------------------------------------------------ stats
    @property
    def spec(self) -> FloatSpec:
        return SPECS[self.spec_name]

    @property
    def logical_bytes(self) -> int:
        return self.n_values * self.spec.bits // 8

    #: kv-cluster layout stores segments PLANE-major: segments[p] = list of
    #: compressed chunks of plane p's cross-group concatenated stream
    #: (eq. 5); weights/raw layouts stay segment-major: segments[s][p].
    plane_major: bool = False
    #: element count the *caller* actually asked to store (KV tail pages are
    #: physically padded to PAGE_TOKENS by repeating the last token, but the
    #: pad rows are not logical data and must not inflate capacity/bandwidth
    #: savings); None = every stored value is logical (the common case)
    valid_values: int | None = None

    @property
    def valid_logical_bytes(self) -> int:
        """Pad-free logical bytes — what the compute fabric truly asked for.
        Savings ratios are quoted against this, never the padded size."""
        n = self.n_values if self.valid_values is None else self.valid_values
        return n * self.spec.bits // 8

    @property
    def stored_bytes(self) -> int:
        return sum(len(b) for seg in self.segments for b in seg) + len(self.base_blob)

    @property
    def ratio(self) -> float:
        return self.logical_bytes / max(1, self.stored_bytes)

    @property
    def savings(self) -> float:
        """Footprint reduction fraction (paper reports 1 - 1/ratio)."""
        return 1.0 - 1.0 / self.ratio if self.ratio > 0 else 0.0

    @property
    def exact_ratio(self) -> float:
        """Compression ratio over pad-free bytes (valid_logical / stored)."""
        return self.valid_logical_bytes / max(1, self.stored_bytes)

    @property
    def exact_savings(self) -> float:
        """THE shared savings definition: footprint reduction quoted over
        exact (pad-free) block bytes, ``1 - stored / valid_logical``.  Both
        offline Table III and the serving path's ``report()["weights"]``
        quote this, so a tensor padded to the lane stripe granularity can
        never inflate (or hide) the number.  Equals ``savings`` whenever
        nothing was padded."""
        vb = self.valid_logical_bytes
        return 1.0 - self.stored_bytes / vb if vb > 0 else 0.0

    def plane_stored_bytes(self) -> np.ndarray:
        """(bits,) compressed bytes per plane index (Fig. 8's x-axis)."""
        assert self.config.layout == "bitplane"
        bits = self.spec.bits
        out = np.zeros(bits, np.int64)
        if self.plane_major:
            for p, chunks in enumerate(self.segments):
                out[p] += sum(len(b) for b in chunks)
            return out
        for seg in self.segments:
            for p, blob in enumerate(seg):
                out[p] += len(blob)
        return out

    def plane_logical_bytes(self) -> np.ndarray:
        """(bits,) uncompressed bytes per plane (for per-plane ratios, Fig. 8)."""
        assert self.config.layout == "bitplane"
        if self.kind == "kv":
            g, c = self.base_shape
            per_seg = -(-(c * self.config.group) // 8) * 8
            padded_values = len(self.segments) * per_seg
        else:
            vps = self.config.values_per_segment
            full, tail = divmod(self.n_values, vps)
            padded_values = full * vps + (-(-tail // 8) * 8 if tail else 0)
        return np.full(self.spec.bits, padded_values // 8, np.int64)

    def fetch_bytes(self, keep_planes: int | None = None) -> int:
        """Bytes the controller reads for a top-k-plane fetch."""
        if self.config.layout != "bitplane" or keep_planes is None:
            return self.stored_bytes
        total = len(self.base_blob)
        if self.plane_major:
            for p, chunks in enumerate(self.segments):
                if p < keep_planes:
                    total += sum(len(b) for b in chunks)
            return total
        for seg in self.segments:
            total += sum(len(b) for b in seg[:keep_planes])
        return total


# ---------------------------------------------------------------------------
# Weights path
# ---------------------------------------------------------------------------


def _pad_to(u: np.ndarray, multiple: int) -> np.ndarray:
    rem = (-len(u)) % multiple
    if rem:
        u = np.concatenate([u, np.zeros(rem, u.dtype)])
    return u


def compress_weights(
    arr: np.ndarray,
    spec: FloatSpec,
    cfg: StoreConfig = StoreConfig(),
    valid_values: int | None = None,
) -> CompressedTensor:
    """``valid_values``: element count the caller actually asked to store.
    The weight store pads each per-tensor block to the lane engine's stripe
    granularity (a whole ``values_per_segment``); the pad is physically
    stored but is not logical data, so savings/bandwidth are quoted against
    ``valid_logical_bytes`` (see ``CompressedTensor.exact_savings``)."""
    codec = get_codec(cfg.codec)
    u = to_uint_np(arr, spec)
    n_values = u.shape[0]
    segments = []
    if cfg.layout == "raw":
        raw = u.tobytes()
        for off in range(0, len(raw), cfg.block_bytes):
            segments.append([codec.compress(raw[off : off + cfg.block_bytes])])  # repro-lint: disable=accounting-taint
    else:
        vps = cfg.values_per_segment
        u = _pad_to(u, 8)
        for off in range(0, len(u), vps):
            seg = _pad_to(u[off : off + vps], 8)
            planes = disaggregate_np(seg, spec.bits)
            segments.append([codec.compress(planes[p].tobytes()) for p in range(spec.bits)])  # repro-lint: disable=accounting-taint
    return CompressedTensor(
        shape=tuple(arr.shape),
        spec_name=spec.name,
        config=cfg,
        kind="weights",
        n_values=n_values,
        segments=segments,
        valid_values=valid_values,
    )


def decompress_weights(
    ct: CompressedTensor, keep_planes: int | None = None
) -> np.ndarray:
    codec = get_codec(ct.config.codec)
    spec = ct.spec
    if ct.config.layout == "raw":
        raw = b"".join(codec.decompress(seg[0]) for seg in ct.segments)  # repro-lint: disable=accounting-taint
        u = np.frombuffer(raw, spec.uint_np)[: ct.n_values]
        return from_uint_np(u, spec, ct.shape)
    parts = []
    for seg in ct.segments:
        keep = spec.bits if keep_planes is None else keep_planes
        plane_rows = [
            np.frombuffer(codec.decompress(seg[p]), np.uint8) for p in range(keep)  # repro-lint: disable=accounting-taint
        ]
        planes = np.stack(plane_rows)
        parts.append(reaggregate_np(
            np.concatenate([planes, np.zeros((spec.bits - keep, planes.shape[1]), np.uint8)])
            if keep < spec.bits else planes,
            spec.bits,
            keep,
        ))
    u = np.concatenate(parts)[: ct.n_values]
    return from_uint_np(u, spec, ct.shape)


# ---------------------------------------------------------------------------
# KV path
# ---------------------------------------------------------------------------
#
# The transform (cluster -> exponent delta -> bit-plane pack, and back) runs
# on torch tensors, on the device the KV lies on: the hand-written kernels
# on a CUDA device, their plain versions on the CPU.  Only the codec runs
# on the host.  Raw bits travel in the bit-plane containers (uint8, int16,
# int32), as NumPy's uint views (uint8, uint16, uint32) on the host.

_HOST_VIEWS = {torch.uint8: np.uint8, torch.int16: np.uint16, torch.int32: np.uint32}
_SIGNED_VIEWS = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}


def bits_tensor(kv, spec: FloatSpec) -> torch.Tensor:
    """Raw bits of ``kv`` in the spec's container: a NumPy array (values or
    their uint view) becomes a CPU tensor; a tensor keeps its device."""
    container = bitplane_ops.container(spec)
    if isinstance(kv, np.ndarray):
        u = to_uint_np(kv, spec).reshape(kv.shape)
        return torch.from_numpy(u.view(_SIGNED_VIEWS.get(u.dtype, u.dtype)))
    return kv if kv.dtype == container else kv.view(container)


def _host_bits(u: torch.Tensor) -> np.ndarray:
    """Raw-bit tensor (any device) -> NumPy uint view on the host."""
    return u.cpu().numpy().view(_HOST_VIEWS[u.dtype])


def _to_host(*tensors: torch.Tensor) -> list:
    """uint8 tensors of one device -> NumPy arrays, in one device->host copy."""
    flat = torch.cat([t.reshape(-1) for t in tensors]).cpu().numpy()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off : off + t.numel()].reshape(tuple(t.shape)))
        off += t.numel()
    return out


def _to_device(device, *arrays: np.ndarray) -> list:
    """uint8 NumPy arrays -> tensors on ``device``, in one host->device copy."""
    flat = torch.from_numpy(np.concatenate([a.reshape(-1) for a in arrays])).to(device)
    out, off = [], 0
    for a in arrays:
        out.append(flat[off : off + a.size].reshape(a.shape))
        off += a.size
    return out


def _group_bytes(channels: int, group: int) -> int:
    """Bytes of one plane of one group: its channels * group values, padded
    to whole octets (the reference pads each group's flat block to 8)."""
    return -(-(channels * group) // 8)


@dataclasses.dataclass(frozen=True)
class EncodedKV:
    """A KV tensor after cluster -> exponent delta -> bit-plane pack: what
    the store compresses.  ``planes[p]`` is plane p's stream across the
    channel-major groups (eq. 5), group g at columns ``[g * gb, (g + 1) * gb)``
    with ``gb = ceil(channels * group / 8)``; ``bases`` holds one exponent
    base per channel per group.  Tensors on the device after
    :func:`encode_kv`, NumPy after :meth:`to_host`."""

    planes: object  # (bits, n_groups * gb) uint8
    bases: object  # (n_groups, channels) uint8
    shape: tuple  # (tokens, channels); encode_kv's excludes the tail group's padding
    group: int

    def to_host(self) -> "EncodedKV":
        """Planes and bases in NumPy, in one device->host copy."""
        planes, bases = _to_host(self.planes, self.bases)
        return dataclasses.replace(self, planes=planes, bases=bases)

    def split(self, n: int) -> list:
        """``n`` equal parts along the groups (pages of a padding-free
        encode), each an :class:`EncodedKV` of its own."""
        n_groups, channels = self.bases.shape
        tokens = self.shape[0]
        if tokens != n_groups * self.group or n_groups % n:
            raise ValueError(f"{n_groups} groups of {tokens} tokens do not split into {n}")
        per = n_groups // n
        cols = per * _group_bytes(channels, self.group)
        return [EncodedKV(self.planes[:, i * cols : (i + 1) * cols],
                          self.bases[i * per : (i + 1) * per],
                          (tokens // n, channels), self.group)
                for i in range(n)]

    def columns(self, c0: int, c1: int) -> "EncodedKV":
        """The encoding of channels [c0, c1) alone, taken from this one: the
        transform is per channel and its groups are channel-major, so each
        group's plane bytes of those channels are one contiguous run.  Byte
        for byte what :func:`encode_kv` of the column slice gives (a
        sharded tier's part of a page).  Needs a single group and channel
        runs that start on whole bytes."""
        n_groups, channels = self.bases.shape
        if n_groups != 1 or (c0 * self.group) % 8 or (c1 * self.group) % 8:
            raise ValueError(f"columns [{c0}, {c1}) of {n_groups} groups of "
                             f"{self.group} tokens are not whole plane bytes")
        if not 0 <= c0 < c1 <= channels:
            raise ValueError(f"columns [{c0}, {c1}) outside {channels} channels")
        b0, b1 = c0 * self.group // 8, c1 * self.group // 8
        return EncodedKV(self.planes[:, b0:b1], self.bases[:, c0:c1],
                         (self.shape[0], c1 - c0), self.group)


def encode_kv(kv, spec: FloatSpec, cfg: StoreConfig = StoreConfig()) -> EncodedKV:
    """The KV transform of the bit-plane, clustered layout, on the device
    ``kv`` lies on (a NumPy input runs on the CPU).

    ``kv``: raw bits or values, (tokens, channels), or (..., tokens,
    channels) whose tokens are whole groups of ``cfg.group`` (a page's
    (pages, page_tokens, channels)); any strides but dense channels, read
    in place.  The tail group of a 2-D input is padded by repeating the
    last token.  Cluster and exponent delta over all groups at once (one
    launch), groups in row-major order of the leading dims, then one
    bit-plane pack: each group's channels * group values are padded to
    whole octets, so group g of plane p is columns ``[g * gb, (g + 1) *
    gb)`` of the one pack, byte for byte the stream the reference
    concatenates group by group."""
    if cfg.layout != "bitplane" or not cfg.kv_cluster:
        raise ValueError("encode_kv is the transform of the bit-plane clustered "
                         f"layout; this store has layout={cfg.layout!r}, "
                         f"kv_cluster={cfg.kv_cluster}")
    u = bits_tensor(kv, spec)
    if u.dim() < 2:
        raise ValueError(f"KV is (..., tokens, channels), got {tuple(u.shape)}")
    if u.dim() > 2 and u.shape[-2] % cfg.group:
        raise ValueError(f"pages of {u.shape[-2]} tokens are no whole groups of {cfg.group}")
    encoded = _encode_groups(u, spec, cfg)
    if u.dim() == 2:  # the tail group's padding excluded
        return dataclasses.replace(encoded, shape=tuple(u.shape))
    return encoded


def _encode_groups(u: torch.Tensor, spec: FloatSpec, cfg: StoreConfig) -> EncodedKV:
    """:func:`encode_kv` of raw bits (..., tokens, channels) whose tokens
    need not be whole groups: each leading index's ragged tail group is
    padded by repeating its last token (in the kernel, on a CUDA tensor),
    and ``shape`` counts the padded groups' tokens."""
    c = u.shape[-1]
    encoded, base = kv_clustering.cluster_and_encode(u, spec, cfg.group,
                                                     mode=cfg.decorrelate)
    base = base.reshape(-1, c)
    n_groups = base.shape[0]
    flat = encoded.reshape(n_groups, c * cfg.group)
    gb = _group_bytes(c, cfg.group)
    if gb * 8 != c * cfg.group:
        flat = torch.nn.functional.pad(flat, (0, gb * 8 - c * cfg.group))
    planes = bitplane_ops.pack_raw(flat.reshape(-1), spec.bits)
    return EncodedKV(planes, base, (n_groups * cfg.group, c), cfg.group)


def compress_encoded(encoded: EncodedKV, spec: FloatSpec,
                     cfg: StoreConfig = StoreConfig()) -> CompressedTensor:
    """Host-only: the codec over an encoded KV tensor's plane streams, in
    ``block_bytes`` chunks, and over its bases.  Takes NumPy planes and
    bases (:meth:`EncodedKV.to_host`)."""
    if encoded.group != cfg.group:
        raise ValueError(f"encoded in groups of {encoded.group}, the store groups {cfg.group}")
    codec = get_codec(cfg.codec)
    planes, base = encoded.planes, encoded.bases
    segments = []
    for p in range(spec.bits):
        stream = planes[p].tobytes()
        segments.append([
            codec.compress(stream[off : off + cfg.block_bytes])  # repro-lint: disable=accounting-taint
            for off in range(0, len(stream), cfg.block_bytes)
        ])
    base_blob = codec.compress(base.tobytes())  # repro-lint: disable=accounting-taint
    t, c = encoded.shape
    return CompressedTensor(
        shape=(t, c),
        spec_name=spec.name,
        config=cfg,
        kind="kv",
        n_values=t * c,
        segments=segments,
        base_blob=base_blob,
        base_shape=tuple(base.shape),
        plane_major=True,
    )


def compress_kv(kv, spec: FloatSpec, cfg: StoreConfig = StoreConfig()) -> CompressedTensor:
    """kv: (tokens, channels), a NumPy array in the spec's value dtype (bf16
    as its uint16 bit patterns) or a tensor of raw bits or values.

    Tokens are padded to a full group by repeating the last token (padding is
    dropped on decode; repetition keeps the pad from polluting delta stats).
    The bit-plane clustered layout transforms on the tensor's device (a
    NumPy input on the CPU) and copies the planes to the host once for the
    codec.  The raw layout and the ``kv_cluster=False`` baseline run on the
    host (a tensor input is copied there first).
    """
    if cfg.layout == "bitplane" and cfg.kv_cluster:
        return compress_encoded(encode_kv(kv, spec, cfg).to_host(), spec, cfg)
    if isinstance(kv, torch.Tensor):
        kv = _host_bits(bits_tensor(kv, spec))
    codec = get_codec(cfg.codec)
    t, c = kv.shape
    if cfg.layout == "raw":
        raw = to_uint_np(kv, spec).tobytes()
        segments = [
            [codec.compress(raw[off : off + cfg.block_bytes])]  # repro-lint: disable=accounting-taint
            for off in range(0, len(raw), cfg.block_bytes)
        ]
        return CompressedTensor(
            shape=(t, c), spec_name=spec.name, config=cfg, kind="kv",
            n_values=t * c, segments=segments,
        )
    # Fig. 7 baseline: bit-plane the token-major layout, weight-style.
    ct = compress_weights(kv, spec, cfg)
    return dataclasses.replace(ct, shape=(t, c), kind="kv")


def encode_pages(kv: torch.Tensor, spec: FloatSpec, cfg: StoreConfig,
                 page_tokens: int) -> list:
    """(..., tokens, channels) raw bits (any strides, channels dense) -> one
    page object per page of ``page_tokens`` tokens, in row-major order of
    (..., page), the tail page padded by repeating the last token, for the
    store's ``put_page``: an :class:`EncodedKV` on the host for the
    bit-plane clustered layout (one encode over all pages, on the view
    itself, and one device->host copy), the page's raw bits in NumPy for
    the host layouts.  The encode pads whole groups; anything else pads
    the view to whole pages first."""
    if kv.dim() == 2:
        kv = kv[None]
    clustered = cfg.layout == "bitplane" and cfg.kv_cluster
    if not (clustered and page_tokens == cfg.group):
        kv = kv_clustering.pad_tail(kv, page_tokens)
    n = math.prod(kv.shape[:-2]) * -(-kv.shape[-2] // page_tokens)
    if clustered:
        return _encode_groups(kv, spec, cfg).to_host().split(n)
    return list(_host_bits(kv.reshape(n, page_tokens, kv.shape[-1])))


def _decompress_planes(codec, ct: CompressedTensor, keep: int) -> tuple:
    """Host: planes (bits, stream bytes) with planes [keep, bits) zero, and
    bases (n_groups, channels), of one clustered KV tensor."""
    n_groups, c = ct.base_shape
    base = np.frombuffer(codec.decompress(ct.base_blob), np.uint8).reshape(ct.base_shape)  # repro-lint: disable=accounting-taint
    stream_len = n_groups * _group_bytes(c, ct.config.group)
    planes = np.zeros((ct.spec.bits, stream_len), np.uint8)
    for p in range(keep):
        stream = b"".join(codec.decompress(b) for b in ct.segments[p])  # repro-lint: disable=accounting-taint
        planes[p] = np.frombuffer(stream, np.uint8)[:stream_len]
    return planes, base


def decompress_kv_pages(cts: list, keeps: list, device=None) -> list:
    """Decode clustered KV tensors of one channel count together: each
    tensor's kept plane streams are decompressed on the host, its other
    planes zero-filled (so each may keep its own planes), then one
    host->device copy, one bit-plane unpack and one exponent-delta decode
    over all of them.  ``device=None`` decodes on the CPU and returns NumPy
    arrays (:func:`decompress_kv`'s types); otherwise raw-bit tensors in the
    spec's container on ``device``.  The raw and unclustered layouts decode
    one by one on the host."""
    if not all(ct.config.layout == "bitplane" and ct.config.kv_cluster for ct in cts):
        out = [_decompress_kv_host(ct, keep) for ct, keep in zip(cts, keeps)]
        return out if device is None else [
            bits_tensor(np.ascontiguousarray(a), ct.spec).to(device)
            for a, ct in zip(out, cts)]
    ct0 = cts[0]
    spec, cfg = ct0.spec, ct0.config
    codec = get_codec(cfg.codec)
    keeps = [spec.bits if k is None else k for k in keeps]
    host = [_decompress_planes(codec, ct, k) for ct, k in zip(cts, keeps)]
    planes = np.concatenate([p for p, _ in host], axis=1)
    bases = np.concatenate([b for _, b in host])
    planes, bases = _to_device(torch.device("cpu") if device is None else device,
                               planes, bases)
    n_groups, c = bases.shape
    gb = _group_bytes(c, cfg.group)
    u = bitplane_ops.unpack_raw(planes, spec.bits, max(keeps),
                                 bitplane_ops.container(spec))
    encoded = u.reshape(n_groups, gb * 8)[:, : c * cfg.group].reshape(n_groups, c, cfg.group)
    rows = kv_clustering.decode_and_uncluster(encoded, bases, spec, mode=cfg.decorrelate)
    out, off = [], 0
    for ct in cts:
        t = ct.shape[0]
        part = rows[off : off + t]
        off += ct.base_shape[0] * cfg.group
        out.append(part.contiguous() if device is not None
                   else from_uint_np(_host_bits(part).reshape(-1), spec, (t, c)))
    return out


def decompress_kv(ct: CompressedTensor, keep_planes: int | None = None,
                  device=None):
    """One KV tensor at the top ``keep_planes`` planes: NumPy in the spec's
    value dtype (bf16 as uint16) with ``device=None``, decoded on the CPU;
    otherwise raw bits on ``device`` (see :func:`decompress_kv_pages`)."""
    return decompress_kv_pages([ct], [keep_planes], device)[0]


def _decompress_kv_host(ct: CompressedTensor, keep_planes: int | None) -> np.ndarray:
    """The raw layout and the unclustered baseline, on the host."""
    codec = get_codec(ct.config.codec)
    spec = ct.spec
    t, c = ct.shape
    if ct.config.layout == "raw":
        raw = b"".join(codec.decompress(seg[0]) for seg in ct.segments)  # repro-lint: disable=accounting-taint
        u = np.frombuffer(raw, spec.uint_np)[: t * c]
        return from_uint_np(u, spec, (t, c))
    wt = dataclasses.replace(ct, kind="weights")
    return decompress_weights(wt, keep_planes).reshape(t, c)


# ---------------------------------------------------------------------------
# Convenience: ratio measurement used throughout the benchmarks
# ---------------------------------------------------------------------------


def measure_ratio(
    arr: np.ndarray,
    spec: FloatSpec,
    cfg: StoreConfig = StoreConfig(),
    kind: str = "weights",
) -> float:
    if kind == "kv":
        return compress_kv(arr, spec, cfg).ratio
    return compress_weights(arr, spec, cfg).ratio
