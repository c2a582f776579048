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

import numpy as np

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


def compress_kv(
    kv: np.ndarray, spec: FloatSpec, cfg: StoreConfig = StoreConfig()
) -> CompressedTensor:
    """kv: (tokens, channels) in the spec's value dtype.

    Tokens are padded to a full group by repeating the last token (padding is
    dropped on decode; repetition keeps the pad from polluting delta stats).
    """
    codec = get_codec(cfg.codec)
    t, c = kv.shape
    u2d = to_uint_np(kv, spec).reshape(t, c)
    pad = (-t) % cfg.group
    if pad:
        u2d = np.concatenate([u2d, np.repeat(u2d[-1:], pad, axis=0)])
    if cfg.layout == "raw":
        raw = u2d[:t].tobytes()
        segments = [
            [codec.compress(raw[off : off + cfg.block_bytes])]  # repro-lint: disable=accounting-taint
            for off in range(0, len(raw), cfg.block_bytes)
        ]
        return CompressedTensor(
            shape=(t, c), spec_name=spec.name, config=cfg, kind="kv",
            n_values=t * c, segments=segments,
        )
    if not cfg.kv_cluster:
        # Fig. 7 baseline: bit-plane the token-major layout, weight-style.
        ct = compress_weights(kv, spec, cfg)
        return dataclasses.replace(ct, shape=(t, c), kind="kv")
    encoded, base = kv_clustering.cluster_and_encode_np(
        u2d, spec, cfg.group, mode=cfg.decorrelate
    )  # (G, C, group), (G, C)
    # Eq. 5: concatenate each bit-plane ACROSS channel-major groups into one
    # stream, then compress in block_bytes chunks (the paper's 4 KB blocks).
    # Per-group blobs would be tiny for small-channel models and codec
    # overhead would dominate.
    n_groups = encoded.shape[0]
    # Disaggregate per group, then concat plane streams across groups.
    plane_streams = [[] for _ in range(spec.bits)]
    for g in range(n_groups):
        seg = _pad_to(encoded[g].reshape(-1), 8)
        planes = disaggregate_np(seg, spec.bits)
        for p in range(spec.bits):
            plane_streams[p].append(planes[p].tobytes())
    segments = []
    for p in range(spec.bits):
        stream = b"".join(plane_streams[p])
        segments.append([
            codec.compress(stream[off : off + cfg.block_bytes])  # repro-lint: disable=accounting-taint
            for off in range(0, len(stream), cfg.block_bytes)
        ])
    base_blob = codec.compress(base.tobytes())  # repro-lint: disable=accounting-taint
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


def decompress_kv(ct: CompressedTensor, keep_planes: int | None = None) -> np.ndarray:
    codec = get_codec(ct.config.codec)
    spec = ct.spec
    t, c = ct.shape
    if ct.config.layout == "raw":
        raw = b"".join(codec.decompress(seg[0]) for seg in ct.segments)  # repro-lint: disable=accounting-taint
        u = np.frombuffer(raw, spec.uint_np)[: t * c]
        return from_uint_np(u, spec, (t, c))
    if not ct.config.kv_cluster:
        wt = dataclasses.replace(ct, kind="weights")
        return decompress_weights(wt, keep_planes).reshape(t, c)
    group = ct.config.group
    base = np.frombuffer(codec.decompress(ct.base_blob), np.uint8).reshape(ct.base_shape)  # repro-lint: disable=accounting-taint
    n_groups = ct.base_shape[0]
    keep = spec.bits if keep_planes is None else keep_planes
    vals_per_group = c * group
    padded_vpg = -(-vals_per_group // 8) * 8
    stream_len = n_groups * padded_vpg // 8  # bytes per full plane stream
    plane_rows = []
    for p in range(keep):
        stream = b"".join(codec.decompress(b) for b in ct.segments[p])  # repro-lint: disable=accounting-taint
        plane_rows.append(np.frombuffer(stream, np.uint8)[:stream_len])
    planes = np.stack(plane_rows)
    if keep < spec.bits:
        planes = np.concatenate(
            [planes, np.zeros((spec.bits - keep, stream_len), np.uint8)]
        )
    # un-concatenate per group, reaggregate each
    encoded = np.zeros((n_groups, c, group), spec.uint_np)
    pbytes = padded_vpg // 8
    for g in range(n_groups):
        u = reaggregate_np(planes[:, g * pbytes : (g + 1) * pbytes], spec.bits, keep)
        encoded[g] = u[:vals_per_group].reshape(c, group)
    u2d = kv_clustering.decode_and_uncluster_np(
        encoded, base, spec, mode=ct.config.decorrelate
    )
    return from_uint_np(u2d[:t].reshape(-1), spec, (t, c))


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
