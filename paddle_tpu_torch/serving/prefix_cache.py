"""Refcounted cross-request KV prefix cache over the page allocator (port
of ``paddle_tpu/serving/prefix_cache.py``).

A FULL page of KV is a function of the model weights, the token block
it covers and every token before it. The cache keys such pages by a
blake2b-16 hash of their token block chained through the prefix, so two
requests whose prompts share a prefix share the physical pages, and the
engine prefills only the suffix (``models/gpt.py`` ``prefill_chained``).
The keys are byte-equal to the JAX package's.

Invariants:

- Only FULL pages strictly inside the prompt are shared: a prompt of
  length L shares ``(L - 1) // page_size`` blocks, so at least one
  suffix token is always prefilled (its logits give the first token).
- Shared pages are never written: a request that diverges past the
  shared prefix writes its own private pages, and decode appends land
  past the prompt.
- Entries are refcounted (one ref per active request per chain entry,
  plus one per child entry); LRU eviction takes only entries with
  refcount 0 and no children, so a chain is torn down leaf-first and
  never under an active request.
- Cached pages belong to ``("prefix", key)`` owners in the
  :class:`PageAllocator` books, or ``("dedup", key)`` once a second
  request's identical page folded onto them (``dedup``); ``clear()``
  returns everything and ``check_consistent`` audits the books against
  the allocator.

Spill tiers: with ``spill_bytes`` (host RAM) and/or ``spill_dir``
(disk), an evicted refcount-0 page is first copied to the host as a
content blob under the same chained key, and a later match that misses
device pages restores it into fresh pages (one batched splice) instead
of prefilling the prefix again. A tier miss mid-chain shortens the
restored prefix and the chained prefill covers the rest, so restore,
partial restore and miss give the same greedy tokens. Each tier is
byte-budgeted LRU; the host tier demotes into the disk tier. Blobs carry
a crc32: a corrupt blob is a typed, counted miss, never wrong tokens
(the ``cache.spill`` fault site).

Blob codecs: ``raw`` (the pool's bytes), ``int8`` and ``int4``
(``quantization/quant.py``); a blob names its pool layout and format, so
``unpack_page_blob`` always decodes to the pool's layout.

Host-side and single-threaded, as in the JAX package: every method runs
on the engine thread. The cache is bounded by pool pressure alone (the
JAX constructor's ``max_pages`` soft cap has no caller in either
package and is not ported). The fleet methods (``expand_heads``,
``export_blobs`` / ``import_blobs``, which serve the server's
``fetch_pages`` op, and ``advertised_keys``) carry pages between
replicas, as in the JAX package.

Weight generations: ``generation`` salts every chain root, so pages
computed by other weights miss by construction; ``set_generation``
(the engine's ``swap_weights``) clears the cache and moves it to a new
generation.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import os
import struct
import time
import zlib
from collections import OrderedDict
from typing import (Any, Callable, Dict, Hashable, List, Optional,
                    Sequence, Tuple)

import numpy as np

from ..distributed.fault_inject import InjectedFault, fault_point

__all__ = ["PrefixCache", "HostSpillTier", "DiskSpillTier",
           "SpillCorrupt", "pack_page_blob", "unpack_page_blob",
           "blob_logical_bytes", "BLOB_FORMATS", "BF16"]

# numpy has no bfloat16: a bf16 block travels as its 2-byte patterns in
# this one-field dtype, whose name says what they are. A blob names it
# "bfloat16", as the JAX package's (ml_dtypes) blobs do, and holds the
# same bytes.
BF16 = np.dtype([("bfloat16", "<u2")])


def _dtype_name(dt: np.dtype) -> str:
    return "bfloat16" if dt == BF16 else str(dt)


def _np_dtype(name: str) -> np.dtype:
    return BF16 if name == "bfloat16" else np.dtype(name)


def _to_f32(block: np.ndarray) -> np.ndarray:
    if block.dtype == BF16:  # exact: bf16 is f32's upper half
        return (np.ascontiguousarray(block).view(np.uint16)
                .astype(np.uint32) << 16).view(np.float32)
    return np.asarray(block, np.float32)


def _from_f32(x: np.ndarray, dt: np.dtype) -> np.ndarray:
    """``x.astype(dt)``; to bf16 it rounds to nearest even, as ml_dtypes'
    cast does (NaN stays NaN, quieted)."""
    if dt != BF16:
        return x.astype(dt)
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(
        np.uint64)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) >> 16
    bits = np.where(np.isnan(x), (u >> 16) | 0x40, rounded)
    return bits.astype(np.uint16).view(BF16)


def _block_hash(parent: Optional[bytes], block: np.ndarray,
                generation: int = 0) -> bytes:
    """Chained block key. ``generation`` salts the chain ROOT only:
    child keys inherit it through the parent digest. Generation 0 adds
    no salt."""
    h = hashlib.blake2b(digest_size=16)
    if parent is not None:
        h.update(parent)
    elif generation:
        h.update(b"PTGEN" + struct.pack("<Q", int(generation)))
    h.update(np.ascontiguousarray(block, np.int32).tobytes())
    return h.digest()


# -- spill blobs ------------------------------------------------------------

_BLOB_MAGIC = b"PTKV"

# "raw" writes a 4-field meta; "int8"/"int4" a 5-field meta whose first
# four fields still name the POOL layout
BLOB_FORMATS = ("raw", "int8", "int4")


class SpillCorrupt(RuntimeError):
    """A spill blob failed its crc32 / structure check. Callers treat
    the blob as a miss: corrupt KV is never spliced into the pool."""


def _frame_blob(meta: bytes, payload: bytes) -> bytes:
    return (_BLOB_MAGIC + struct.pack("<HI", len(meta), len(payload))
            + meta + struct.pack("<I", zlib.crc32(payload)) + payload)


def pack_page_blob(layers: Sequence[Tuple[np.ndarray, np.ndarray,
                                          Optional[np.ndarray],
                                          Optional[np.ndarray]]],
                   fmt: str = "raw",
                   stats: Optional[Dict[str, Any]] = None) -> bytes:
    """Serialize one page's per-layer (k, v, k_scale, v_scale) blocks
    (scales None for float pages; bf16 blocks as :data:`BF16`) into a
    self-describing blob: magic, layout header, crc32 of the payload,
    the array bytes.

    ``fmt``: ``raw`` (the pool's bytes), ``int8`` (int8 values + f32
    per-(token, head) scales: a passthrough when the pool is int8, the
    ``quantize_kv_np`` math when it is float) or ``int4`` (packed
    nibbles + f32 scales). Lossy encodes add their error to ``stats``
    ({"lossy_pages", "max_abs_err"})."""
    if fmt not in BLOB_FORMATS:
        raise ValueError(f"blob format must be one of {BLOB_FORMATS}; "
                         f"got {fmt!r}")
    first_k = np.ascontiguousarray(layers[0][0])
    int8_pool = layers[0][2] is not None
    nl = len(layers)
    shape = first_k.shape                  # [page, H, D]
    dtype = _dtype_name(first_k.dtype)
    scale_dtype = (str(np.ascontiguousarray(layers[0][2]).dtype)
                   if int8_pool else "")
    if fmt == "int8" and int8_pool:
        fmt = "raw"  # int8 pages ARE the int8 encoding
    if fmt == "raw":
        payload = bytearray()
        for k, v, ks, vs in layers:
            payload += np.ascontiguousarray(k).tobytes()
            payload += np.ascontiguousarray(v).tobytes()
            if int8_pool:
                payload += np.ascontiguousarray(ks).tobytes()
                payload += np.ascontiguousarray(vs).tobytes()
        meta = (f"{nl};{','.join(map(str, shape))};"
                f"{dtype};{scale_dtype}").encode("ascii")
        return _frame_blob(meta, bytes(payload))
    from ..quantization.quant import (dequantize_kv_int4_np,
                                      dequantize_kv_np,
                                      quantize_kv_int4_np, quantize_kv_np)
    quant = quantize_kv_np if fmt == "int8" else quantize_kv_int4_np
    max_err = 0.0
    payload = bytearray()
    for k, v, ks, vs in layers:
        for block, sc in ((k, ks), (v, vs)):
            x = _to_f32(block) if not int8_pool else \
                dequantize_kv_np(block, sc)
            q, s = quant(x)
            if fmt == "int8":
                deq = dequantize_kv_np(q, s)
            else:
                deq = dequantize_kv_int4_np(q, s, x.shape[-1])
            max_err = max(max_err, float(np.max(np.abs(x - deq)))
                          if x.size else 0.0)
            payload += np.ascontiguousarray(q).tobytes()
            payload += np.ascontiguousarray(s).tobytes()
    if stats is not None:
        stats["lossy_pages"] = stats.get("lossy_pages", 0) + 1
        stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0),
                                   max_err)
    meta = (f"{nl};{','.join(map(str, shape))};"
            f"{dtype};{scale_dtype};{fmt}").encode("ascii")
    return _frame_blob(meta, bytes(payload))


def _parse_blob_header(blob: bytes):
    """(meta fields, payload) of a framed blob, crc-checked."""
    if blob[:4] != _BLOB_MAGIC:
        raise SpillCorrupt("bad spill-blob magic")
    meta_len, payload_len = struct.unpack("<HI", blob[4:10])
    meta = blob[10:10 + meta_len].decode("ascii")
    off = 10 + meta_len
    crc, = struct.unpack("<I", blob[off:off + 4])
    payload = blob[off + 4:]
    if len(payload) != payload_len:
        raise SpillCorrupt("truncated spill blob")
    if zlib.crc32(payload) != crc:
        raise SpillCorrupt("spill blob crc32 mismatch")
    fields = meta.split(";")
    if len(fields) == 4:
        fields.append("raw")
    if len(fields) != 5 or fields[4] not in BLOB_FORMATS:
        raise SpillCorrupt(f"bad spill-blob meta {meta!r}")
    return fields, payload


def blob_logical_bytes(blob: bytes) -> int:
    """Pool-layout bytes one blob decodes to, whatever its encoding (the
    physical size for a blob it cannot parse)."""
    try:
        (nl_s, shape_s, dtype_s, scale_dtype_s, _fmt), _payload = \
            _parse_blob_header(blob)
        nl = int(nl_s)
        shape = tuple(int(x) for x in shape_s.split(","))
        out = nl * 2 * int(np.prod(shape)) * _np_dtype(dtype_s).itemsize
        if scale_dtype_s:
            out += nl * 2 * int(np.prod(shape[:2])) * \
                np.dtype(scale_dtype_s).itemsize
        return out
    except Exception:
        return len(blob)


def unpack_page_blob(blob: bytes
                     ) -> List[Tuple[np.ndarray, np.ndarray,
                                     Optional[np.ndarray],
                                     Optional[np.ndarray]]]:
    """Inverse of :func:`pack_page_blob`, decoding every format to the
    pool layout the header names: raw is a copy; int8 to float is ``q *
    s / 127``; int4 unpacks the nibbles, then ``q * s / 7``; a coded blob
    of an int8 pool re-quantizes the decoded floats with
    ``quantize_kv_np``. Raises :class:`SpillCorrupt` on any structural
    or crc32 mismatch."""
    try:
        (nl_s, shape_s, dtype_s, scale_dtype_s, fmt), payload = \
            _parse_blob_header(blob)
        nl = int(nl_s)
        shape = tuple(int(x) for x in shape_s.split(","))
        dt = _np_dtype(dtype_s)
        int8_pool = bool(scale_dtype_s)
        sdt = np.dtype(scale_dtype_s) if int8_pool else None
        out: List[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray],
                        Optional[np.ndarray]]] = []
        pos = 0
        if fmt == "raw":
            n_kv = int(np.prod(shape))
            n_sc = int(np.prod(shape[:2]))
            kv_bytes = n_kv * dt.itemsize
            sc_bytes = n_sc * sdt.itemsize if int8_pool else 0
            for _ in range(nl):
                k = np.frombuffer(payload, dt, count=n_kv,
                                  offset=pos).reshape(shape)
                pos += kv_bytes
                v = np.frombuffer(payload, dt, count=n_kv,
                                  offset=pos).reshape(shape)
                pos += kv_bytes
                ks = vs = None
                if int8_pool:
                    ks = np.frombuffer(payload, sdt, count=n_sc,
                                       offset=pos).reshape(shape[:2])
                    pos += sc_bytes
                    vs = np.frombuffer(payload, sdt, count=n_sc,
                                       offset=pos).reshape(shape[:2])
                    pos += sc_bytes
                out.append((k, v, ks, vs))
            if pos != len(payload):
                raise SpillCorrupt("spill blob payload size mismatch")
            return out
        from ..quantization.quant import (dequantize_kv_int4_np,
                                          dequantize_kv_np, quantize_kv_np)
        page, heads, head_dim = shape
        if fmt == "int8":
            q_shape, q_dt = shape, np.dtype(np.int8)
        else:
            q_shape = (page, heads, (head_dim + 1) // 2)
            q_dt = np.dtype(np.uint8)
        s_shape, s_dt = (page, heads), np.dtype(np.float32)
        q_bytes = int(np.prod(q_shape)) * q_dt.itemsize
        s_bytes = int(np.prod(s_shape)) * s_dt.itemsize
        for _ in range(nl):
            decoded = []
            for _which in ("k", "v"):
                q = np.frombuffer(payload, q_dt,
                                  count=int(np.prod(q_shape)),
                                  offset=pos).reshape(q_shape)
                pos += q_bytes
                s = np.frombuffer(payload, s_dt,
                                  count=int(np.prod(s_shape)),
                                  offset=pos).reshape(s_shape)
                pos += s_bytes
                if fmt == "int8":
                    x = dequantize_kv_np(q, s)
                else:
                    x = dequantize_kv_int4_np(q, s, head_dim)
                if int8_pool:
                    qq, ss = quantize_kv_np(x)
                    decoded.append((qq, ss.astype(sdt)))
                else:
                    decoded.append((_from_f32(x, dt), None))
            (k, ks), (v, vs) = decoded
            out.append((k, v, ks, vs))
        if pos != len(payload):
            raise SpillCorrupt("spill blob payload size mismatch")
        return out
    except SpillCorrupt:
        raise
    except Exception as e:  # struct errors, bad meta, short buffers
        raise SpillCorrupt(f"malformed spill blob: "
                           f"{type(e).__name__}: {e}")


class _SpillTier:
    """Byte-budgeted LRU blob store (one tier of the hierarchy). ``put``
    evicts least-recently-used blobs into ``next_tier`` (host -> disk)
    or drops them when this is the last tier; ``get`` refreshes recency.
    Subclasses supply the storage primitives."""

    name = "tier"

    def __init__(self, capacity_bytes: int, next_tier=None):
        self.capacity_bytes = int(capacity_bytes)
        self.next_tier = next_tier
        self._index: "OrderedDict[bytes, int]" = OrderedDict()
        self.occupancy_bytes = 0
        # pool-layout bytes per blob: with coded blobs the physical
        # occupancy undersells what the tier can restore
        self._logical: Dict[bytes, int] = {}
        self.logical_bytes = 0
        self.hits = 0
        self.misses = 0
        self.stored_blobs = 0       # lifetime puts accepted
        self.demoted_blobs = 0      # LRU-pushed into next_tier
        self.dropped_blobs = 0      # LRU/oversize-dropped (no next tier)

    def _store(self, key: bytes, blob: bytes) -> None:
        raise NotImplementedError

    def _load(self, key: bytes) -> bytes:
        raise NotImplementedError

    def _delete(self, key: bytes) -> None:
        raise NotImplementedError

    def contains(self, key: bytes) -> bool:
        return key in self._index

    def touch(self, key: bytes) -> None:
        if key in self._index:
            self._index.move_to_end(key)

    def _evict_lru(self) -> None:
        # account before any IO, and read the blob only when there is a
        # next tier to demote into: the last tier's evictions are drops
        key, size = self._index.popitem(last=False)
        self.occupancy_bytes -= size
        self.logical_bytes -= self._logical.pop(key, size)
        if self.next_tier is None:
            self._delete(key)
            self.dropped_blobs += 1
            return
        try:
            blob = self._load(key)
        except OSError:
            # the backing file vanished: the blob is already gone
            self._delete(key)
            self.dropped_blobs += 1
            return
        self._delete(key)
        self.next_tier.put(key, blob)
        self.demoted_blobs += 1

    def put(self, key: bytes, blob: bytes) -> bool:
        """Store (or refresh) ``key``; False when the blob cannot fit
        this tier at all (it is demoted or dropped)."""
        if len(blob) > self.capacity_bytes:
            if self.next_tier is not None:
                self.next_tier.put(key, blob)
                self.demoted_blobs += 1
            else:
                self.dropped_blobs += 1
            return False
        if key in self._index:
            self.remove(key)
        while self.occupancy_bytes + len(blob) > self.capacity_bytes:
            self._evict_lru()
        self._store(key, blob)
        self._index[key] = len(blob)
        self.occupancy_bytes += len(blob)
        logical = blob_logical_bytes(blob)
        self._logical[key] = logical
        self.logical_bytes += logical
        self.stored_blobs += 1
        return True

    def get(self, key: bytes) -> Optional[bytes]:
        if key not in self._index:
            self.misses += 1
            return None
        try:
            blob = self._load(key)
        except OSError:
            # a vanished backing file is a miss, not a crash
            size = self._index.pop(key)
            self.occupancy_bytes -= size
            self.logical_bytes -= self._logical.pop(key, size)
            self.misses += 1
            return None
        self.hits += 1
        self._index.move_to_end(key)
        return blob

    def remove(self, key: bytes) -> None:
        size = self._index.pop(key, None)
        if size is not None:
            self.occupancy_bytes -= size
            self.logical_bytes -= self._logical.pop(key, size)
            self._delete(key)

    def clear(self) -> None:
        for key in list(self._index):
            self.remove(key)

    @property
    def blob_count(self) -> int:
        return len(self._index)

    def check_consistent(self) -> None:
        """Audit: the occupancy counters match the index, and every
        indexed blob loads at its indexed size."""
        total = sum(self._index.values())
        if total != self.occupancy_bytes:
            raise RuntimeError(
                f"{self.name} tier occupancy {self.occupancy_bytes} != "
                f"indexed bytes {total}")
        logical = sum(self._logical.get(k, s)
                      for k, s in self._index.items())
        if logical != self.logical_bytes:
            raise RuntimeError(
                f"{self.name} tier logical bytes {self.logical_bytes} "
                f"!= indexed logical {logical}")
        for key, size in self._index.items():
            blob = self._load(key)
            if len(blob) != size:
                raise RuntimeError(
                    f"{self.name} tier blob {key.hex()} is {len(blob)}B "
                    f"but indexed as {size}B")

    def stats(self) -> Dict[str, Any]:
        return {"blobs": self.blob_count,
                "occupancy_bytes": self.occupancy_bytes,
                "logical_bytes": self.logical_bytes,
                "capacity_bytes": self.capacity_bytes,
                "hits": self.hits, "misses": self.misses,
                "stored_blobs": self.stored_blobs,
                "demoted_blobs": self.demoted_blobs,
                "dropped_blobs": self.dropped_blobs}


class HostSpillTier(_SpillTier):
    """Host-RAM blob tier (the first stop of an evicted page)."""

    name = "host"

    def __init__(self, capacity_bytes: int, next_tier=None):
        super().__init__(capacity_bytes, next_tier)
        self._blobs: Dict[bytes, bytes] = {}

    def _store(self, key, blob):
        self._blobs[key] = blob

    def _load(self, key):
        return self._blobs[key]

    def _delete(self, key):
        self._blobs.pop(key, None)


class DiskSpillTier(_SpillTier):
    """Disk blob tier: one ``<key>.kvblob`` file a blob under
    ``directory``. Writes are atomic (tmp + rename), and construction
    scrubs stale ``*.kvblob`` (and ``.kvblob.tmp``) files of a previous
    process: blobs never outlive the cache that wrote them."""

    name = "disk"

    def __init__(self, directory: str, capacity_bytes: int,
                 next_tier=None):
        super().__init__(capacity_bytes, next_tier)
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        for fn in os.listdir(directory):
            if fn.endswith((".kvblob", ".kvblob.tmp")):
                try:
                    os.unlink(os.path.join(directory, fn))
                except OSError:
                    pass

    def _path(self, key: bytes) -> str:
        return os.path.join(self.directory, key.hex() + ".kvblob")

    def _store(self, key, blob):
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, self._path(key))

    def _load(self, key):
        with open(self._path(key), "rb") as f:
            return f.read()

    def _delete(self, key):
        try:
            os.unlink(self._path(key))
        except OSError:
            pass

    def check_consistent(self) -> None:
        super().check_consistent()
        on_disk = {fn for fn in os.listdir(self.directory)
                   if fn.endswith(".kvblob")}
        indexed = {k.hex() + ".kvblob" for k in self._index}
        if on_disk != indexed:
            raise RuntimeError(
                f"disk tier diverged from its files: dangling "
                f"{sorted(on_disk - indexed)[:4]}, missing "
                f"{sorted(indexed - on_disk)[:4]}")


@dataclasses.dataclass
class _Entry:
    key: bytes
    parent: Optional[bytes]
    page: int
    tokens: np.ndarray            # the block's tokens (collision guard)
    refcount: int = 0             # active requests holding this one
    children: int = 0             # child entries chaining off this one
    last_used: int = 0            # LRU tick
    head: Optional[bytes] = None  # the chain's head, fixed at insert
    dedup: bool = False           # a second request's identical page
                                  # folded onto this one: the allocator
                                  # owner is ("dedup", key)


class PrefixCache:
    """Host-side refcounted prefix-page cache. ``page_size`` must equal
    the engine's.

    Spill tiers: ``spill_bytes`` adds a host-RAM tier, ``spill_dir`` a
    disk tier of ``disk_bytes`` (1 GiB unless given) behind it. The
    tiers need device IO, which the engine attaches
    (:meth:`attach_device_io`); without it they stay inert.
    ``blob_format`` picks the spill codec (``raw``/``int8``/``int4``).

    ``dedup`` (on by default, as in the JAX package): when a request
    inserts a full page whose chain a sibling with the same prompt
    inserted first (possible under chunked prefill, whose insert follows
    the last chunk), the request's table row is retargeted at the shared
    page and its private duplicate goes back to the free list; the
    shared page moves to a ``("dedup", key)`` owner. The chain key and
    the token check prove the two pages hold the same KV, so greedy
    outputs are the same on and off."""

    def __init__(self, page_size: int,
                 spill_bytes: Optional[int] = None,
                 spill_dir: Optional[str] = None,
                 disk_bytes: Optional[int] = None,
                 blob_format: str = "raw",
                 dedup: bool = True,
                 generation: int = 0):
        if blob_format not in BLOB_FORMATS:
            raise ValueError(
                f"blob_format must be one of {BLOB_FORMATS}; "
                f"got {blob_format!r}")
        self.blob_format = blob_format
        self.dedup = bool(dedup)
        self.dedup_hits = 0          # pages folded onto a resident one
        # salted into every chain root; 0 = no salt
        self.generation = int(generation)
        # lossy-codec accounting (the pack_page_blob stats sink)
        self.codec_stats: Dict[str, Any] = {}
        self.page_size = int(page_size)
        self._entries: Dict[bytes, _Entry] = {}
        self._tick = 0
        # lifetime counters; hit/miss_pages are DEVICE-tier figures,
        # tier hits land in tier_hit_pages and hit_rate() blends them
        self.hit_pages = 0
        self.miss_pages = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.tier_hit_pages: Dict[str, int] = {}
        self.spilled_pages = 0       # blobs written on eviction
        self.restored_pages = 0      # blobs spliced back on a hit
        self.restore_corrupt = 0     # crc/structure failures (typed)
        self.spill_failed = 0        # spill writes/reads lost (fault/io)
        self.last_restore_ms: Optional[float] = None
        disk = (DiskSpillTier(spill_dir,
                              int(disk_bytes if disk_bytes is not None
                                  else 1 << 30))
                if spill_dir else None)
        host = (HostSpillTier(int(spill_bytes), next_tier=disk)
                if spill_bytes else None)
        self.tiers: List[_SpillTier] = [t for t in (host, disk)
                                        if t is not None]
        for t in self.tiers:
            self.tier_hit_pages[t.name] = 0
        # device IO installed by the engine: read_page(page) -> per-layer
        # (k, v, ks, vs) host arrays; splice_page(pages, layers_list)
        # writes a run of them into fresh pages
        self._read_page: Optional[Callable[[int], Any]] = None
        self._splice_page: Optional[Callable[[Sequence[int], Any],
                                             None]] = None
        # chain heads with a blob in a tier (the affinity advertisement
        # covers spilled prefixes too); pruned in advertised_keys_info
        self._tier_heads: set = set()
        # spilled chain members by head key: eviction is leaf-first, so
        # the head is known at spill time. fetch_pages expands a head
        # into its whole chain through this
        self._spilled_by_head: Dict[bytes, set] = {}
        # keys whose tier blobs came over the wire (import_blobs), for
        # the fetched split of restore_from_spill
        self._fetched_keys: set = set()
        self.exported_pages = 0      # blobs served to peers
        self.imported_pages = 0      # blobs accepted from peers
        self.import_corrupt = 0      # wire blobs failing the crc check

    # -- spill-tier plumbing ------------------------------------------------

    def attach_device_io(
            self, read_page: Optional[Callable[[int], Any]],
            splice_page: Optional[Callable[[Sequence[int], Any], None]]
    ) -> None:
        """Engine hookup: how the cache copies a page to the host at
        eviction (``read_page(page) -> per-layer blocks``) and splices a
        run of restored blobs into fresh pages (``splice_page(pages,
        layers_list)``, one device call a run). None detaches it."""
        self._read_page = read_page
        self._splice_page = splice_page

    @property
    def spill_enabled(self) -> bool:
        return bool(self.tiers) and self._read_page is not None

    # -- keys --------------------------------------------------------------

    def _shareable_blocks(self, prompt: np.ndarray) -> int:
        # full pages strictly before the last prompt token
        return max(0, (len(prompt) - 1) // self.page_size)

    def _chain_keys(self, prompt: np.ndarray
                    ) -> List[Tuple[bytes, Optional[bytes], np.ndarray]]:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        out: List[Tuple[bytes, Optional[bytes], np.ndarray]] = []
        parent: Optional[bytes] = None
        for i in range(self._shareable_blocks(prompt)):
            block = prompt[i * self.page_size:(i + 1) * self.page_size]
            key = _block_hash(parent, block, generation=self.generation)
            out.append((key, parent, block))
            parent = key
        return out

    def chain_keys_for(self, prompt) -> List[bytes]:
        """The prompt's full chain keys (pure hashing, no state)."""
        return [k for k, _p, _b in self._chain_keys(prompt)]

    # -- lookup / refcounts ------------------------------------------------

    def _memo_chain(self, prompt, memo=None
                    ) -> List[Tuple[bytes, Optional[bytes], np.ndarray]]:
        chain = getattr(memo, "_pfx_chain", None) if memo is not None \
            else None
        if chain is None:
            chain = self._chain_keys(prompt)
            if memo is not None:
                memo._pfx_chain = chain
        return chain

    def match(self, prompt, memo=None
              ) -> Tuple[Tuple[bytes, ...], List[int]]:
        """Longest cached prefix for ``prompt``: (chain keys, pages).
        Pure: no refcount moves (admission calls ``acquire`` when it
        commits). ``memo`` (the DecodeRequest) caches the chain hashes
        across calls."""
        chain = self._memo_chain(prompt, memo)
        keys: List[bytes] = []
        pages: List[int] = []
        for key, _parent, block in chain:
            ent = self._entries.get(key)
            if ent is None or not np.array_equal(ent.tokens, block):
                break  # miss (or a hash collision: also a miss)
            keys.append(key)
            pages.append(ent.page)
        return tuple(keys), pages

    def acquire(self, keys: Sequence[bytes]) -> None:
        """Pin a matched chain for an admitting request (one ref per
        entry). Hit/miss stats are counted once, at ``insert``."""
        self._tick += 1
        for k in keys:
            ent = self._entries[k]
            ent.refcount += 1
            ent.last_used = self._tick

    def release(self, keys: Sequence[bytes]) -> None:
        for k in keys:
            ent = self._entries.get(k)
            if ent is None:
                continue  # entry force-cleared (close() teardown)
            ent.refcount -= 1
            if ent.refcount < 0:
                raise RuntimeError(
                    f"prefix-cache refcount underflow on {k.hex()}")

    # -- spill / restore ---------------------------------------------------

    def _spill_entry(self, ent: _Entry) -> None:
        """Copy an about-to-be-evicted entry's page to the first spill
        tier. Tiers include the device tier: a page restored earlier
        still has its blob, so re-eviction is an LRU touch, not a second
        device read. A failed spill loses the content (a later match
        degrades to a miss) and never raises."""
        if not self.spill_enabled:
            return
        for t in self.tiers:
            if t.contains(ent.key):
                t.touch(ent.key)
                return
        try:
            # write side: "abort" loses the blob, "torn" stores a
            # corrupted one the restore-side crc32 must catch
            mode = fault_point("cache.spill", modes=("abort", "torn"))
        except InjectedFault:
            self.spill_failed += 1
            return
        try:
            blob = pack_page_blob(self._read_page(ent.page),
                                  fmt=self.blob_format,
                                  stats=self.codec_stats)
        except Exception:
            self.spill_failed += 1
            return
        if mode == "torn":
            # flip one payload byte; header and crc stay intact
            blob = blob[:-1] + bytes([blob[-1] ^ 0xFF])
        self.tiers[0].put(ent.key, blob)
        self.spilled_pages += 1
        head = self._head_of(ent.key)
        if head is not None:
            self._spilled_by_head.setdefault(head, set()).add(ent.key)
        if ent.parent is None:
            self._tier_heads.add(ent.key)

    def restore_from_spill(self, prompt, matched_keys: Sequence[bytes],
                           allocator, memo=None
                           ) -> Tuple[Tuple[bytes, ...], List[int],
                                      Dict[str, Any]]:
        """Extend a device-tier ``match`` by restoring spilled blobs:
        walk the chain past the device hits collecting contiguous,
        crc-verified tier hits, bind one fresh page a blob (owner
        ``("prefix", key)``), splice them all in ONE device call and
        register the entries. The walk stops at the first tier miss,
        allocation failure or corrupt blob (typed and counted, never
        spliced). Returns (restored keys, their pages, info) with the
        per-tier page counts, the corrupt count and the wall ms. The
        caller acquires the restored keys, as for device hits."""
        info: Dict[str, Any] = {t.name: 0 for t in self.tiers}
        info.update(corrupt=0, ms=0.0, fetched=0)
        if not self.spill_enabled or self._splice_page is None:
            return (), [], info
        chain = self._memo_chain(prompt, memo)
        start = len(matched_keys)
        if start >= len(chain):
            return (), [], info
        t0 = time.perf_counter()
        hits: List[Tuple[bytes, Optional[bytes], np.ndarray, str,
                         Any]] = []
        for i in range(start, len(chain)):
            key, parent, block = chain[i]
            if key in self._entries:
                break  # collision with other tokens (match missed it)
            blob = tier = None
            for t in self.tiers:
                blob = t.get(key)
                if blob is not None:
                    tier = t
                    break
            if blob is None:
                break  # tier miss mid-chain: chained prefill takes over
            try:
                # read side: an injected failure is a typed miss
                fault_point("cache.spill")
            except InjectedFault:
                self.spill_failed += 1
                break
            try:
                layers = unpack_page_blob(blob)
            except SpillCorrupt:
                tier.remove(key)
                self.restore_corrupt += 1
                info["corrupt"] += 1
                break
            hits.append((key, parent, block, tier.name, layers))

        # bind pages for the run under eviction pressure: cold
        # refcount-0 chains make way. The caller pinned its device match
        # first, so eviction never takes pages this admission will use.
        def alloc_one(key):
            while True:
                try:
                    pages = allocator.alloc(("prefix", key), 1)
                except InjectedFault:
                    return None  # alloc.page chaos: same as no space
                if pages is not None:
                    return pages
                if not self._evict_one(allocator):
                    return None

        new_keys: List[bytes] = []
        new_pages: List[int] = []
        for key, _parent, _block, _tname, _layers in hits:
            pages = alloc_one(key)
            if not pages:
                break
            new_keys.append(key)
            new_pages.append(pages[0])
        hits = hits[:len(new_keys)]
        if hits:
            try:
                self._splice_page(new_pages, [h[4] for h in hits])
            except Exception:
                for key in new_keys:  # never leak the fresh pages
                    allocator.free(("prefix", key))
                raise
            for (key, parent, block, tname, _layers), page in \
                    zip(hits, new_pages):
                self._tick += 1
                self._entries[key] = _Entry(key, parent, page,
                                            np.array(block, np.int32),
                                            refcount=0,
                                            last_used=self._tick,
                                            head=self._memo_head(
                                                key, parent))
                if parent is not None:
                    self._entries[parent].children += 1
                self.tier_hit_pages[tname] += 1
                info[tname] += 1
                if key in self._fetched_keys:
                    # the blob came over the wire: the fetched split
                    info["fetched"] += 1
                    self._fetched_keys.discard(key)
        if new_keys or info["corrupt"]:
            ms = (time.perf_counter() - t0) * 1e3
            info["ms"] = ms
            self.last_restore_ms = ms
            self.restored_pages += len(new_keys)
        return tuple(new_keys), new_pages, info

    # -- wire handoff --------------------------------------------------------

    def _memo_head(self, key: bytes, parent: Optional[bytes]) -> bytes:
        """Chain head of a new entry: the parent's memoized head (chains
        build root-first, so the parent is resident), else the key."""
        if parent is None:
            return key
        pent = self._entries.get(parent)
        if pent is not None and pent.head is not None:
            return pent.head
        return self._walk_head(parent) or key

    def _head_of(self, key: bytes) -> Optional[bytes]:
        """Chain head of a resident entry: the insert-time memo, else
        the parent walk."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        if ent.head is not None:
            return ent.head
        return self._walk_head(key)

    def _walk_head(self, key: bytes) -> Optional[bytes]:
        """Walk parents to the chain head (eviction is leaf-first, so a
        resident entry's parent path is resident); None for a key the
        cache does not know."""
        ent = self._entries.get(key)
        if ent is None:
            return None
        while ent.parent is not None:
            parent = self._entries.get(ent.parent)
            if parent is None:
                return None
            ent = parent
        return ent.key

    def _tier_blob(self, key: bytes) -> Optional[bytes]:
        """A tier blob read without the tier's hit/miss counts (those
        describe restores); its recency is refreshed."""
        for t in self.tiers:
            if t.contains(key):
                try:
                    blob = t._load(key)
                except OSError:
                    continue
                t.touch(key)
                return blob
        return None

    def expand_heads(self, heads: Sequence[bytes]) -> List[bytes]:
        """Every chain key reachable from ``heads``: the device subtree
        (through a reverse child index), then the members recorded at
        spill time. ``fetch_pages`` serves a whole chain this way when
        the caller knows only the advertised head."""
        children: Dict[bytes, List[bytes]] = {}
        for e in self._entries.values():
            if e.parent is not None:
                children.setdefault(e.parent, []).append(e.key)
        out: List[bytes] = []
        seen: set = set()
        for head in heads:
            stack = [head]
            while stack:
                k = stack.pop()
                if k in seen:
                    continue
                seen.add(k)
                out.append(k)
                stack.extend(children.get(k, ()))
            for k in sorted(self._spilled_by_head.get(head, ())):
                if k not in seen:
                    seen.add(k)
                    out.append(k)
        return out

    def export_blobs(self, keys: Sequence[bytes]
                     ) -> Tuple[Dict[bytes, bytes], List[bytes]]:
        """Serve chain pages to a peer (the ``fetch_pages`` op, engine
        thread): tier blobs as stored (their crc travels with them),
        device-resident pages packed through the device reader in the
        spill format. Returns (blobs by key, missing keys): a key this
        cache cannot produce is missing, never an error."""
        blobs: Dict[bytes, bytes] = {}
        missing: List[bytes] = []
        for key in keys:
            blob = self._tier_blob(key) if self.tiers else None
            if blob is None:
                ent = self._entries.get(key)
                if ent is not None and self._read_page is not None:
                    try:
                        blob = pack_page_blob(
                            self._read_page(ent.page),
                            fmt=self.blob_format,
                            stats=self.codec_stats)
                    except Exception:
                        blob = None
            if blob is None:
                missing.append(key)
            else:
                blobs[key] = blob
                self.exported_pages += 1
        return blobs, missing

    def import_blobs(self, blobs: Dict[bytes, bytes],
                     heads: Sequence[bytes] = ()) -> Dict[str, int]:
        """Accept a peer's chain pages (engine thread): every blob's crc
        is checked again (a torn transfer is a counted corrupt, never
        spliced), device-resident keys are skipped, and the rest land in
        the first spill tier like a local eviction, where
        ``restore_from_spill`` finds them at admission. ``heads`` marks
        chain heads for the advertisement. Returns {imported, corrupt,
        skipped, dropped, bytes}; ``dropped`` counts blobs the tiers
        could not keep."""
        report = {"imported": 0, "corrupt": 0, "skipped": 0,
                  "dropped": 0, "bytes": 0}
        if not self.tiers:
            report["skipped"] = len(blobs)
            return report
        # a fetched marker whose blob left every tier can never restore
        if self._fetched_keys:
            self._fetched_keys = {
                k for k in self._fetched_keys
                if any(t.contains(k) for t in self.tiers)}
        landed = []
        for key, blob in blobs.items():
            if key in self._entries:
                report["skipped"] += 1
                continue
            try:
                unpack_page_blob(blob)
            except SpillCorrupt:
                self.import_corrupt += 1
                report["corrupt"] += 1
                continue
            self.tiers[0].put(key, blob)
            landed.append((key, len(blob)))
        # count what is resident after the whole batch: a put may demote
        # or drop an oversize blob, and a later put may evict an earlier
        for key, nbytes in landed:
            if not any(t.contains(key) for t in self.tiers):
                report["dropped"] += 1
                continue
            self._fetched_keys.add(key)
            self.imported_pages += 1
            report["imported"] += 1
            report["bytes"] += nbytes
        for h in heads:
            if any(t.contains(h) for t in self.tiers):
                self._tier_heads.add(h)
        return report

    # -- insertion ---------------------------------------------------------

    def insert(self, prompt, row: np.ndarray, allocator, owner: Hashable,
               page_size: int, matched_keys: Sequence[bytes],
               device_hits: Optional[int] = None) -> Tuple[bytes, ...]:
        """Adopt the freshly prefilled full prompt pages of ``row`` (the
        slot's page-table row: entry i is the page of token block i)
        into the cache by ownership transfer ``owner`` -> cache, and
        return the request's full chain keys (matched + new), each
        holding one reference for the request.

        ``device_hits``: how many of ``matched_keys`` were device-tier
        hits (the rest were restored and counted per tier at restore);
        None = all of them."""
        if page_size != self.page_size:
            raise ValueError(
                f"engine page_size {page_size} != cache page_size "
                f"{self.page_size}")
        chain = self._chain_keys(prompt)
        keys: List[bytes] = list(matched_keys)
        self.hit_pages += (len(matched_keys) if device_hits is None
                           else int(device_hits))
        self.miss_pages += max(0, len(chain) - len(matched_keys))
        for i in range(len(matched_keys), len(chain)):
            key, parent, block = chain[i]
            ent = self._entries.get(key)
            if ent is not None and np.array_equal(ent.tokens, block):
                # a sibling with the same prefix inserted it between our
                # match() and now: take a reference
                ent.refcount += 1
                ent.last_used = self._tick
                keys.append(key)
                if self.dedup:
                    # the chain key and the token check prove the private
                    # page holds the same KV (a full page is a function
                    # of its chain): point the row at the shared page and
                    # free the duplicate. Without dedup the row keeps its
                    # private copy, freed with the request.
                    page = int(row[i])
                    owned = allocator.owners().get(owner, ())
                    if page != ent.page and page in owned:
                        led = getattr(allocator, "ledger", None)
                        ctx = (led.why("dedup_hit",
                                       owner if isinstance(owner, int)
                                       else None)
                               if led is not None
                               else contextlib.nullcontext())
                        with ctx:
                            row[i] = ent.page
                            allocator.release_pages(owner, [page])
                            if not ent.dedup:
                                allocator.transfer(
                                    ("prefix", ent.key),
                                    ("dedup", ent.key), [ent.page])
                                ent.dedup = True
                        self.dedup_hits += 1
                continue
            if ent is not None:
                break  # hash collision with other tokens: stop
            page = int(row[i])
            allocator.transfer(owner, ("prefix", key), [page])
            self._tick += 1
            self._entries[key] = _Entry(key, parent, page,
                                        np.array(block, np.int32),
                                        refcount=1, last_used=self._tick,
                                        head=self._memo_head(key, parent))
            if parent is not None:
                self._entries[parent].children += 1
            self.inserted_pages += 1
            keys.append(key)
        return tuple(keys)

    # -- eviction ----------------------------------------------------------

    def _evictable(self) -> List[_Entry]:
        return [e for e in self._entries.values()
                if e.refcount == 0 and e.children == 0]

    def evictable_pages(self, excluding: Sequence[bytes] = ()) -> int:
        """Pages reclaimable now or transitively (a refcount-0 parent
        becomes evictable once its refcount-0 leaves go): every entry
        not pinned by an active request at or below it. ``excluding``
        marks the entries the caller is about to pin (its own match)."""
        pinned: set = set()
        for start in list(excluding):
            k: Optional[bytes] = start
            while k is not None and k not in pinned and \
                    k in self._entries:
                pinned.add(k)
                k = self._entries[k].parent
        for e in self._entries.values():
            if e.refcount > 0:
                k = e.key
                while k is not None and k not in pinned:
                    pinned.add(k)
                    k = self._entries[k].parent
        return len(self._entries) - len(pinned)

    @staticmethod
    def _owner_of(ent: _Entry) -> Tuple[str, bytes]:
        """The allocator owner of an entry's page: ("dedup", key) once a
        second request folded onto it, else ("prefix", key)."""
        return ("dedup" if ent.dedup else "prefix", ent.key)

    def _evict_one(self, allocator) -> bool:
        cands = self._evictable()
        if not cands:
            return False
        victim = min(cands, key=lambda e: e.last_used)
        # spill before free: the content survives as a tier blob
        self._spill_entry(victim)
        allocator.free(self._owner_of(victim))
        if victim.parent is not None:
            self._entries[victim.parent].children -= 1
        del self._entries[victim.key]
        self.evicted_pages += 1
        return True

    def evict_until(self, allocator, need_free: int) -> bool:
        """LRU-evict refcount-0 leaves until the allocator has
        ``need_free`` free pages (True) or nothing evictable remains
        (False)."""
        while allocator.free_count < need_free:
            if not self._evict_one(allocator):
                return False
        return True

    def clear(self, allocator) -> None:
        """Return every cached page to the allocator and drop every tier
        blob (engine close()). A referenced entry here is a lifecycle
        bug: it raises."""
        busy = [e for e in self._entries.values() if e.refcount > 0]
        if busy:
            raise RuntimeError(
                f"prefix-cache clear with {len(busy)} entries still "
                f"referenced (refcounts "
                f"{[e.refcount for e in busy[:8]]}) — release requests "
                f"before close()")
        for ent in self._entries.values():
            allocator.free(self._owner_of(ent))
        self.evicted_pages += len(self._entries)
        self._entries.clear()
        for t in self.tiers:
            t.clear()
        self._tier_heads.clear()
        self._spilled_by_head.clear()
        self._fetched_keys.clear()

    def set_generation(self, generation: int, allocator) -> None:
        """Move the cache to a new weight generation
        (``prefix_cache.py:1303-1317``): every resident page and spill
        blob was computed by the old weights, so the cache is cleared
        (pages back to the allocator, tier blobs scrubbed) and later
        chain roots are salted with the new generation. The engine
        swaps weights only with no active request, so a referenced
        entry here is a lifecycle bug and ``clear`` raises."""
        generation = int(generation)
        if generation == self.generation:
            return
        self.clear(allocator)
        self.generation = generation

    # -- audits ------------------------------------------------------------

    def total_pages(self) -> int:
        return len(self._entries)

    def hit_rate(self) -> Optional[float]:
        """Blended hit rate over all tiers: device hits plus restored
        pages over everything asked for."""
        hits = self.hit_pages + sum(self.tier_hit_pages.values())
        seen = hits + self.miss_pages
        return hits / seen if seen else None

    def tier_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-tier counters: the device tier (resident pages, hit/miss
        pages, dedup-shared pages and folds) and each spill tier's
        occupancy and hits."""
        out: Dict[str, Dict[str, Any]] = {
            "device": {"pages": len(self._entries),
                       "hit_pages": self.hit_pages,
                       "miss_pages": self.miss_pages,
                       "dedup_pages": sum(
                           1 for e in self._entries.values() if e.dedup),
                       "dedup_hits": self.dedup_hits}}
        for t in self.tiers:
            s = t.stats()
            s["hit_pages"] = self.tier_hit_pages.get(t.name, 0)
            out[t.name] = s
        return out

    def advertised_keys(self, limit: int = 128) -> List[str]:
        """The keys of :meth:`advertised_keys_info`."""
        return self.advertised_keys_info(limit)["keys"]

    def advertised_keys_info(self, limit: int = 128) -> Dict[str, Any]:
        """Chain-head keys (hex) this cache can serve a prefix for:
        device-resident heads, then heads whose blob sits in a tier,
        ordered by the latest touch anywhere in the head's chain.
        Returns ``{"keys": [...], "truncated": bool}``, so the router
        tells "not resident" from "not advertised". The server's health
        reply carries it and the failover router steers on it; it is a
        hint, so staleness is harmless."""
        recency: Dict[bytes, int] = {}
        for e in self._entries.values():
            head = self._head_of(e.key)
            if head is not None:
                recency[head] = max(recency.get(head, 0), e.last_used)
        ordered = sorted(recency, key=lambda k: -recency[k])
        out = [k.hex() for k in ordered[:limit]]
        seen = set(out)
        extra = 0
        for k in list(self._tier_heads):
            if k in self._entries:
                continue  # advertised as device-resident
            if any(t.contains(k) for t in self.tiers):
                if k.hex() in seen:
                    continue
                if len(out) < limit:
                    out.append(k.hex())
                    seen.add(k.hex())
                else:
                    extra += 1
            else:
                # the head's blob left every tier: forget the chain
                self._tier_heads.discard(k)
                self._spilled_by_head.pop(k, None)
        return {"keys": out,
                "truncated": bool(len(ordered) > limit or extra)}

    def check_consistent(self, allocator) -> None:
        """Drained-engine audit: every page the allocator sees as owned
        is a cache page, and free + cached == pool size. Then each spill
        tier's own audit."""
        owners = allocator.owners()
        cache_owned = 0
        for owner, pages in owners.items():
            if not (isinstance(owner, tuple) and len(owner) == 2
                    and owner[0] in ("prefix", "dedup")):
                raise RuntimeError(
                    f"page leak past drain: owner {owner!r} still holds "
                    f"{list(pages)}")
            ent = self._entries.get(owner[1])
            if ent is None or tuple(pages) != (ent.page,):
                raise RuntimeError(
                    f"prefix-cache books diverge from allocator for "
                    f"owner {owner!r}: allocator={list(pages)}, "
                    f"entry={ent}")
            if (owner[0] == "dedup") != ent.dedup:
                raise RuntimeError(
                    f"dedup books diverge for {owner!r}: allocator "
                    f"class {owner[0]!r} but entry.dedup={ent.dedup}")
            cache_owned += len(pages)
        if allocator.free_count + cache_owned != allocator.num_pages:
            raise RuntimeError(
                f"page accounting broken: {allocator.free_count} free + "
                f"{cache_owned} cached != pool {allocator.num_pages}")
        for t in self.tiers:
            t.check_consistent()
