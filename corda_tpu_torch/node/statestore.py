"""Billion-state uniqueness store: segmented commit log + mmap index.

Port of corda_tpu/node/statestore.py, whole: `StateStoreCorruption`, the
record codec, `CommitLogStateStore` (segments, memtable, mmap
open-addressing index, compaction behind an atomic manifest swap, the
boot sweep), `ShardedCommitLogUniquenessProvider` and
`migrate_sqlite_state`. The record, index, MANIFEST and LAYOUT formats
are the reference's byte for byte, so a store directory written by
either package opens in the other with the same committed map.
`set_boundary` hooks the crash-schedule explorer
(testing/sanitizer.py `CrashScheduleExplorer(store_factory=)`) into
every durability boundary of the store.

The notary's committed-state registry rebuilt for large set sizes:
per-shard sqlite tables pay a B-tree probe per ref and a full table scan
per count. This store is an LSM-shaped replacement behind ONE facade:

    CommitLogStateStore          one partition's registry on disk
    ShardedCommitLogUniquenessProvider
                                 the provider the notary planes mount

Layout (one directory per partition)::

    MANIFEST             json {gen, through_segment, count} — atomic
                         rename commits a compaction; everything else
                         is interpreted THROUGH it on boot
    snapshot-<G>.dat     folded records for segments 0..through
    snapshot-<G>.idx     mmap open-addressing hash index over the
                         snapshot: (state-ref -> consumer tx), linear
                         probing, load factor <= 0.5
    segment-<N>.log      append-only record log; highest N is the
                         ACTIVE segment, lower ones are sealed

Write path = the intent WAL's discipline (group commit): a whole flush
of rows lands as one write+fsync on the active segment, then the
memtable (the in-memory view of every record newer than the snapshot)
absorbs them. Probe path = memtable hit first, then ONE sorted index
sweep over the mmap for the misses (`prior_consumers_many`), replacing
per-ref point probes.

Compaction folds the sealed segments into the next snapshot generation
(snapshot write -> index publish -> manifest swap, each step fsync +
atomic rename), then unlinks the folded segments. A crash at ANY point
leaves either the old manifest (old segments still authoritative;
orphan snapshot files are swept on boot) or the new one (stale
segments are swept on boot); the `boundary` callback names each of
these points. Sealed segments must be CRC-clean on boot (a doctored
byte raises StateStoreCorruption); only the active segment may carry a
torn tail, which recovery truncates. Every map is closed before the
file under it is unlinked.
"""

from __future__ import annotations

import json
import mmap
import os
import shutil
import sqlite3
import struct
import zlib
from typing import Callable, Iterator, Optional

from ..core.contracts import StateRef
from ..crypto.hashes import SecureHash
from ..utils import locks
from .notary import ShardedUniquenessProvider

# record: ref_tx(32) ref_index(4 BE) consumer(32) req_len(2 BE)
# requester(utf-8) crc32(4 BE, over everything before it)
_REC_FIXED = struct.Struct(">32sI32sH")
_CRC = struct.Struct(">I")
_IDX_MAGIC = b"CTPSIDX1"
_IDX_HEADER = struct.Struct(">8sQQ")
_IDX_SLOT = struct.Struct(">32sI32s")          # ref_tx, ref_index, consumer
_FREE_INDEX = 0xFFFFFFFF                       # empty-slot marker
_MANIFEST = "MANIFEST"

# durability boundaries a crash-schedule explorer kills at — every op
# fires the boundary callback pre and post
BOUNDARY_OPS = (
    "segment_append",
    "segment_seal",
    "snapshot_write",
    "index_publish",
    "compaction_swap",
)


class StateStoreCorruption(Exception):
    """A sealed segment or snapshot failed its integrity check: sealed
    files were fsynced before the seal, so a bad CRC is doctoring or
    media failure, never a torn write — refuse to serve over it."""


def _encode_record(ref: StateRef, consumer: bytes, requester: str) -> bytes:
    req = requester.encode("utf-8")
    if ref.index >= _FREE_INDEX:
        raise ValueError(f"state-ref index {ref.index} out of range")
    body = _REC_FIXED.pack(ref.txhash.bytes_, ref.index, consumer, len(req))
    body += req
    return body + _CRC.pack(zlib.crc32(body))


def _iter_records(buf: bytes, *, strict: bool, source: str):
    """Yield (offset_after, ref, consumer, requester) for each record.
    strict=True raises StateStoreCorruption on ANY damage (sealed
    segments, snapshots); strict=False stops at the first torn record
    (the active segment's tail) and the caller truncates there."""
    off, n = 0, len(buf)
    while off < n:
        end = off + _REC_FIXED.size
        if end > n:
            if strict:
                raise StateStoreCorruption(f"{source}: truncated header")
            return
        ref_tx, ref_index, consumer, req_len = _REC_FIXED.unpack_from(
            buf, off
        )
        end += req_len + _CRC.size
        if end > n:
            if strict:
                raise StateStoreCorruption(f"{source}: truncated record")
            return
        body = buf[off:end - _CRC.size]
        (crc,) = _CRC.unpack_from(buf, end - _CRC.size)
        if zlib.crc32(body) != crc:
            if strict:
                raise StateStoreCorruption(f"{source}: crc mismatch")
            return
        requester = buf[off + _REC_FIXED.size:end - _CRC.size].decode(
            "utf-8"
        )
        yield end, StateRef(SecureHash(ref_tx), ref_index), consumer, \
            requester
        off = end


def _slot_of(ref: StateRef, mask: int) -> int:
    h = int.from_bytes(ref.txhash.bytes_[:8], "big")
    h ^= (ref.index + 1) * 0x9E3779B97F4A7C15      # avalanche the index
    return h & mask


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CommitLogStateStore:
    """One partition's committed-state registry: segmented commit log
    + snapshot with a memory-mapped open-addressing hash index + a
    memtable for the unfolded tail. Single-writer (the provider calls
    it under the partition condition); reads of `stats()` and the
    gauges take the same lock."""

    def __init__(
        self,
        path: str,
        *,
        segment_max_records: int = 65536,
        compact_min_segments: int = 4,
        fsync: bool = True,
        boundary: Optional[Callable[[str, str], None]] = None,
    ):
        self.path = path
        self.segment_max_records = max(1, segment_max_records)
        self.compact_min_segments = max(1, compact_min_segments)
        self._fsync = fsync
        self.boundary = boundary
        self._lock = locks.make_rlock("CommitLogStateStore._lock")
        self._mem: dict[StateRef, tuple[bytes, str]] = {}
        self._idx_map: Optional[mmap.mmap] = None
        self._idx_file = None
        self._idx_slots = 0
        self._idx_mask = 0
        self._snap_count = 0
        self._gen = 0
        self._through = -1
        self._active_no = 0
        self._active_records = 0
        self._active_fh = None
        self._segment_records: dict[int, int] = {}
        self.compactions = 0
        self.appends = 0
        self.probes = 0
        self.index_probes = 0
        os.makedirs(path, exist_ok=True)
        self._recover()

    # -- boundary ---------------------------------------------------------

    def _boundary(self, op: str, when: str) -> None:
        if self.boundary is not None:
            self.boundary(op, when)

    # -- paths ------------------------------------------------------------

    def _segment_path(self, n: int) -> str:
        return os.path.join(self.path, f"segment-{n:08d}.log")

    def _snapshot_path(self, gen: int, ext: str) -> str:
        return os.path.join(self.path, f"snapshot-{gen:08d}.{ext}")

    def _write_atomic(self, path: str, data: bytes) -> None:
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(data)
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, path)
        if self._fsync:
            _fsync_dir(self.path)

    # -- recovery ---------------------------------------------------------

    def _recover(self) -> None:
        manifest = os.path.join(self.path, _MANIFEST)
        if os.path.exists(manifest):
            with open(manifest, "rb") as fh:
                meta = json.loads(fh.read().decode("utf-8"))
            self._gen = int(meta["gen"])
            self._through = int(meta["through_segment"])
            self._snap_count = int(meta["count"])
        # sweep anything the manifest does not vouch for: orphan
        # snapshot generations (crash before the swap) and segments
        # already folded into the snapshot (crash after it)
        segs = []
        for name in sorted(os.listdir(self.path)):
            full = os.path.join(self.path, name)
            if name.endswith(".tmp"):
                os.unlink(full)
            elif name.startswith("snapshot-"):
                gen = int(name.split("-")[1].split(".")[0])
                if gen != self._gen:
                    os.unlink(full)
            elif name.startswith("segment-"):
                no = int(name.split("-")[1].split(".")[0])
                if no <= self._through:
                    os.unlink(full)
                else:
                    segs.append(no)
        if self._gen > 0:
            self._open_index()
        # replay the unfolded tail into the memtable: every segment
        # except the highest is SEALED (strict CRC); the highest may
        # carry a torn tail from a crash mid-append — truncate it
        segs.sort()
        for pos, no in enumerate(segs):
            p = self._segment_path(no)
            with open(p, "rb") as fh:
                buf = fh.read()
            sealed = pos < len(segs) - 1
            good = 0
            count = 0
            for end, ref, consumer, requester in _iter_records(
                buf, strict=sealed, source=os.path.basename(p)
            ):
                self._apply(ref, consumer, requester)
                good, count = end, count + 1
            if not sealed and good < len(buf):
                with open(p, "r+b") as fh:
                    fh.truncate(good)
            self._segment_records[no] = count
        self._active_no = segs[-1] if segs else self._through + 1
        self._active_records = self._segment_records.get(self._active_no, 0)
        self._active_fh = open(self._segment_path(self._active_no), "ab")
        self._segment_records.setdefault(self._active_no, 0)
        if self._active_records >= self.segment_max_records:
            self._seal()

    def _open_index(self) -> None:
        p = self._snapshot_path(self._gen, "idx")
        self._idx_file = open(p, "rb")
        head = self._idx_file.read(_IDX_HEADER.size)
        if len(head) != _IDX_HEADER.size:
            raise StateStoreCorruption(f"{p}: truncated index header")
        magic, slots, count = _IDX_HEADER.unpack(head)
        if magic != _IDX_MAGIC or slots & (slots - 1):
            raise StateStoreCorruption(f"{p}: bad index header")
        expect = _IDX_HEADER.size + slots * _IDX_SLOT.size
        if os.fstat(self._idx_file.fileno()).st_size != expect:
            raise StateStoreCorruption(f"{p}: index size mismatch")
        self._idx_map = mmap.mmap(
            self._idx_file.fileno(), 0, access=mmap.ACCESS_READ
        )
        self._idx_slots = slots
        self._idx_mask = slots - 1
        if count != self._snap_count:
            raise StateStoreCorruption(f"{p}: index count mismatch")

    def _apply(self, ref: StateRef, consumer: bytes, requester: str) -> None:
        """First-wins fold (the sqlite layer's INSERT OR IGNORE)."""
        if ref in self._mem or self._index_lookup(ref) is not None:
            return
        self._mem[ref] = (consumer, requester)

    # -- probes -----------------------------------------------------------

    def _index_lookup(self, ref: StateRef) -> Optional[bytes]:
        if self._idx_map is None:
            return None
        self.index_probes += 1
        slot = _slot_of(ref, self._idx_mask)
        base = _IDX_HEADER.size
        for _ in range(self._idx_slots):
            off = base + slot * _IDX_SLOT.size
            ref_tx, ref_index, consumer = _IDX_SLOT.unpack_from(
                self._idx_map, off
            )
            if ref_index == _FREE_INDEX:
                return None
            if ref_index == ref.index and ref_tx == ref.txhash.bytes_:
                return consumer
            slot = (slot + 1) & self._idx_mask
        return None

    def prior_consumer(self, ref: StateRef) -> Optional[SecureHash]:
        with self._lock:
            self.probes += 1
            hit = self._mem.get(ref)
            if hit is not None:
                return SecureHash(hit[0])
            raw = self._index_lookup(ref)
            return SecureHash(raw) if raw is not None else None

    def prior_consumers_many(self, refs) -> dict[StateRef, SecureHash]:
        """Batched membership probe: memtable hits first, then ONE
        sweep over the mmap index for the misses, visited in slot
        order (sequential page access instead of a random walk) — the
        sweep that replaces per-ref point probes per flush."""
        out: dict[StateRef, SecureHash] = {}
        with self._lock:
            self.probes += len(refs)
            misses = []
            for ref in refs:
                hit = self._mem.get(ref)
                if hit is not None:
                    out[ref] = SecureHash(hit[0])
                elif self._idx_map is not None:
                    misses.append((_slot_of(ref, self._idx_mask), ref))
            misses.sort(key=lambda t: t[0])
            for _slot, ref in misses:
                raw = self._index_lookup(ref)
                if raw is not None:
                    out[ref] = SecureHash(raw)
        return out

    # -- writes -----------------------------------------------------------

    def commit_rows(self, rows) -> int:
        """Group-commit a flush worth of (StateRef, consumer
        SecureHash, requester str) rows: ONE write + fsync on the
        active segment, then the memtable absorbs them. Idempotent —
        already-committed refs are skipped (first wins), so a
        re-driven cross-member commit replays safely. Returns the
        number of NEW states."""
        with self._lock:
            fresh = []
            payload = bytearray()
            for ref, consumer, requester in rows:
                cbytes = consumer.bytes_ if isinstance(
                    consumer, SecureHash
                ) else consumer
                if ref in self._mem or self._index_lookup(ref) is not None:
                    continue
                payload += _encode_record(ref, cbytes, requester)
                fresh.append((ref, cbytes, requester))
            if not fresh:
                return 0
            self._boundary("segment_append", "pre")
            self._active_fh.write(payload)
            self._active_fh.flush()
            if self._fsync:
                os.fsync(self._active_fh.fileno())
            for ref, cbytes, requester in fresh:
                self._mem[ref] = (cbytes, requester)
            self._active_records += len(fresh)
            self._segment_records[self._active_no] = self._active_records
            self.appends += len(fresh)
            self._boundary("segment_append", "post")
            if self._active_records >= self.segment_max_records:
                self._seal()
                if self.sealed_segments >= self.compact_min_segments:
                    self.compact()
            return len(fresh)

    def _seal(self) -> None:
        """Close the active segment (fsynced — from here on a bad CRC
        is corruption, not a torn tail) and open the next."""
        self._active_fh.flush()
        if self._fsync:
            os.fsync(self._active_fh.fileno())
        self._boundary("segment_seal", "pre")
        self._active_fh.close()
        self._active_no += 1
        self._active_records = 0
        self._segment_records[self._active_no] = 0
        self._active_fh = open(self._segment_path(self._active_no), "ab")
        if self._fsync:
            _fsync_dir(self.path)
        self._boundary("segment_seal", "post")

    # -- compaction -------------------------------------------------------

    @property
    def sealed_segments(self) -> int:
        return sum(1 for n in self._segment_records if n < self._active_no)

    def maintain(self) -> bool:
        """Compaction walk for the node's pump tick: fold when enough
        sealed segments piled up. Returns True when a fold ran."""
        with self._lock:
            if self.sealed_segments >= self.compact_min_segments:
                self.compact()
                return True
            return False

    def compact(self, force: bool = False) -> None:
        """Fold every sealed segment into the next snapshot
        generation: write the record file, publish the index, swap the
        manifest (each step its own fsync + atomic rename = its own
        crash boundary), then unlink what the new manifest no longer
        references. force=True also seals a non-empty active segment
        first so the fold covers everything committed so far."""
        with self._lock:
            if force and self._active_records:
                self._seal()
            through = self._active_no - 1
            if through <= self._through and not force:
                return
            records = bytearray()
            count = 0
            for ref, consumer, requester in self._snapshot_records():
                records += _encode_record(ref, consumer, requester)
                count += 1
            for no in sorted(self._segment_records):
                if no >= self._active_no:
                    continue
                with open(self._segment_path(no), "rb") as fh:
                    buf = fh.read()
                for _end, ref, consumer, requester in _iter_records(
                    buf, strict=True,
                    source=os.path.basename(self._segment_path(no)),
                ):
                    if self._index_lookup(ref) is None:
                        records += _encode_record(ref, consumer, requester)
                        count += 1
            gen = self._gen + 1
            self._boundary("snapshot_write", "pre")
            self._write_atomic(self._snapshot_path(gen, "dat"),
                               bytes(records))
            self._boundary("snapshot_write", "post")
            self._boundary("index_publish", "pre")
            self._write_atomic(self._snapshot_path(gen, "idx"),
                               self._build_index(bytes(records), count))
            self._boundary("index_publish", "post")
            self._boundary("compaction_swap", "pre")
            self._write_atomic(
                os.path.join(self.path, _MANIFEST),
                json.dumps(
                    {"gen": gen, "through_segment": through,
                     "count": count}
                ).encode("utf-8"),
            )
            # the manifest rename IS the commit point: everything after
            # is sweeping files the new manifest no longer references
            old_gen = self._gen
            self._gen, self._through, self._snap_count = gen, through, count
            self._close_index()
            self._open_index()
            self._mem = {
                ref: v for ref, v in self._mem.items()
                if self._index_lookup(ref) is None
            }
            for no in list(self._segment_records):
                if no <= through:
                    os.unlink(self._segment_path(no))
                    del self._segment_records[no]
            if old_gen > 0:
                for ext in ("dat", "idx"):
                    p = self._snapshot_path(old_gen, ext)
                    if os.path.exists(p):
                        os.unlink(p)
            self.compactions += 1
            self._boundary("compaction_swap", "post")

    def _build_index(self, records: bytes, count: int) -> bytes:
        slots = 8
        while slots < 2 * max(count, 1):
            slots <<= 1
        table = bytearray(
            _IDX_SLOT.size * slots
        )
        free = _IDX_SLOT.pack(b"\0" * 32, _FREE_INDEX, b"\0" * 32)
        for s in range(slots):
            table[s * _IDX_SLOT.size:(s + 1) * _IDX_SLOT.size] = free
        mask = slots - 1
        for _end, ref, consumer, _req in _iter_records(
            records, strict=True, source="snapshot"
        ):
            slot = _slot_of(ref, mask)
            while True:
                off = slot * _IDX_SLOT.size
                (_tx, idx, _c) = _IDX_SLOT.unpack_from(table, off)
                if idx == _FREE_INDEX:
                    table[off:off + _IDX_SLOT.size] = _IDX_SLOT.pack(
                        ref.txhash.bytes_, ref.index, consumer
                    )
                    break
                slot = (slot + 1) & mask
        return _IDX_HEADER.pack(_IDX_MAGIC, slots, count) + bytes(table)

    def _snapshot_records(self):
        if self._gen == 0:
            return
        with open(self._snapshot_path(self._gen, "dat"), "rb") as fh:
            buf = fh.read()
        for _end, ref, consumer, requester in _iter_records(
            buf, strict=True, source="snapshot"
        ):
            yield ref, consumer, requester

    def _close_index(self) -> None:
        if self._idx_map is not None:
            self._idx_map.close()
            self._idx_map = None
        if self._idx_file is not None:
            self._idx_file.close()
            self._idx_file = None
        self._idx_slots = self._idx_mask = 0

    # -- views ------------------------------------------------------------

    @property
    def committed_count(self) -> int:
        """O(1): the snapshot count rides the manifest, the memtable
        holds only refs NOT in the snapshot — no scan anywhere."""
        return self._snap_count + len(self._mem)

    def items(self) -> Iterator[tuple[StateRef, SecureHash]]:
        with self._lock:
            for ref, consumer, _req in self._snapshot_records():
                yield ref, SecureHash(consumer)
            for ref, (consumer, _req) in list(self._mem.items()):
                yield ref, SecureHash(consumer)

    def stats(self) -> dict:
        with self._lock:
            return {
                "generation": self._gen,
                "through_segment": self._through,
                "active_segment": self._active_no,
                "active_records": self._active_records,
                "sealed_segments": self.sealed_segments,
                "snapshot_states": self._snap_count,
                "memtable_states": len(self._mem),
                "committed_states": self.committed_count,
                "index_slots": self._idx_slots,
                "compactions": self.compactions,
                "appends": self.appends,
                "probes": self.probes,
                "index_probes": self.index_probes,
            }

    # -- state transfer ---------------------------------------------------

    def snapshot_files(self) -> list[tuple[str, bytes]]:
        """The durable file set a joiner pulls over the cluster
        state-transfer endpoint: manifest + snapshot pair + the
        unfolded segments — installing them reproduces this store
        bit-for-bit."""
        with self._lock:
            self._active_fh.flush()
            if self._fsync:
                os.fsync(self._active_fh.fileno())
            out = []
            names = [_MANIFEST] if self._gen else []
            if self._gen:
                names += [
                    os.path.basename(self._snapshot_path(self._gen, ext))
                    for ext in ("dat", "idx")
                ]
            names += [
                os.path.basename(self._segment_path(no))
                for no in sorted(self._segment_records)
            ]
            for name in names:
                p = os.path.join(self.path, name)
                if os.path.exists(p):
                    with open(p, "rb") as fh:
                        out.append((name, fh.read()))
            return out

    def install_snapshot_files(self, files) -> None:
        """Replace this store's contents with a transferred file set
        (joiner bootstrap). Refuses over a non-empty store."""
        with self._lock:
            if self.committed_count:
                raise ValueError(
                    "install_snapshot_files over a non-empty store"
                )
            self._active_fh.close()
            for name in os.listdir(self.path):
                os.unlink(os.path.join(self.path, name))
            for name, data in files:
                if os.sep in name or name.startswith("."):
                    raise ValueError(f"bad transfer filename {name!r}")
                with open(os.path.join(self.path, name), "wb") as fh:
                    fh.write(data)
                    fh.flush()
                    if self._fsync:
                        os.fsync(fh.fileno())
            if self._fsync:
                _fsync_dir(self.path)
            self._close_index()
            self._mem.clear()
            self._segment_records.clear()
            self._gen, self._through, self._snap_count = 0, -1, 0
            self._active_no = self._active_records = 0
            self._recover()

    def close(self) -> None:
        with self._lock:
            if self._active_fh is not None:
                self._active_fh.close()
                self._active_fh = None
            self._close_index()


class ShardedCommitLogUniquenessProvider(ShardedUniquenessProvider):
    """The commit-log store mounted behind the sharded provider's
    storage seam — the SAME two-phase reserve→commit, partition
    primitives (`prior_consumer`/`write_partition`) and `commit_many`
    semantics as the sqlite subclass, so the batching, sharded and
    distributed notary planes all select it with nothing but the
    `notary_state_store=commitlog` knob. One CommitLogStateStore per
    partition under `<path>/gen-<g>/shard-<k>`; a shard-count retune
    is a MIGRATION exactly like the sqlite layer's: fold every
    committed row into a fresh generation of shard directories, then
    one atomic LAYOUT rename commits the switch."""

    _LAYOUT = "LAYOUT"

    def __init__(
        self,
        path: str,
        n_shards: int = 1,
        record_decisions: bool = False,
        *,
        segment_max_records: int = 65536,
        compact_min_segments: int = 4,
        fsync: bool = True,
    ):
        super().__init__(n_shards, record_decisions)
        self.path = path
        self._opts = dict(
            segment_max_records=segment_max_records,
            compact_min_segments=compact_min_segments,
            fsync=fsync,
        )
        self._fsync = fsync
        os.makedirs(path, exist_ok=True)
        self._layout_gen = self._ensure_layout()
        self._stores = [
            CommitLogStateStore(self._shard_path(k), **self._opts)
            for k in range(self.n_shards)
        ]

    def _shard_path(self, k: int, gen: Optional[int] = None) -> str:
        g = self._layout_gen if gen is None else gen
        return os.path.join(self.path, f"gen-{g:04d}", f"shard-{k}")

    def _ensure_layout(self) -> int:
        layout_p = os.path.join(self.path, self._LAYOUT)
        stored = None
        if os.path.exists(layout_p):
            with open(layout_p, "rb") as fh:
                stored = json.loads(fh.read().decode("utf-8"))
        if stored is not None and stored["shards"] == self.n_shards:
            self._sweep_layout_orphans(stored["gen"])
            return stored["gen"]
        gen = (stored["gen"] + 1) if stored is not None else 0
        if stored is not None:
            # re-shard migration: every committed row re-routes into
            # the new partition layout — a ref probed on the wrong
            # shard would silently miss the commit that conflicts it
            old = [
                CommitLogStateStore(
                    os.path.join(
                        self.path, f"gen-{stored['gen']:04d}",
                        f"shard-{k}",
                    ),
                    **self._opts,
                )
                for k in range(stored["shards"])
            ]
            routed: dict[int, list] = {}
            for store in old:
                for ref, consumer, requester in store._snapshot_records():
                    routed.setdefault(self.shard_of(ref), []).append(
                        (ref, consumer, requester)
                    )
                for ref, (consumer, requester) in store._mem.items():
                    routed.setdefault(self.shard_of(ref), []).append(
                        (ref, consumer, requester)
                    )
                store.close()
            for k in range(self.n_shards):
                dst = CommitLogStateStore(
                    self._shard_path(k, gen), **self._opts
                )
                rows = routed.get(k)
                if rows:
                    dst.commit_rows(
                        [(r, SecureHash(c), q) for r, c, q in rows]
                    )
                    dst.compact(force=True)
                dst.close()
        else:
            for k in range(self.n_shards):
                os.makedirs(self._shard_path(k, gen), exist_ok=True)
        # the LAYOUT rename commits the migration: written before the
        # new generation is complete, a crash would boot over empty
        # shard dirs and silently forget every committed state
        tmp = layout_p + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(json.dumps(
                {"shards": self.n_shards, "gen": gen}
            ).encode("utf-8"))
            fh.flush()
            if self._fsync:
                os.fsync(fh.fileno())
        os.replace(tmp, layout_p)
        if self._fsync:
            _fsync_dir(self.path)
        self._layout_gen = gen
        self._sweep_layout_orphans(gen)
        return gen

    def _sweep_layout_orphans(self, gen: int) -> None:
        for name in os.listdir(self.path):
            if name.startswith("gen-") and name != f"gen-{gen:04d}":
                shutil.rmtree(os.path.join(self.path, name),
                              ignore_errors=True)

    # -- storage backend overrides (called under the partition cond) ------

    def _prior_consumer(self, shard: int, ref: StateRef):
        return self._stores[shard].prior_consumer(ref)

    def _prior_consumers_many(self, shard: int, refs):
        return self._stores[shard].prior_consumers_many(refs)

    def _write_shard(self, shard: int, refs, tx_id, requester) -> None:
        self._stores[shard].commit_rows(
            [(ref, tx_id, requester.name) for ref in refs]
        )

    def _write_rows(self, shard: int, rows) -> None:
        self._stores[shard].commit_rows(
            [(ref, tx_id, requester.name) for ref, tx_id, requester in rows]
        )

    # -- views ------------------------------------------------------------

    @property
    def committed_count(self) -> int:
        return sum(s.committed_count for s in self._stores)

    @property
    def committed(self) -> dict:
        out: dict = {}
        for store in self._stores:
            out.update(store.items())
        return out

    def partition_depth(self, shard: int) -> int:
        return self._stores[shard].committed_count

    def stats(self) -> dict:
        shards = [s.stats() for s in self._stores]
        return {
            "backend": "commitlog",
            "shards": self.n_shards,
            "layout_generation": self._layout_gen,
            "committed_states": sum(
                s["committed_states"] for s in shards
            ),
            "snapshot_states": sum(s["snapshot_states"] for s in shards),
            "memtable_states": sum(s["memtable_states"] for s in shards),
            "segments": sum(
                s["sealed_segments"] + 1 for s in shards
            ),
            "compactions": sum(s["compactions"] for s in shards),
            "probes": sum(s["probes"] for s in shards),
            "appends": sum(s["appends"] for s in shards),
            "per_shard": shards,
        }

    # -- maintenance / transfer / lifecycle -------------------------------

    def maintain(self) -> int:
        """Compaction walk across the partitions (the node pump drives
        this) — returns how many folded."""
        return sum(1 for s in self._stores if s.maintain())

    def compact_all(self) -> None:
        for s in self._stores:
            s.compact(force=True)

    def snapshot_files(self) -> dict[int, list[tuple[str, bytes]]]:
        return {
            k: self._stores[k].snapshot_files()
            for k in range(self.n_shards)
        }

    def install_snapshot_files(self, per_shard) -> None:
        for k, files in per_shard.items():
            self._stores[int(k)].install_snapshot_files(files)

    def set_boundary(
        self, cb: Optional[Callable[[str, str], None]]
    ) -> None:
        """Wire a crash-schedule explorer's kill points into every
        partition store's durability boundaries."""
        for s in self._stores:
            s.boundary = cb

    def close(self) -> None:
        for s in self._stores:
            s.close()


def migrate_sqlite_state(
    db, provider: ShardedCommitLogUniquenessProvider
) -> int:
    """One-way boot migration sqlite -> commitlog: stream every
    committed row out of the legacy `notary_commits` table and any
    `notary_commits_s<k>` partition tables into the commit-log
    provider, fold, then clear the sqlite rows. Idempotent until the
    final clear (commit_rows skips already-present refs), so a crash
    between the fold and the clear simply re-migrates on next boot —
    the sqlite clear is LAST for exactly that reason. Returns the
    number of rows migrated."""
    from .persistence import (
        PersistentKVStore,
        ShardedPersistentUniquenessProvider,
    )

    meta = PersistentKVStore(
        db, ShardedPersistentUniquenessProvider._META_SPACE
    )
    stored = meta.get(b"shards")
    tables = ["notary_commits"]
    if stored:
        tables += [
            f"notary_commits_s{k}"
            for k in range(int.from_bytes(stored, "big"))
        ]
    moved = 0
    cleared = []
    for table in tables:
        try:
            rows = db.query(
                f"SELECT ref_tx, ref_index, consumer, requester"
                f" FROM {table}"
            )
        except sqlite3.OperationalError:
            continue
        cleared.append(table)
        if not rows:
            continue
        by_shard: dict[int, list] = {}
        for ref_tx, ref_index, consumer, requester in rows:
            ref = StateRef(SecureHash(bytes(ref_tx)), ref_index)
            by_shard.setdefault(provider.shard_of(ref), []).append(
                (ref, SecureHash(bytes(consumer)), requester)
            )
        for k, batch in by_shard.items():
            moved += provider._stores[k].commit_rows(batch)
    if moved:
        provider.compact_all()
    if cleared:
        with db.transaction() as conn:
            for table in cleared:
                conn.execute(f"DELETE FROM {table}")
    return moved
