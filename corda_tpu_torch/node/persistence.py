"""SQLite-backed node persistence.

Port of corda_tpu/node/persistence.py: the database and its nested
transactions, the KV store, the transaction, attachment and checkpoint
stores, the uniqueness providers (single table and sharded, with the
shard-count migration), key management, the vault with its schema
projections, and the hub assembly. The DDL, the CTS-encoded blobs and
the key layout are the reference's, so a node database written by
either package opens in the other. So are the batching notary's intent
journal (`NotaryIntentJournal`) and the tx-story spill
(`TxStoryIndex`): their tables and rows are byte-equal to the
reference's, and so are the distributed uniqueness plane's
coordinator WAL (`XShardCoordinatorJournal`) and participant
reservation journal (`XShardReservationJournal`).

Reference: the node's JDBC/H2 storage layer — `DBTransactionStorage`,
`NodeAttachmentService`, `DBCheckpointStorage` (node/.../services/
persistence/), `PersistentUniquenessProvider` (node/.../services/
transactions/PersistentUniquenessProvider.kt:20), the `JDBCHashMap`
KV-on-SQL primitive (node/.../utilities/JDBCHashMap.kt) and
`CordaPersistence` transaction management (node/.../utilities/
CordaPersistence.kt). H2-behind-ORMs becomes one sqlite database per
node in WAL mode; every store is a write-through cache over its table so
read paths stay as fast as the in-memory Ring-3 services they subclass.

The vault table carries denormalised query columns (contract tag,
fungible quantity/token, linear id, participant fingerprints) — the
analogue of the reference's `MappedSchema` ORM projection
(core/.../schemas/PersistentTypes.kt, node/.../vault/VaultSchema.kt) —
so the QueryCriteria parser (vault_query.py) can compile to SQL the way
HibernateQueryCriteriaParser does.
"""

from __future__ import annotations

import json
import logging
import sqlite3
from typing import Optional

from ..utils import locks

from ..core import serialization as ser
from ..core.contracts import StateRef
from ..core.identity import Party
from ..core.transactions import SignedTransaction
from ..crypto import schemes
from ..crypto.hashes import SecureHash
from .notary import (
    ShardedUniquenessProvider,
    UniquenessConflict,
    UniquenessProvider,
)
from .services import (
    AttachmentStorage,
    CheckpointStorage,
    KeyManagementService,
    TransactionStorage,
    VaultService,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS transactions (
    tx_id BLOB PRIMARY KEY,
    data  BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS attachments (
    att_id BLOB PRIMARY KEY,
    data   BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS checkpoints (
    flow_id BLOB PRIMARY KEY,
    record  BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS notary_commits (
    ref_tx    BLOB NOT NULL,
    ref_index INTEGER NOT NULL,
    consumer  BLOB NOT NULL,
    requester TEXT NOT NULL,
    PRIMARY KEY (ref_tx, ref_index)
);
CREATE TABLE IF NOT EXISTS our_keys (
    fingerprint BLOB PRIMARY KEY,
    scheme_id   INTEGER NOT NULL,
    public_key  BLOB NOT NULL,
    private_key BLOB NOT NULL
);
CREATE TABLE IF NOT EXISTS vault_states (
    ref_tx       BLOB NOT NULL,
    ref_index    INTEGER NOT NULL,
    state        BLOB NOT NULL,
    contract_tag TEXT NOT NULL,
    status       INTEGER NOT NULL,          -- 0 unconsumed, 1 consumed
    notary       TEXT,
    quantity     INTEGER,                    -- fungible states
    token        TEXT,                       -- fungible token descriptor
    issuer       TEXT,                       -- fungible issuer party name
    linear_id    BLOB,                       -- linear states
    recorded_at  INTEGER NOT NULL,
    consumed_at  INTEGER,
    PRIMARY KEY (ref_tx, ref_index)
);
CREATE INDEX IF NOT EXISTS vault_status_idx
    ON vault_states (status, contract_tag);
CREATE TABLE IF NOT EXISTS vault_parts (
    ref_tx      BLOB NOT NULL,
    ref_index   INTEGER NOT NULL,
    fingerprint BLOB NOT NULL
);
CREATE INDEX IF NOT EXISTS vault_parts_idx ON vault_parts (fingerprint);
CREATE TABLE IF NOT EXISTS kv (
    space TEXT NOT NULL,
    k     BLOB NOT NULL,
    v     BLOB NOT NULL,
    PRIMARY KEY (space, k)
);
"""


class NodeDatabase:
    """One sqlite database per node (reference: CordaPersistence over
    H2). A single serialized connection shared by every store; callers
    batch related writes inside `transaction()` the way the reference
    wraps service mutations in `database.transaction {}`."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._lock = locks.make_rlock("NodeDatabase._lock")
        self._tx_depth = 0
        with self._lock:
            if path != ":memory:":
                self._conn.execute("PRAGMA journal_mode=WAL")
                self._conn.execute("PRAGMA synchronous=NORMAL")
            self._conn.executescript(_SCHEMA)
            self._conn.commit()

    def execute(self, sql: str, params: tuple = ()) -> sqlite3.Cursor:
        with self._lock:
            cur = self._conn.execute(sql, params)
            if self._tx_depth == 0:
                self._conn.commit()
            return cur

    def query(self, sql: str, params: tuple = ()) -> list[tuple]:
        with self._lock:
            return self._conn.execute(sql, params).fetchall()

    def execute_script(self, script: str) -> None:
        """DDL for subsystem-owned tables (e.g. the fabric journals).
        Refused inside an open transaction: sqlite's executescript
        implicitly COMMITs pending writes, which would break the
        all-or-nothing guarantee of the surrounding block."""
        with self._lock:
            if self._tx_depth > 0:
                raise RuntimeError(
                    "execute_script inside an open transaction would "
                    "implicitly commit it; run DDL at startup instead"
                )
            self._conn.executescript(script)
            self._conn.commit()

    def transaction(self):
        """Context manager: batched atomic writes. Nests — inner blocks
        (and bare execute() calls) join the outermost transaction, which
        alone commits, so a multi-store mutation like
        record_transactions is all-or-nothing across a crash."""
        return _DbTx(self)

    def close(self) -> None:
        with self._lock:
            if self._conn is None:
                return   # idempotent: teardown paths overlap
            self._conn.commit()
            self._conn.close()
            self._conn = None


class _DbTx:
    """Nested blocks are sqlite SAVEPOINTs: an inner failure that the
    caller catches (e.g. UniquenessConflict inside a notary commit)
    rolls back only the inner writes — the outer transaction's prior
    writes survive and its own exit still decides commit vs rollback."""

    def __init__(self, db: NodeDatabase):
        self._db = db
        self._savepoint: Optional[str] = None

    def __enter__(self):
        self._db._lock.acquire()
        try:
            if self._db._tx_depth > 0:
                self._savepoint = f"sp{self._db._tx_depth}"
                self._db._conn.execute(f"SAVEPOINT {self._savepoint}")
            self._db._tx_depth += 1
        except BaseException:
            self._db._lock.release()   # __exit__ will never run
            raise
        return self._db._conn

    def __exit__(self, exc_type, exc, tb):
        try:
            self._db._tx_depth -= 1
            if self._savepoint is not None:
                if exc_type is not None:
                    self._db._conn.execute(
                        f"ROLLBACK TO {self._savepoint}"
                    )
                self._db._conn.execute(f"RELEASE {self._savepoint}")
            else:
                if exc_type is None:
                    self._db._conn.commit()
                else:
                    self._db._conn.rollback()
        finally:
            self._db._lock.release()
        return False


class PersistentKVStore:
    """Namespaced KV map on SQL — the JDBCHashMap primitive the
    reference builds ad-hoc node state on (JDBCHashMap.kt)."""

    def __init__(self, db: NodeDatabase, space: str):
        self._db = db
        self._space = space

    def get(self, key: bytes) -> Optional[bytes]:
        rows = self._db.query(
            "SELECT v FROM kv WHERE space=? AND k=?", (self._space, key)
        )
        return rows[0][0] if rows else None

    def put(self, key: bytes, value: bytes) -> None:
        self._db.execute(
            "INSERT OR REPLACE INTO kv (space, k, v) VALUES (?,?,?)",
            (self._space, key, value),
        )

    def delete(self, key: bytes) -> None:
        self._db.execute(
            "DELETE FROM kv WHERE space=? AND k=?", (self._space, key)
        )

    def items(self) -> list[tuple[bytes, bytes]]:
        return self._db.query(
            "SELECT k, v FROM kv WHERE space=? ORDER BY k", (self._space,)
        )


# ---------------------------------------------------------------------------
# stores


class PersistentTransactionStorage(TransactionStorage):
    """DBTransactionStorage: canonical-serialized SignedTransactions
    keyed by id, write-through over the in-memory map."""

    def __init__(self, db: NodeDatabase):
        super().__init__()
        self._db = db
        for (tx_id, data) in db.query("SELECT tx_id, data FROM transactions"):
            stx = ser.decode(data)
            self._txs[SecureHash(bytes(tx_id))] = stx

    def add_quiet(self, stx: SignedTransaction) -> bool:
        added = super().add_quiet(stx)
        if added:
            self._db.execute(
                "INSERT OR IGNORE INTO transactions (tx_id, data) VALUES (?,?)",
                (stx.id.bytes_, ser.encode(stx)),
            )
        return added


class PersistentAttachmentStorage(AttachmentStorage):
    """NodeAttachmentService: SHA-256-addressed blobs in the DB."""

    def __init__(self, db: NodeDatabase):
        super().__init__()
        self._db = db
        for (att_id, data) in db.query("SELECT att_id, data FROM attachments"):
            self._blobs[SecureHash(bytes(att_id))] = bytes(data)

    def import_attachment(self, data: bytes) -> SecureHash:
        att_id = super().import_attachment(data)
        self._db.execute(
            "INSERT OR IGNORE INTO attachments (att_id, data) VALUES (?,?)",
            (att_id.bytes_, data),
        )
        return att_id


class PersistentCheckpointStorage(CheckpointStorage):
    """DBCheckpointStorage.kt:18 — flow checkpoints survive restarts;
    StateMachineManager.restore_checkpoints reads them back."""

    def __init__(self, db: NodeDatabase):
        super().__init__()
        self._db = db
        for (flow_id, record) in db.query(
            "SELECT flow_id, record FROM checkpoints"
        ):
            self._checkpoints[bytes(flow_id)] = bytes(record)

    def add(self, flow_id: bytes, record: bytes) -> None:
        super().add(flow_id, record)
        self._db.execute(
            "INSERT OR REPLACE INTO checkpoints (flow_id, record) VALUES (?,?)",
            (flow_id, record),
        )

    def remove(self, flow_id: bytes) -> None:
        super().remove(flow_id)
        self._db.execute(
            "DELETE FROM checkpoints WHERE flow_id=?", (flow_id,)
        )


class PersistentUniquenessProvider(UniquenessProvider):
    """The notary's committed-state registry on SQL (reference:
    PersistentUniquenessProvider.kt:20, commit at :63+). All-or-nothing:
    the conflict check and the inserts share one DB transaction."""

    batch_synchronous = True

    # sqlite's default parameter ceiling is 999; two params per ref
    # pair keeps a healthy margin under it
    _PROBE_CHUNK = 400

    def __init__(self, db: NodeDatabase):
        self._db = db
        # O(1) committed count: scanned ONCE at boot, maintained by
        # actual-new-row deltas from the inserts (INSERT OR IGNORE
        # absorbs idempotent re-commits without double-counting)
        self._count = db.query(
            "SELECT COUNT(*) FROM notary_commits"
        )[0][0]

    @classmethod
    def _probe_in(cls, conn, table: str, refs) -> dict:
        """The batched conflict probe: ONE `IN (VALUES ...)` row-value
        query per chunk of refs instead of a point SELECT per ref in a
        Python loop — the same one-sweep-per-flush shape the commit-log
        store's `prior_consumers_many` serves from its mmap index."""
        out: dict = {}
        refs = list(refs)
        for i in range(0, len(refs), cls._PROBE_CHUNK):
            chunk = refs[i:i + cls._PROBE_CHUNK]
            marks = ",".join("(?,?)" for _ in chunk)
            params: list = []
            for ref in chunk:
                params += [ref.txhash.bytes_, ref.index]
            for ref_tx, ref_index, consumer in conn.execute(
                f"SELECT ref_tx, ref_index, consumer FROM {table}"
                f" WHERE (ref_tx, ref_index) IN (VALUES {marks})",
                params,
            ):
                out[StateRef(SecureHash(bytes(ref_tx)), ref_index)] = (
                    SecureHash(bytes(consumer))
                )
        return out

    def commit(
        self, states: list[StateRef], tx_id: SecureHash, requester: Party
    ) -> None:
        with self._db.transaction() as conn:
            prior_map = self._probe_in(conn, "notary_commits", states)
            conflict = {
                ref: prior
                for ref, prior in prior_map.items()
                if prior != tx_id
            }
            if conflict:
                raise UniquenessConflict(conflict)
            before = conn.total_changes
            conn.executemany(
                "INSERT OR IGNORE INTO notary_commits"
                " (ref_tx, ref_index, consumer, requester)"
                " VALUES (?,?,?,?)",
                [
                    (
                        ref.txhash.bytes_,
                        ref.index,
                        tx_id.bytes_,
                        requester.name,
                    )
                    for ref in states
                ],
            )
            self._count += conn.total_changes - before

    def commit_many(self, entries) -> list:
        """A whole notary flush in ONE DB transaction (the reference
        batches JDBC work per CommitRequest the same way): sequential
        first-wins semantics per entry, ONE batched `IN (...)` probe
        for every distinct ref in the flush (the persisted view is
        fixed for the whole transaction — only the staged view evolves
        entry to entry), and one executemany for all the surviving
        inserts."""
        from .notary import UniquenessConflict

        out = []
        rows = []
        with self._db.transaction() as conn:
            distinct: list = []
            seen: set = set()
            for states, _tx, _req in entries:
                for ref in states:
                    if ref not in seen:
                        seen.add(ref)
                        distinct.append(ref)
            persisted = self._probe_in(conn, "notary_commits", distinct)
            # staged view: refs committed by EARLIER entries in this
            # batch must conflict later ones exactly as sequential
            # commits would
            staged: dict = {}
            for states, tx_id, requester in entries:
                conflict = {}
                for ref in states:
                    prior = staged.get(ref)
                    if prior is None:
                        prior = persisted.get(ref)
                    if prior is not None and prior != tx_id:
                        conflict[ref] = prior
                if conflict:
                    out.append(UniquenessConflict(conflict))
                    continue
                for ref in states:
                    staged[ref] = tx_id
                    rows.append(
                        (
                            ref.txhash.bytes_,
                            ref.index,
                            tx_id.bytes_,
                            requester.name,
                        )
                    )
                out.append(None)
            if rows:
                before = conn.total_changes
                conn.executemany(
                    "INSERT OR IGNORE INTO notary_commits"
                    " (ref_tx, ref_index, consumer, requester)"
                    " VALUES (?,?,?,?)",
                    rows,
                )
                self._count += conn.total_changes - before
        return out

    @property
    def committed_count(self) -> int:
        return self._count


class ShardedPersistentUniquenessProvider(ShardedUniquenessProvider):
    """The sharded notary's committed-state registry on sqlite: the
    uniqueness namespace partitioned by state-ref prefix into one table
    per shard (`notary_commits_s<k>`), so every shard flush pipeline
    commits against ITS OWN table while cross-shard transactions take
    the provider's two-phase reserve→commit (notary.py
    ShardedUniquenessProvider — the reserve maps stay in memory: a
    crash releases every reservation, and a partially-written
    cross-shard commit completes on the client's idempotent same-tx
    re-commit, the retry invariant docs/serving-notary.md pins).

    Shard-count changes are a MIGRATION, not a reinterpretation: the
    layout's shard count persists in node_meta kv; on mismatch (first
    sharded boot over a legacy `notary_commits`, or an operator
    re-tuning the shard knob) every committed row is re-routed into
    the new partition tables inside one DB transaction — a ref checked
    against the wrong partition would silently miss the commit that
    conflicts it."""

    _META_SPACE = "notary_sharding"

    def __init__(
        self, db: NodeDatabase, n_shards: int = 1,
        record_decisions: bool = False,
    ):
        super().__init__(n_shards, record_decisions)
        self._db = db
        self._ensure_layout()
        # O(1) committed counts: one COUNT(*) per partition at boot,
        # maintained by actual-new-row insert deltas from there on
        self._counts = [
            self._db.query(
                f"SELECT COUNT(*) FROM {self._table(k)}"
            )[0][0]
            for k in range(self.n_shards)
        ]

    def _table(self, shard: int) -> str:
        return f"notary_commits_s{shard}"

    def _ensure_layout(self) -> None:
        meta = PersistentKVStore(self._db, self._META_SPACE)
        stored = meta.get(b"shards")
        stored_n = int.from_bytes(stored, "big") if stored else None
        ddl = "\n".join(
            f"CREATE TABLE IF NOT EXISTS {self._table(k)} ("
            " ref_tx BLOB NOT NULL, ref_index INTEGER NOT NULL,"
            " consumer BLOB NOT NULL, requester TEXT NOT NULL,"
            " PRIMARY KEY (ref_tx, ref_index));"
            for k in range(self.n_shards)
        )
        self._db.execute_script(ddl)
        if stored_n == self.n_shards:
            return
        # gather every committed row from the old layout: the legacy
        # single table (first sharded boot) plus any previous shard
        # tables (shard-count retune)
        rows: list[tuple] = []
        old_tables = ["notary_commits"]
        if stored_n:
            old_tables += [self._table(k) for k in range(stored_n)]
        with self._db.transaction() as conn:
            for table in old_tables:
                try:
                    rows.extend(
                        conn.execute(
                            f"SELECT ref_tx, ref_index, consumer,"
                            f" requester FROM {table}"
                        ).fetchall()
                    )
                except sqlite3.OperationalError:
                    continue   # table from a layout that never existed
            by_shard: dict[int, list[tuple]] = {}
            for (ref_tx, ref_index, consumer, requester) in rows:
                ref = StateRef(SecureHash(bytes(ref_tx)), ref_index)
                by_shard.setdefault(self.shard_of(ref), []).append(
                    (bytes(ref_tx), ref_index, bytes(consumer), requester)
                )
            for k in range(self.n_shards):
                conn.execute(f"DELETE FROM {self._table(k)}")
                batch = by_shard.get(k)
                if batch:
                    conn.executemany(
                        f"INSERT OR IGNORE INTO {self._table(k)}"
                        " (ref_tx, ref_index, consumer, requester)"
                        " VALUES (?,?,?,?)",
                        batch,
                    )
            # the legacy table's rows now live in the partitions; clear
            # it so nothing double-reads a stale copy
            conn.execute("DELETE FROM notary_commits")
            # the meta row commits WITH the moved rows: written outside
            # this transaction, a crash between the two would replay
            # the migration on next boot against the already-emptied
            # source tables and DELETE every committed row
            meta.put(b"shards", self.n_shards.to_bytes(4, "big"))

    # -- storage backend overrides (called under the partition cond) -------

    def _prior_consumer(self, shard: int, ref):
        row = self._db.query(
            f"SELECT consumer FROM {self._table(shard)}"
            " WHERE ref_tx=? AND ref_index=?",
            (ref.txhash.bytes_, ref.index),
        )
        return SecureHash(bytes(row[0][0])) if row else None

    def _prior_consumers_many(self, shard: int, refs) -> dict:
        with self._db.transaction() as conn:
            return PersistentUniquenessProvider._probe_in(
                conn, self._table(shard), refs
            )

    def _write_shard(self, shard: int, refs, tx_id, requester) -> None:
        self._write_rows(shard, [(ref, tx_id, requester) for ref in refs])

    def _write_rows(self, shard: int, rows) -> None:
        with self._db.transaction() as conn:
            before = conn.total_changes
            conn.executemany(
                f"INSERT OR IGNORE INTO {self._table(shard)}"
                " (ref_tx, ref_index, consumer, requester)"
                " VALUES (?,?,?,?)",
                [
                    (ref.txhash.bytes_, ref.index, tx_id.bytes_,
                     requester.name)
                    for ref, tx_id, requester in rows
                ],
            )
            self._counts[shard] += conn.total_changes - before

    @property
    def committed_count(self) -> int:
        return sum(self._counts)

    @property
    def committed(self) -> dict:
        """Merged StateRef -> consuming-tx view across the partition
        tables (tests, snapshots) — the base class reads its in-memory
        partitions, which this subclass leaves empty."""
        out: dict = {}
        for k in range(self.n_shards):
            for (ref_tx, ref_index, consumer) in self._db.query(
                f"SELECT ref_tx, ref_index, consumer FROM {self._table(k)}"
            ):
                out[StateRef(SecureHash(bytes(ref_tx)), ref_index)] = (
                    SecureHash(bytes(consumer))
                )
        return out

    def partition_depth(self, shard: int) -> int:
        return self._counts[shard]


class NotaryIntentJournal:
    """Durable intake WAL for the batching notary.

    Every ADMITTED notarisation request appends one intent row —
    transaction, requester, deadline — BEFORE it enters the pending
    queue, and the row is deleted when the request's future resolves
    (any answer counts: signature, conflict, shed, unavailable). The
    table lives in the node's WAL-mode sqlite database under the same
    fsync discipline as the fabric journals: appends are WAL writes
    (synchronous=NORMAL — no per-row fsync), resolution deletes are
    buffered in memory and group-committed once per flush tick.

    On boot, `BatchingNotaryService.replay_intents` re-enqueues every
    row still present — requests that were admitted but in flight when
    the process died — through the normal flush path. Replays of
    requests that had actually committed before the crash (the answer
    raced the buffered delete) are absorbed by the uniqueness
    provider's idempotent same-tx re-commit, so the replay can only
    ADD answers, never change one: in-flight-at-kill loss goes to
    zero.
    """

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS notary_intents (
        seq       INTEGER PRIMARY KEY AUTOINCREMENT,
        tx_id     BLOB NOT NULL,
        data      BLOB NOT NULL,
        requester BLOB NOT NULL,
        deadline  INTEGER
    );
    """

    def __init__(self, db: NodeDatabase):
        self._db = db
        db.execute_script(self._SCHEMA)
        self._lock = locks.make_lock("NotaryIntentJournal._lock")
        self._resolved_buf: list[int] = []
        self.appended = 0
        self.resolved = 0
        self.replayed = 0
        # intents whose payload no longer decodes (a cordapp removed
        # between boots): kept in the table, surfaced here, never
        # allowed to crash the boot replay
        self.undecodable: list[int] = []

    def append(self, stx, requester: Party, deadline: Optional[int]) -> int:
        """Journal one admitted request; returns its intent seq. The
        row is on the WAL before this returns — from here a crash
        replays the request instead of losing it."""
        cur = self._db.execute(
            "INSERT INTO notary_intents (tx_id, data, requester, deadline)"
            " VALUES (?,?,?,?)",
            (
                stx.id.bytes_,
                ser.encode(stx),
                ser.encode(requester),
                deadline,
            ),
        )
        self.appended += 1
        return cur.lastrowid

    def mark_resolved(self, seq: int) -> None:
        """Buffer one intent's resolution (called from the answer
        path's done-callback — cheap, lock-only). The delete lands in
        the next `flush_resolved` group commit; a crash inside that
        window replays an already-answered request, which the
        uniqueness dedupe absorbs."""
        with self._lock:
            self._resolved_buf.append(seq)

    def flush_resolved(self) -> int:
        """Group-commit every buffered resolution in ONE transaction
        (the per-flush-tick fsync discipline). Returns rows cleared."""
        with self._lock:
            buf, self._resolved_buf = self._resolved_buf, []
        if not buf:
            return 0
        with self._db.transaction() as conn:
            conn.executemany(
                "DELETE FROM notary_intents WHERE seq=?",
                [(s,) for s in buf],
            )
        self.resolved += len(buf)
        return len(buf)

    def lose_unflushed_resolutions(self) -> int:
        """Crash simulation: a real
        process death loses the in-memory resolution buffer — those
        answered-but-undeleted intents must REPLAY on boot (and be
        absorbed by uniqueness dedupe). Drops the buffer; returns how
        many resolutions were lost."""
        with self._lock:
            n, self._resolved_buf = len(self._resolved_buf), []
        return n

    def unresolved(self) -> list:
        """Every intent not yet resolved, oldest first, decoded:
        [(seq, stx, requester_party, deadline)]. Buffered-but-unflushed
        resolutions are excluded — they ARE answered, only their
        delete is pending."""
        with self._lock:
            buffered = set(self._resolved_buf)
        out = []
        self.undecodable = []
        for seq, data, requester, deadline in self._db.query(
            "SELECT seq, data, requester, deadline FROM notary_intents"
            " ORDER BY seq"
        ):
            if seq in buffered:
                continue
            try:
                stx = ser.decode(bytes(data))
                who = ser.decode(bytes(requester))
            except Exception as e:   # noqa: BLE001 - surfaced, not fatal
                # a state/contract class registered when this intent
                # was journaled but absent now (cordapp change between
                # boots) must not crash the boot: keep the row, tell
                # the operator, replay the rest
                self.undecodable.append(seq)
                logging.getLogger("corda_tpu_torch.notary").warning(
                    "intent %d does not decode (%s: %s); kept in the "
                    "WAL, skipped by replay", seq, type(e).__name__, e,
                )
                continue
            out.append((seq, stx, who, deadline))
        return out

    @property
    def unresolved_count(self) -> int:
        with self._lock:
            buffered = len(self._resolved_buf)
        return (
            self._db.query("SELECT COUNT(*) FROM notary_intents")[0][0]
            - buffered
        )


class XShardCoordinatorJournal:
    """Presumed-abort decision WAL for the distributed cross-shard
    coordinator (node/distributed_uniqueness.py).

    Every cross-MEMBER transaction appends one intent row BEFORE its
    first ShardReserve leaves the coordinator; the commit decision is
    marked durably BEFORE any ShardCommit is sent (the 2PC commit
    point); the row is deleted once every owner acked its commit. The
    recovery contract is classic presumed abort:

      - row with the commit mark  -> the transaction COMMITTED: a
        restarted coordinator re-drives ShardCommit until every owner
        acks (participants apply idempotently);
      - row without the mark      -> ABORT: recovery sends ShardAbort
        to every involved owner and deletes the row — and a
        participant status query against a coordinator with no row
        gets "abort", which is what releases orphaned reservations.

    Same WAL-mode/no-per-row-fsync sqlite discipline as the intent and
    fabric journals (the node database is already in WAL mode)."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS xshard_intents (
        xid       INTEGER PRIMARY KEY AUTOINCREMENT,
        tx_id     BLOB NOT NULL,
        refs      BLOB NOT NULL,
        requester BLOB NOT NULL,
        committed INTEGER NOT NULL DEFAULT 0
    );
    """

    def __init__(self, db: NodeDatabase):
        self._db = db
        db.execute_script(self._SCHEMA)
        self.begun = 0
        self.decided = 0
        self.finished = 0

    def begin(self, tx_id, refs, requester: Party) -> int:
        """Journal one cross-member intent; returns its xid. The row is
        on the WAL before the first reserve leaves this process."""
        cur = self._db.execute(
            "INSERT INTO xshard_intents (tx_id, refs, requester, committed)"
            " VALUES (?,?,?,0)",
            (
                tx_id.bytes_,
                ser.encode(list(refs)),
                ser.encode(requester),
            ),
        )
        self.begun += 1
        return cur.lastrowid

    def decide_commit(self, xid: int) -> None:
        """Mark the commit decision durably — THE 2PC commit point:
        from here the transaction completes even across a coordinator
        kill (recovery re-drives). Aborts are never marked — a missing
        mark IS the abort decision (presumed abort)."""
        self._db.execute(
            "UPDATE xshard_intents SET committed=1 WHERE xid=?", (xid,)
        )
        self.decided += 1

    def finish(self, xid: int) -> None:
        """Every owner acked (commit) or the abort resolved: the row
        has no further recovery value."""
        self._db.execute("DELETE FROM xshard_intents WHERE xid=?", (xid,))
        self.finished += 1

    def is_committed(self, tx_id) -> bool:
        """Durable decision lookup for a status query against a tx this
        boot no longer holds in memory."""
        rows = self._db.query(
            "SELECT committed FROM xshard_intents WHERE tx_id=?",
            (tx_id.bytes_,),
        )
        return any(bool(c) for (c,) in rows)

    def unresolved(self) -> list:
        """Every intent still journaled, oldest first:
        [(xid, tx_id, refs, requester, committed)] — recovery's replay
        input. Rows that no longer decode are kept and skipped (the
        intent-journal stance: a cordapp change must not crash boot)."""
        out = []
        self.undecodable: list[int] = []
        for xid, tx_id, refs, requester, committed in self._db.query(
            "SELECT xid, tx_id, refs, requester, committed"
            " FROM xshard_intents ORDER BY xid"
        ):
            try:
                decoded_refs = [r for r in ser.decode(bytes(refs))]
                who = ser.decode(bytes(requester))
            except Exception as e:   # noqa: BLE001 - surfaced, not fatal
                self.undecodable.append(xid)
                logging.getLogger("corda_tpu_torch.notary").warning(
                    "xshard intent %d does not decode (%s: %s); kept, "
                    "skipped by recovery", xid, type(e).__name__, e,
                )
                continue
            out.append(
                (xid, SecureHash(bytes(tx_id)), decoded_refs, who,
                 bool(committed))
            )
        return out

    @property
    def unresolved_count(self) -> int:
        return self._db.query(
            "SELECT COUNT(*) FROM xshard_intents"
        )[0][0]


class XShardReservationJournal:
    """Durable participant-side reservations for the distributed
    provider: a row lands BEFORE the ShardReserveAck leaves this
    member and is deleted when the reservation resolves (commit or
    abort). A participant killed -9 mid-reserve reloads its held rows
    on boot and drives them to resolution through the normal orphan
    machinery (status query -> coordinator WAL answer) — without this,
    a restarted owner would forget a reservation whose coordinator
    already decided commit, and a rival could consume the refs in the
    gap: the silent double-spend window the design refuses."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS xshard_reservations (
        tx_id       BLOB NOT NULL,
        xid         INTEGER NOT NULL,
        coordinator TEXT NOT NULL,
        refs        BLOB NOT NULL,
        requester   BLOB NOT NULL,
        PRIMARY KEY (tx_id)
    );
    """

    def __init__(self, db: NodeDatabase):
        self._db = db
        db.execute_script(self._SCHEMA)

    def reserve(self, tx_id, xid: int, coordinator: str, refs, requester):
        self._db.execute(
            "INSERT OR REPLACE INTO xshard_reservations"
            " (tx_id, xid, coordinator, refs, requester) VALUES (?,?,?,?,?)",
            (
                tx_id.bytes_, xid, coordinator,
                ser.encode(list(refs)), ser.encode(requester),
            ),
        )

    def release(self, tx_id) -> None:
        self._db.execute(
            "DELETE FROM xshard_reservations WHERE tx_id=?", (tx_id.bytes_,)
        )

    def held(self) -> list:
        """[(tx_id, xid, coordinator, refs, requester)], the boot-time
        reload input. Undecodable rows are dropped WITH their table row
        — unlike an intent, a reservation that cannot be interpreted
        cannot be resolved either, and holding it forever would wedge
        its refs."""
        out = []
        for tx_id, xid, coordinator, refs, requester in self._db.query(
            "SELECT tx_id, xid, coordinator, refs, requester"
            " FROM xshard_reservations"
        ):
            tid = SecureHash(bytes(tx_id))
            try:
                out.append(
                    (tid, xid, coordinator,
                     [r for r in ser.decode(bytes(refs))],
                     ser.decode(bytes(requester)))
                )
            except Exception as e:   # noqa: BLE001 - surfaced, not fatal
                logging.getLogger("corda_tpu_torch.notary").warning(
                    "xshard reservation %s does not decode (%s: %s); "
                    "dropped", tid, type(e).__name__, e,
                )
                self.release(tid)
        return out

    @property
    def held_count(self) -> int:
        return self._db.query(
            "SELECT COUNT(*) FROM xshard_reservations"
        )[0][0]


class TxStoryIndex:
    """Sqlite spill for the transaction lifecycle ledger
    (utils/txstory.py): every recorded event also lands here, so a
    story the bounded in-memory ring evicted stays answerable at
    GET /tx/<id>.

    Same WAL discipline as the intent journal above: the table lives
    in the node's WAL-mode database (synchronous=NORMAL — no per-row
    fsync), appends buffer IN MEMORY on the emitting thread (one lock,
    no sqlite on the hot path) and group-commit once per pump tick via
    `flush()` — a crash loses at most one tick's worth of forensic
    events, never serving-path answers (the ledger is an observer
    plane; the intent WAL owns exactly-once)."""

    _SCHEMA = """
    CREATE TABLE IF NOT EXISTS tx_story_events (
        seq       INTEGER PRIMARY KEY AUTOINCREMENT,
        tx_id     TEXT NOT NULL,
        name      TEXT NOT NULL,
        at_micros INTEGER NOT NULL,
        mono_us   INTEGER NOT NULL,
        attrs     TEXT
    );
    CREATE INDEX IF NOT EXISTS tx_story_events_tx
        ON tx_story_events (tx_id, seq);
    """

    def __init__(self, db: NodeDatabase, max_rows: int = 200_000):
        self._db = db
        db.execute_script(self._SCHEMA)
        self._lock = locks.make_lock("TxStoryIndex._lock")
        self._buf: list[tuple] = []
        self._max_rows = max(1_000, max_rows)
        self.appended = 0
        self.flushes = 0

    def append(self, tx_id: str, name: str, at: int, mono: int, attrs) -> None:
        """Buffer one event (called under the TxStory lock — memory
        only, the sqlite write happens at flush())."""
        with self._lock:
            self._buf.append((tx_id, name, at, mono, attrs))

    def flush(self) -> int:
        """Group-commit the buffer in ONE transaction (the
        flush_resolved discipline); returns rows written. Retention is
        enforced here too: past `max_rows` the oldest rows fall off so
        the spill stays bounded like everything else in the plane."""
        with self._lock:
            buf, self._buf = self._buf, []
        if not buf:
            return 0
        rows = [
            (
                tx_id, name, at, mono,
                json.dumps(attrs) if attrs else None,
            )
            for tx_id, name, at, mono, attrs in buf
        ]
        with self._db.transaction() as conn:
            conn.executemany(
                "INSERT INTO tx_story_events"
                " (tx_id, name, at_micros, mono_us, attrs)"
                " VALUES (?,?,?,?,?)",
                rows,
            )
            conn.execute(
                "DELETE FROM tx_story_events WHERE seq <= ("
                "SELECT COALESCE(MAX(seq), 0) - ? FROM tx_story_events)",
                (self._max_rows,),
            )
        self.appended += len(rows)
        self.flushes += 1
        return len(rows)

    def events_for(self, tx_id: str) -> list[dict]:
        """One transaction's journaled events, oldest first, decoded to
        the same row shape the in-memory story exports."""
        out = []
        for name, at, mono, attrs in self._db.query(
            "SELECT name, at_micros, mono_us, attrs FROM tx_story_events"
            " WHERE tx_id=? ORDER BY seq",
            (tx_id,),
        ):
            row = {"name": name, "at_micros": at, "mono_us": mono}
            if attrs:
                try:
                    row.update(json.loads(attrs))
                except ValueError:
                    pass
            out.append(row)
        return out

    @property
    def row_count(self) -> int:
        return self._db.query(
            "SELECT COUNT(*) FROM tx_story_events"
        )[0][0]


class PersistentKeyManagementService(KeyManagementService):
    """PersistentKeyManagementService: fresh (anonymous) keys persist so
    confidential identities survive a node restart."""

    def __init__(self, db: NodeDatabase, *initial_keys: schemes.KeyPair, rng=None):
        super().__init__(*initial_keys, rng=rng)
        self._db = db
        # Key material is stored as raw columns, NOT via the canonical
        # codec: registering a PrivateKey serializer would silently make
        # private keys wire-encodable anywhere (checkpoints, session
        # payloads), defeating the encode-time guard in serialization.py.
        for (fp, scheme_id, pub, priv) in db.query(
            "SELECT fingerprint, scheme_id, public_key, private_key"
            " FROM our_keys"
        ):
            public = schemes.PublicKey(scheme_id, bytes(pub))
            self._keys[public] = schemes.PrivateKey(
                scheme_id, bytes(priv), public
            )
        for kp in initial_keys:
            self._persist(kp.public, kp.private)

    def _persist(self, public, private) -> None:
        self._db.execute(
            "INSERT OR IGNORE INTO our_keys"
            " (fingerprint, scheme_id, public_key, private_key)"
            " VALUES (?,?,?,?)",
            (public.fingerprint(), public.scheme_id, public.data, private.data),
        )

    def fresh_key(self, scheme_id: int = schemes.DEFAULT_SCHEME):
        public = super().fresh_key(scheme_id)
        self._persist(public, self._keys[public])
        return public

    def register_keypair(self, kp: schemes.KeyPair) -> None:
        super().register_keypair(kp)
        self._persist(kp.public, kp.private)


# ---------------------------------------------------------------------------
# vault


class PersistentVaultService(VaultService):
    """NodeVaultService over sqlite: the in-memory maps stay (hot path
    for flows/coin-selection), every delta also lands in `vault_states`
    with denormalised query columns for vault_query.py. Soft-locks are
    deliberately NOT persisted: in-flight spends die with the process
    and their flows resume from checkpoints, which re-lock."""

    def __init__(self, services):
        super().__init__(services)
        self._db: NodeDatabase = services.db
        self._ensured_schemas: set[str] = set()
        for row in self._db.query(
            "SELECT ref_tx, ref_index, state, status FROM vault_states"
        ):
            ref = StateRef(SecureHash(bytes(row[0])), row[1])
            ts = ser.decode(bytes(row[2]))
            (self._unconsumed if row[3] == 0 else self._consumed)[ref] = ts
        # after the state load: table creation backfills from the maps
        self._ensure_schema_tables()
    def _ensure_schema_tables(self) -> None:
        """Create every registered MappedSchema's table (memoized).
        Runs at open AND before queries: cordapps may register schemas
        after the vault opened, and a custom-column query over a table
        no state ever populated must return empty, not crash."""
        from .schemas import registered_schemas

        missing = [
            s
            for s in registered_schemas()
            if s.name not in self._ensured_schemas
        ]
        if not missing:
            return
        with self._db.transaction() as conn:
            for schema in missing:
                conn.execute(schema.ddl())
                # backfill: states recorded before this schema was
                # registered (cordapp installed onto an existing node)
                # must project too, or the SQL and in-memory vaults
                # answer CustomColumnCriteria differently
                for ref, ts in list(self._unconsumed.items()) + list(
                    self._consumed.items()
                ):
                    if not isinstance(ts.data, schema.applies_to):
                        continue
                    values = schema.row_values(ts.data)
                    marks = ",".join("?" * (2 + len(values)))
                    conn.execute(
                        f"INSERT OR REPLACE INTO {schema.table} VALUES"
                        f" ({marks})",
                        (ref.txhash.bytes_, ref.index, *values),
                    )
        # memoize only after the transaction committed: a rolled-back
        # CREATE TABLE must not leave the schema marked as ensured
        for schema in missing:
            self._ensured_schemas.add(schema.name)

    def query_by(self, criteria, paging=None, sorting=None):
        """Same criteria AST as the in-memory vault, compiled to SQL
        over vault_states (the HibernateQueryCriteriaParser role)."""
        from .vault_query import PageSpecification, Sort, run_sql

        self._ensure_schema_tables()
        return run_sql(
            self._db,
            criteria,
            paging or PageSpecification(),
            sorting or Sort(),
        )

    def _on_delta(self, update) -> None:
        """Persist one vault delta — O(tx size), not O(vault size). Runs
        before observers (base notify) so rows are on disk first; a
        failure here aborts the surrounding record transaction."""
        now = self._services.clock.now_micros()
        with self._db.transaction() as conn:
            for sar in update.consumed:
                conn.execute(
                    "UPDATE vault_states SET status=1, consumed_at=?"
                    " WHERE ref_tx=? AND ref_index=?",
                    (now, sar.ref.txhash.bytes_, sar.ref.index),
                )
            for sar in update.produced:
                # single source of truth for the schema projection:
                # vault_query.row_of — the in-memory query path uses the
                # same function, so both backends answer identically
                from .vault_query import UNCONSUMED, row_of

                row = row_of(sar, UNCONSUMED, now)
                ref, ts = sar.ref, sar.state
                conn.execute(
                    "INSERT OR REPLACE INTO vault_states"
                    " (ref_tx, ref_index, state, contract_tag, status,"
                    "  notary, quantity, token, issuer, linear_id,"
                    "  recorded_at, consumed_at)"
                    " VALUES (?,?,?,?,0,?,?,?,?,?,?,NULL)",
                    (
                        ref.txhash.bytes_,
                        ref.index,
                        ser.encode(ts),
                        row.contract_tag,
                        row.notary_name,
                        row.quantity,
                        row.product,
                        row.issuer_name,
                        row.linear_id,
                        now,
                    ),
                )
                for fp in row.participant_fps:
                    conn.execute(
                        "INSERT INTO vault_parts"
                        " (ref_tx, ref_index, fingerprint) VALUES (?,?,?)",
                        (ref.txhash.bytes_, ref.index, fp),
                    )
                # CorDapp-registered schema projections (the
                # HibernateObserver role, node/.../services/schema/):
                # one row per applying MappedSchema, in ITS table,
                # within the same delta transaction
                from .schemas import schemas_for

                for schema in schemas_for(ts.data):
                    if schema.name not in self._ensured_schemas:
                        conn.execute(schema.ddl())
                        self._ensured_schemas.add(schema.name)
                    values = schema.row_values(ts.data)
                    marks = ",".join("?" * (2 + len(values)))
                    conn.execute(
                        f"INSERT OR REPLACE INTO {schema.table} VALUES"
                        f" ({marks})",
                        (ref.txhash.bytes_, ref.index, *values),
                    )


# ---------------------------------------------------------------------------
# assembly


class PersistentServiceHub:
    """Builds a ServiceHub whose stores are all sqlite-backed — the
    Phase-3 node's storage plane (reference: AbstractNode.
    initialiseDatabasePersistence + makeServices, AbstractNode.kt:
    412-423,538). Constructed via `open()` so callers get the same
    ServiceHub type flows already talk to."""

    @staticmethod
    def open(
        path: str,
        my_info,
        identity,
        *initial_keys: schemes.KeyPair,
        network_map_cache=None,
        clock=None,
        batch_verifier=None,
        rng=None,
        db=None,
    ):
        """Pass `db` to share one NodeDatabase with other subsystems
        (the fabric journals live in the same file, so one sqlite tx
        can span a handler's effects and its message acks)."""
        from .services import ServiceHub

        if db is None:
            db = NodeDatabase(path)
        key_management = PersistentKeyManagementService(
            db, *initial_keys, rng=rng
        )
        return ServiceHub(
            my_info,
            key_management,
            identity,
            network_map_cache=network_map_cache,
            clock=clock,
            batch_verifier=batch_verifier,
            db=db,
            validated_transactions=PersistentTransactionStorage(db),
            attachments=PersistentAttachmentStorage(db),
            checkpoint_storage=PersistentCheckpointStorage(db),
            vault_factory=PersistentVaultService,
        )

