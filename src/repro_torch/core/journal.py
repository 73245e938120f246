"""OpJournal — write-ahead intent log for reconfiguration operations (a
copy of ``repro.core.journal``).

Every mutating manager op (attach / detach / pause / pause_live / unpause
/ migrate) follows the WAL discipline:

    entry = journal.begin(op, tenant, vf_id=..., ...)   # BEFORE any mutation
    ... mutate pool / tenant / records / snapshots ...
    journal.commit(entry)                               # AFTER the last one

A crash anywhere in between leaves a *pending* entry on disk;
``SVFFManager.recover`` reconciles each pending entry against the
surviving state (pool, guests, records, RAM snapshots) and either rolls
the op forward to completion or rolls it back, then resolves the entry.

Durability follows the same discipline as ``RecordStore``/
``CheckpointStore``: each entry is one JSON file written to ``*.part``,
flushed + fsync'd, then atomically renamed into place; status changes
(pending -> committed | aborted) rewrite the file the same way, so a
crash mid-write can at worst leave a ``*.part`` file (ignored on read,
swept by recovery) — never a torn entry.
"""
from __future__ import annotations

import copy
import json
import os
from typing import Optional

PENDING = "pending"
COMMITTED = "committed"
ABORTED = "aborted"

#: canonical catalogue of journaled ops -> the tenant status a COMMITTED
#: entry implies. Single source of truth for recovery and the journal
#: replay of invariant I8.
COMPLETED_STATUS = {"attach": "running", "detach": "detached",
                    "pause": "paused", "pause_live": "paused",
                    "unpause": "running", "migrate": "running",
                    # request-granular live migration: the SOURCE tenant
                    # (the journaled tenant) keeps serving its batch, so a
                    # committed entry still implies "running"
                    "migrate_request": "running",
                    # gang ops: the journaled tenant is the gang LEAD; its
                    # shell members journal their own attach/detach entries
                    # inside the gang window, and a reshape leaves the lead
                    # serving throughout
                    "attach_group": "running",
                    "detach_group": "detached",
                    "reshape": "running"}

#: ops recovery knows how to reconcile (and I8 knows how to replay)
JOURNALED_OPS = tuple(COMPLETED_STATUS)


class JournalError(RuntimeError):
    pass


def _fsync_dir(path: str) -> None:
    """Make a rename durable (no-op on platforms without dir fsync)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class OpJournal:
    def __init__(self, directory: str, *,
                 compact_every: Optional[int] = None,
                 compact_keep: int = 32):
        """``compact_every``: auto-compaction threshold — whenever the
        number of RESOLVED entries on disk reaches it, ``compact`` runs
        with ``keep=compact_keep`` (newest resolved entries retained, so
        the I8 replay still sees every tenant's latest committed op).
        ``None`` (the default) keeps the pre-federation behaviour:
        compaction is an explicit operator action only. Long federation
        runs pass ``compact_every`` so the WAL stays bounded."""
        self.dir = directory
        if compact_every is not None and compact_every < 1:
            raise ValueError(f"compact_every must be >= 1, "
                             f"got {compact_every}")
        self.compact_every = compact_every
        self.compact_keep = compact_keep
        os.makedirs(directory, exist_ok=True)
        self._seq = self._max_seq()
        # entry cache: the invariant checker replays the journal after
        # every op — without this, each check re-reads every entry file.
        # The files stay the source of truth (a fresh OpJournal over the
        # same dir reloads them); the cache only assumes no SECOND writer
        # mutates the directory behind this instance's back.
        self._cache: Optional[dict[int, dict]] = None

    # ------------------------------------------------------------------ files
    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"op_{seq:08d}.json")

    def _max_seq(self) -> int:
        mx = 0
        for fn in os.listdir(self.dir):
            if fn.startswith("op_") and fn.endswith(".json"):
                try:
                    mx = max(mx, int(fn[3:-5]))
                except ValueError:
                    pass
        return mx

    def _load(self) -> dict[int, dict]:
        if self._cache is None:
            cache: dict[int, dict] = {}
            for fn in sorted(os.listdir(self.dir)):
                if fn.startswith("op_") and fn.endswith(".json"):
                    with open(os.path.join(self.dir, fn)) as f:
                        e = json.load(f)
                    cache[e["seq"]] = e
            self._cache = cache
        return self._cache

    def _write(self, entry: dict) -> None:
        p = self._path(entry["seq"])
        tmp = p + ".part"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, p)
        _fsync_dir(self.dir)
        self._load()[entry["seq"]] = copy.deepcopy(entry)

    # ------------------------------------------------------------------ WAL
    def begin(self, op: str, tenant: str,
              vf_id: Optional[str] = None, **details) -> int:
        """Log the intent to run ``op`` on ``tenant``; returns the entry
        seq. Must be called after validation but BEFORE the first
        mutation, so a rejected op never leaves a pending entry."""
        if op not in JOURNALED_OPS:
            raise JournalError(f"unknown journaled op {op!r}")
        self._seq += 1
        entry = {"seq": self._seq, "op": op, "tenant": tenant,
                 "vf_id": vf_id, "status": PENDING, "details": details}
        self._write(entry)
        return self._seq

    def _resolve(self, seq: int, status: str, **extra) -> None:
        entry = self.read(seq)
        if entry["status"] != PENDING:
            raise JournalError(
                f"entry {seq} already {entry['status']}, cannot {status}")
        entry["status"] = status
        entry["details"].update(extra)
        self._write(entry)
        if self.compact_every is not None:
            resolved = sum(1 for e in self._load().values()
                           if e["status"] != PENDING)
            if resolved >= self.compact_every:
                self.compact(keep=self.compact_keep)

    def defer(self, seq: int, **extra) -> None:
        """Mark a PENDING entry as deferred (details updated, status kept
        pending): recovery could not resolve it — typically a cross-host
        migrate whose destination host is unreachable — and will retry on
        the next ``recover``. Idempotent: re-deferring with the same
        details never rewrites the file, so a double recovery stays a
        bit-identical no-op (I16)."""
        entry = self.read(seq)
        if entry["status"] != PENDING:
            raise JournalError(
                f"entry {seq} already {entry['status']}, cannot defer")
        if all(entry["details"].get(k) == v for k, v in extra.items()):
            return
        entry["details"].update(extra)
        self._write(entry)

    def commit(self, seq: int, **extra) -> None:
        self._resolve(seq, COMMITTED, **extra)

    def abort(self, seq: int, **extra) -> None:
        """Mark an entry rolled back (state returned to the pre-op one)."""
        self._resolve(seq, ABORTED, **extra)

    # ------------------------------------------------------------------ read
    def read(self, seq: int) -> dict:
        e = self._load().get(seq)
        if e is None:
            raise JournalError(f"no journal entry {seq}")
        return copy.deepcopy(e)

    def entries(self) -> list[dict]:
        """All entries in begin (seq) order; ``*.part`` files ignored.
        Returns defensive copies — use ``iter_entries`` in hot read-only
        paths (the invariant checker replays the journal after every op)."""
        return [copy.deepcopy(e) for e in self.iter_entries()]

    def iter_entries(self):
        """Entries in seq order WITHOUT copying — read-only: mutating a
        yielded dict corrupts the cache."""
        return sorted(self._load().values(), key=lambda e: e["seq"])

    def pending(self) -> list[dict]:
        return [copy.deepcopy(e) for e in self.iter_entries()
                if e["status"] == PENDING]

    def sweep_parts(self) -> int:
        """Remove torn ``*.part`` files left by a crash mid-write."""
        n = 0
        for fn in os.listdir(self.dir):
            if fn.endswith(".part"):
                os.remove(os.path.join(self.dir, fn))
                n += 1
        return n

    def compact(self, keep: int = 0) -> int:
        """Drop resolved entries (all but the newest ``keep``); pending
        entries are never dropped. Returns how many were removed.

        Triggered automatically only when ``compact_every`` was set (the
        federation's bounded-WAL mode); otherwise an explicit operator/
        offline action. Compaction drops an OLDEST-first prefix of the
        resolved entries, so whenever any entry of a tenant survives its
        NEWEST committed one survives — the I8 replay (which keys each
        tenant on its latest committed op) stays sound, merely vacuous
        for tenants whose entire history was dropped."""
        resolved = [e for e in self.entries() if e["status"] != PENDING]
        drop = resolved[:-keep] if keep else resolved
        for e in drop:
            os.remove(self._path(e["seq"]))
            self._load().pop(e["seq"], None)
        return len(drop)
