"""Fsync'd append-only controller journal with per-record CRCs.

Counterpart of ``src/repro/resilience/journal.py`` (standard library and the
port's own :mod:`~repro_torch.resilience.integrity` and :mod:`~repro_torch.obs`):
the same file format, so a journal written by either package replays in the
other, and the same appends give byte-identical files.

The continuous controller (:mod:`repro_torch.launch.continuous_vi`) journals
every transition of its version lineage (which rows are folded into which
persisted :class:`~repro_torch.online.FitState`, which versions were staged
and activated) durably *before* its effects matter, so a restarted
controller replays the record stream and resumes exactly where the dead
process stopped: re-load the last-good state checkpoint it names, re-fold
only rows past it (bit-exact under the ``gram_accumulate`` carry-in
contract), re-stage anything that was in flight.

Format: one JSON object per line, ``{"seq": N, "kind": ..., **fields,
"crc": "crc32:..."}`` where the CRC covers the record serialized *without*
its own crc field (``json.dumps(body, sort_keys=True)``).  Appends write +
flush + fsync before returning: a record that :meth:`Journal.append`
returned for is durable.

Crash semantics on replay:

* a **torn tail** (partial last line, no trailing newline, half-written
  JSON, bad CRC on the final record) is exactly what a crash mid-append
  leaves behind: it is dropped silently (and truncated when the journal is
  opened) and recovery proceeds from the previous record;
* a bad CRC / unparsable line **before** the tail is not a crash artifact,
  it is corruption of committed history: that raises :class:`JournalError`
  (an :class:`~repro_torch.resilience.integrity.IntegrityError`) naming the
  file and line rather than resuming from a lie.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Sequence

from .. import obs
from .integrity import IntegrityError, checksum_bytes


class JournalError(IntegrityError):
    """Committed journal history failed verification."""


def _record_crc(rec: Dict) -> str:
    body = {k: v for k, v in rec.items() if k != "crc"}
    return checksum_bytes(json.dumps(body, sort_keys=True).encode())


class Journal:
    """Append-only journal at ``path`` (created on first append)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._seq = 0
        self._lock = threading.Lock()  # ingest + controller threads both append
        # resume the sequence counter past existing committed records, and
        # truncate any torn tail NOW: appending after an uncommitted partial
        # record would bury it mid-history, turning a benign crash artifact
        # into (apparent) corruption of committed lineage on the next replay
        if os.path.exists(path):
            records, committed = self._scan()
            if committed < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(committed)
            if records:
                self._seq = records[-1]["seq"] + 1

    # -- writing ------------------------------------------------------------

    def append(self, kind: str, **fields) -> Dict:
        """Durably append one record; returns it (with seq + crc).
        Thread-safe: concurrent appenders serialize, records never interleave."""
        with self._lock:
            rec = {"seq": self._seq, "kind": kind, **fields}
            rec["crc"] = _record_crc(rec)
            if self._fh is None:
                os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                self._fh = open(self.path, "a")
            self._fh.write(json.dumps(rec, sort_keys=True) + "\n")
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._seq += 1
            obs.registry().counter("journal.appends", kind=kind).inc()
            return rec

    def compact(
        self,
        anchor_kind: str = "activated",
        keep_kinds: Sequence[str] = ("base_fitted",),
    ) -> int:
        """Drop committed history older than the newest ``anchor_kind`` record.

        Keeps the newest ``anchor_kind`` record and everything after it, plus
        (for each kind in ``keep_kinds``) the newest earlier record of that
        kind — by default the last ``base_fitted``, which the continuous
        controller's resume gate reads via :meth:`last`.  Records keep their
        original ``seq`` and CRC (both cover only the record body, which is
        unchanged), so replay semantics and :meth:`last` lookups are
        indistinguishable from the uncompacted journal for every surviving
        kind.

        The rewrite is crash-safe: surviving records are CRC-re-verified and
        written to ``<path>.tmp``, fsync'd, then renamed over the journal
        (plus a directory fsync) — a crash mid-compact leaves either the old
        or the new journal, never a torn mix.  Returns the number of records
        dropped (0 when there is no anchor or nothing precedes it).
        """
        with self._lock:
            records, _ = self._scan()
            cut = 0
            for i, rec in enumerate(records):
                if rec["kind"] == anchor_kind:
                    cut = i
            prefix: List[Dict] = []
            for kind in keep_kinds:
                newest = None
                for rec in records[:cut]:
                    if rec["kind"] == kind:
                        newest = rec
                if newest is not None:
                    prefix.append(newest)
            prefix.sort(key=lambda r: r["seq"])
            kept = prefix + records[cut:]
            dropped = len(records) - len(kept)
            if dropped <= 0:
                return 0
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                for rec in kept:
                    if rec.get("crc") != _record_crc(rec):
                        raise JournalError(
                            f"{self.path}: record seq={rec.get('seq')} failed CRC "
                            "re-verification during compaction; aborting rewrite",
                            path=self.path,
                        )
                    f.write(json.dumps(rec, sort_keys=True) + "\n")
                f.flush()
                os.fsync(f.fileno())
            if self._fh is not None:
                self._fh.close()
                self._fh = None  # reopened lazily by the next append
            os.replace(tmp, self.path)
            dirfd = os.open(os.path.dirname(self.path) or ".", os.O_RDONLY)
            try:
                os.fsync(dirfd)
            finally:
                os.close(dirfd)
            obs.event("journal/compact", dropped=dropped, kept=len(kept))
            return dropped

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "Journal":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- reading ------------------------------------------------------------

    def replay(self) -> List[Dict]:
        """All committed records, oldest first (torn tail dropped)."""
        return self._scan()[0]

    def _scan(self) -> "tuple[List[Dict], int]":
        """(committed records, byte length of the committed prefix)."""
        if not os.path.exists(self.path):
            return [], 0
        with open(self.path, "rb") as f:
            raw = f.read()
        lines = raw.split(b"\n")
        # anything after the last newline is an in-flight append at crash time
        tail_torn = bool(lines and lines[-1] != b"")
        body = lines[:-1]
        records: List[Dict] = []
        committed = offset = 0
        for i, line in enumerate(body):
            end = offset + len(line) + 1  # +1: the newline
            if not line.strip():
                offset = committed = end
                continue
            is_tail = not tail_torn and i == len(body) - 1
            rec = self._parse(line, i, is_tail=is_tail)
            if rec is None:
                break  # verified-bad final record: crash mid-fsync, drop it
            records.append(rec)
            offset = committed = end
        return records, committed

    def _parse(self, line: bytes, lineno: int, is_tail: bool) -> Optional[Dict]:
        try:
            rec = json.loads(line)
            ok = isinstance(rec, dict) and rec.get("crc") == _record_crc(rec)
        except (json.JSONDecodeError, TypeError):
            rec, ok = None, False
        if ok:
            return rec
        if is_tail:
            return None
        raise JournalError(
            f"{self.path}: journal record at line {lineno + 1} failed CRC "
            "verification mid-history — committed records were corrupted "
            "(not a torn tail); refusing to resume from damaged lineage",
            path=self.path,
        )

    def last(self, kind: str) -> Optional[Dict]:
        """Newest committed record of ``kind`` (None when absent)."""
        for rec in reversed(self.replay()):
            if rec["kind"] == kind:
                return rec
        return None
