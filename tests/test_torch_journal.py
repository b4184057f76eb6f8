"""The port's controller journal (``repro_torch.resilience.journal``).

The reference's journal cases (``tests/test_resilience.py``: round trip and
sequence resume, torn tail dropped, mid-history corruption raises,
concurrent appends never interleave) and compaction cases
(``tests/test_obs.py``) on the port, and across packages: the same appends
from either package give byte-identical files, and each package replays the
other's journal.
"""

import threading

import pytest

from repro.resilience import journal as j_journal
from repro_torch import obs
from repro_torch.resilience import IntegrityError, Journal, JournalError


def test_journal_roundtrip_and_seq_resume(tmp_path):
    p = str(tmp_path / "j.jsonl")
    with Journal(p) as j:
        j.append("update_start", update=0, rows=100)
        j.append("state_saved", update=0, step=1)
    j2 = Journal(p)  # re-open: seq continues past committed records
    rec = j2.append("activated", update=0, version=2)
    assert rec["seq"] == 2
    assert [r["kind"] for r in j2.replay()] == ["update_start", "state_saved", "activated"]
    assert j2.last("state_saved")["step"] == 1
    assert j2.last("nonexistent") is None
    j2.close()


def test_journal_torn_tail_dropped(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = Journal(p)
    for i in range(3):
        j.append("tick", i=i)
    j.close()
    # (a) half-written line, no newline: a crash mid-append
    with open(p, "a") as f:
        f.write('{"seq": 3, "kind": "tick", "i"')
    assert [r["i"] for r in Journal(p).replay()] == [0, 1, 2]
    # (b) complete final line with a bad CRC: a crash mid-fsync
    with open(p, "w"):
        pass
    j = Journal(p)
    for i in range(3):
        j.append("tick", i=i)
    j.close()
    with open(p, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    bad = lines[-1].replace(b'"crc": "crc32:', b'"crc": "crc32:f', 1)
    with open(p, "wb") as f:
        f.writelines(lines[:-1] + [bad])
    assert [r["i"] for r in Journal(p).replay()] == [0, 1]
    # appends after a torn tail keep the committed lineage intact
    j = Journal(p)
    j.append("tick", i=99)
    assert [r["i"] for r in j.replay()] == [0, 1, 99]
    j.close()


def test_journal_midhistory_corruption_raises(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = Journal(p)
    for i in range(4):
        j.append("tick", i=i)
    j.close()
    with open(p, "rb") as f:
        lines = f.read().splitlines(keepends=True)
    lines[1] = lines[1].replace(b'"i": 1', b'"i": 7')  # a committed record lies
    with open(p, "wb") as f:
        f.writelines(lines)
    with pytest.raises(JournalError, match="mid-history") as err:
        Journal(p).replay()
    assert isinstance(err.value, IntegrityError) and err.value.path == p


def test_journal_concurrent_appends_never_interleave(tmp_path):
    p = str(tmp_path / "j.jsonl")
    j = Journal(p)

    def writer(tid):
        for i in range(20):
            j.append("w", tid=tid, i=i)

    ts = [threading.Thread(target=writer, args=(t,)) for t in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    j.close()
    records = Journal(p).replay()
    assert len(records) == 80
    assert [r["seq"] for r in records] == list(range(80))


# ---------------------------------------------------------------------------
# compaction


def _fill_journal(j):
    j.append("base_fitted", version=0)
    j.append("increment", update=1)
    j.append("refit", update=1)
    j.append("activated", version=1, update=1)
    j.append("increment", update=2)
    j.append("refit", update=2)
    j.append("activated", version=2, update=2)
    j.append("increment", update=3)


def test_journal_compact_keeps_resume_state(tmp_path):
    path = str(tmp_path / "run.journal")
    with Journal(path) as j:
        _fill_journal(j)
        assert j.compact() == 5
        # the last activation and everything after it survive, plus the
        # newest base_fitted record the resume gate reads
        assert [r["kind"] for r in j.replay()] == ["base_fitted", "activated", "increment"]
        assert j.last("activated")["version"] == 2
        assert j.last("base_fitted")["version"] == 0
        rec = j.append("refit", update=3)
        assert rec["seq"] > j.last("activated")["seq"]
    with Journal(path) as j2:
        assert [r["kind"] for r in j2.replay()] == [
            "base_fitted", "activated", "increment", "refit"]


def test_journal_compact_noop_cases(tmp_path):
    with Journal(str(tmp_path / "empty.journal")) as j:
        assert j.compact() == 0
    with Journal(str(tmp_path / "no-anchor.journal")) as j:
        j.append("base_fitted", version=0)
        j.append("increment", update=1)
        assert j.compact() == 0  # nothing to cut before: no anchor record
        assert len(j.replay()) == 2


def test_journal_compact_idempotent(tmp_path):
    with Journal(str(tmp_path / "twice.journal")) as j:
        _fill_journal(j)
        assert j.compact() > 0
        assert j.compact() == 0
        assert [r["kind"] for r in j.replay()] == ["base_fitted", "activated", "increment"]


def test_journal_compact_preserves_crc_integrity(tmp_path):
    path = str(tmp_path / "crc.journal")
    with Journal(path) as j:
        _fill_journal(j)
        j.compact()
    with Journal(path) as j2:  # every surviving line still verifies
        assert all(rec["crc"] for rec in j2.replay())


def test_journal_counts_appends_metric(tmp_path):
    before = obs.registry().counter("journal.appends", kind="activated").value
    with Journal(str(tmp_path / "m.journal")) as j:
        _fill_journal(j)
    assert obs.registry().counter("journal.appends", kind="activated").value - before == 2


# ---------------------------------------------------------------------------
# across packages


@pytest.mark.parametrize("compact", [False, True])
def test_journal_bytes_identical_across_packages(tmp_path, compact):
    files = {}
    for name, cls in (("port", Journal), ("reference", j_journal.Journal)):
        path = str(tmp_path / f"{name}.jsonl")
        with cls(path) as j:
            _fill_journal(j)
            j.append("ingested", batch=0, cum_rows=4096, note="ü")
            if compact:
                j.compact()
            j.append("done", rows=5120)
        with open(path, "rb") as f:
            files[name] = f.read()
    assert files["port"] == files["reference"]


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_replays_across_packages(tmp_path, writer):
    classes = {"port": Journal, "reference": j_journal.Journal}
    reader = "reference" if writer == "port" else "port"
    path = str(tmp_path / "j.jsonl")
    with classes[writer](path) as j:
        _fill_journal(j)
    with classes[reader](path) as j:
        assert [r["kind"] for r in j.replay()] == [
            "base_fitted", "increment", "refit", "activated", "increment", "refit",
            "activated", "increment"]
        assert j.append("done", rows=1)["seq"] == 8  # the sequence resumes
    with classes[writer](path) as j:
        assert j.last("done")["rows"] == 1
    # the other package's torn tail is dropped and truncated on open
    with open(path, "a") as f:
        f.write('{"seq": 9, "kind": "to')
    with classes[reader](path) as j:
        assert len(j.replay()) == 9
        assert j.append("tick")["seq"] == 9
    with classes[writer](path) as j:
        assert j.last("tick")["seq"] == 9
