"""Chunked data sources for out-of-core OAVI.

A copy of the JAX package's ``repro.streaming.source`` (numpy and the
standard library only), on the port's own
:mod:`repro_torch.resilience.integrity`; the tests hold the two equal.

A :class:`DataSource` exposes random-access row reads over a dataset whose
rows may live anywhere — an in-memory array, a directory of memory-mapped
``.npy`` shards (written by :func:`repro_torch.data.synthetic.write_shards`), or a
deterministic generator that synthesizes rows on demand.  The streaming fit
(:mod:`repro_torch.streaming.fit`) only ever touches a source through
:func:`iter_chunks`, which yields fixed-size power-of-two row chunks (the
trailing chunk zero-padded with its valid-row count), so device buffers stay
O(chunk) no matter how large ``num_rows`` is.

All sources yield *raw* rows; compose with :class:`ScaledSource` (wrapping a
fitted :class:`repro_torch.core.transform.MinMaxScaler` or its streaming twin) to
feed the fit the ``[0, 1]^n`` data OAVI expects.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Iterator, Optional, Protocol, Set, Tuple, runtime_checkable

import numpy as np

from ..resilience.integrity import IntegrityError, verify_file

SHARD_FORMAT = "repro.shards.v1"
SHARD_META = "meta.json"


def _npy_rows(fname: str) -> int:
    """Row count of a ``.npy`` file from its header alone (mmap: no data
    is actually read).  A zero-length or header-mangled file — the residue
    of a torn write — raises :class:`IntegrityError` naming it instead of
    whatever parse error numpy hits first."""
    if os.path.getsize(fname) == 0:
        raise IntegrityError(
            f"{fname}: zero-length shard file (torn write?)", path=fname
        )
    try:
        arr = np.load(fname, mmap_mode="r")
    except Exception as e:
        # np.load surfaces header damage as ValueError/OSError/EOFError but
        # also as SyntaxError/TokenError out of its header ast parse — any
        # failure to read an existing non-empty .npy file is corruption
        raise IntegrityError(
            f"{fname}: unreadable shard file ({e}) — torn or corrupt write",
            path=fname,
        ) from e
    return int(arr.shape[0]) if arr.ndim else 0


@runtime_checkable
class DataSource(Protocol):
    """Random-access row reads; the whole streaming subsystem's data contract."""

    num_rows: int
    num_features: int

    def read(self, start: int, stop: int) -> np.ndarray:
        """Rows ``[start, stop)`` as a ``(stop - start, num_features)`` array."""
        ...


def is_source(obj) -> bool:
    """Duck-typed source check (used by :func:`repro_torch.api.fit` dispatch)."""
    return (
        hasattr(obj, "read")
        and hasattr(obj, "num_rows")
        and hasattr(obj, "num_features")
    )


def as_source(obj) -> DataSource:
    """Pass sources through; wrap array-likes in :class:`ArraySource`."""
    if is_source(obj):
        return obj
    return ArraySource(np.asarray(obj))


def iter_chunks(
    source: DataSource,
    chunk_rows: int,
    start: int = 0,
    stop: Optional[int] = None,
) -> Iterator[Tuple[np.ndarray, int]]:
    """Fixed-size chunks over ``source`` rows ``[start, stop)``.

    Yields ``(chunk, valid)`` where ``chunk`` is always exactly
    ``(chunk_rows, n)`` — the trailing chunk is zero-padded — and ``valid``
    is the number of real rows in it.  Zero padding composes with the
    blocked Gram reduction as a bitwise no-op (see
    :func:`repro_torch.kernels.ops.gram_accumulate`).
    """
    stop = source.num_rows if stop is None else stop
    n = source.num_features
    for lo in range(start, stop, chunk_rows):
        hi = min(lo + chunk_rows, stop)
        rows = source.read(lo, hi)
        valid = hi - lo
        if valid < chunk_rows:
            padded = np.zeros((chunk_rows, n), rows.dtype)
            padded[:valid] = rows
            rows = padded
        yield rows, valid


class ArraySource:
    """In-memory array as a source (views, no copies)."""

    def __init__(self, X):
        self.X = np.asarray(X)
        if self.X.ndim != 2:
            raise ValueError(f"expected (m, n) data, got shape {self.X.shape}")
        self.num_rows = int(self.X.shape[0])
        self.num_features = int(self.X.shape[1])

    def read(self, start: int, stop: int) -> np.ndarray:
        return self.X[start:stop]


class ShardDirSource:
    """A directory of ``shard_%05d.npy`` files + ``meta.json``, opened with
    ``mmap_mode='r'`` so reads touch only the requested rows — the on-disk
    layout written by :func:`repro_torch.data.synthetic.write_shards`.

    The directory may *grow* while the source is open
    (``write_shards(..., append=True)`` adds shard files and then atomically
    rewrites ``meta.json``): :meth:`refresh` re-reads the metadata and picks
    up the new rows in place, validating that every shard file the new
    metadata promises actually exists with the advertised row count — a
    partial write (shards without a committed meta, or a meta naming missing
    shards) fails loudly instead of serving truncated data.

    **Content integrity**: ``meta.json`` written by current ``write_shards``
    carries a CRC32 + byte length per shard; with ``verify_checksums=True``
    (the default) each shard file is verified against them once, right
    before its first rows are served — a flipped bit or truncation raises
    :class:`~repro_torch.resilience.integrity.IntegrityError` naming the file.
    Lazy (first-read) verification keeps opening a huge directory O(1);
    :meth:`verify_all` forces the full pass (operator audit).  Shards whose recorded checksum is ``None`` (pre-checksum
    directories) are tolerated unverified.
    """

    def __init__(self, path: str, verify_checksums: bool = True):
        self.path = path
        self.verify_checksums = verify_checksums
        self._mmaps: Dict[int, np.ndarray] = {}
        self._verified: Set[int] = set()
        self._load_meta(validate=True)

    def _load_meta(self, validate: bool) -> None:
        with open(os.path.join(self.path, SHARD_META)) as f:
            meta = json.load(f)
        if meta.get("format") != SHARD_FORMAT:
            raise ValueError(
                f"{self.path!r} is not a {SHARD_FORMAT} shard directory "
                f"(format={meta.get('format')!r})"
            )
        self.meta: Dict = meta
        self.num_rows = int(meta["num_rows"])
        self.num_features = int(meta["num_features"])
        self.shard_rows = int(meta["shard_rows"])
        self.num_shards = int(meta["num_shards"])
        self.checksums = list(meta.get("checksums") or [])
        self.shard_bytes = list(meta.get("shard_bytes") or [])
        if validate:
            self._validate_meta()

    def _validate_meta(self) -> None:
        """meta.json row-count consistency: every promised shard exists and
        the per-shard row counts add up to ``num_rows`` (all shards full
        except possibly the last)."""
        expect_shards = max(
            (self.num_rows + self.shard_rows - 1) // self.shard_rows, 1
        )
        if self.num_shards != expect_shards:
            raise ValueError(
                f"{self.path!r}: meta.json is inconsistent — num_shards="
                f"{self.num_shards} but num_rows={self.num_rows} at "
                f"shard_rows={self.shard_rows} needs {expect_shards} shards "
                "(partial write?)"
            )
        total = 0
        for idx in range(self.num_shards):
            fname = os.path.join(self.path, f"shard_{idx:05d}.npy")
            if not os.path.exists(fname):
                raise ValueError(
                    f"{self.path!r}: meta.json promises shard_{idx:05d}.npy "
                    "but the file is missing (partial write?)"
                )
            rows = _npy_rows(fname)
            expect = min(self.shard_rows, self.num_rows - idx * self.shard_rows)
            if rows < expect:
                raise ValueError(
                    f"{self.path!r}: shard_{idx:05d}.npy has {rows} rows, "
                    f"meta.json needs {expect} (partial write?)"
                )
            total += min(rows, expect)
        if total != self.num_rows:
            raise ValueError(
                f"{self.path!r}: shard files cover {total} rows, meta.json "
                f"says num_rows={self.num_rows} (partial write?)"
            )

    def refresh(self) -> int:
        """Re-read ``meta.json`` and pick up rows appended since the source
        was opened (no re-open needed: existing shard mmaps stay valid, new
        ``shard_%05d.npy`` files are mapped on first read).  Returns the
        number of new rows.  A shard that grew in place (the previously-last,
        partial shard rewritten fuller) is remapped."""
        old_rows, old_shards = self.num_rows, self.num_shards
        self._load_meta(validate=True)
        if self.num_rows < old_rows:
            raise ValueError(
                f"{self.path!r}: refresh() saw num_rows shrink "
                f"{old_rows} -> {self.num_rows}; shard dirs may only grow"
            )
        # the old trailing shard may have been rewritten with more rows
        # (append into a partial shard): drop its cached mmap and its
        # verified mark — the rewritten file has a new checksum
        if self.num_rows > old_rows and old_shards >= 1:
            self._mmaps.pop(old_shards - 1, None)
            self._verified.discard(old_shards - 1)
        return self.num_rows - old_rows

    def _verify_shard(self, idx: int) -> None:
        """Checksum-verify shard ``idx`` once, before its rows are served.
        No-op when disabled, already verified, or unrecorded (None entry)."""
        if not self.verify_checksums or idx in self._verified:
            return
        expected = self.checksums[idx] if idx < len(self.checksums) else None
        if expected is not None:
            nbytes = self.shard_bytes[idx] if idx < len(self.shard_bytes) else None
            verify_file(
                os.path.join(self.path, f"shard_{idx:05d}.npy"), expected, nbytes
            )
        self._verified.add(idx)

    def verify_all(self) -> int:
        """Checksum-verify every shard now (full data read); returns the
        number of shards with recorded checksums that were checked."""
        checked = 0
        for idx in range(self.num_shards):
            had = idx < len(self.checksums) and self.checksums[idx] is not None
            self._verify_shard(idx)
            checked += int(had)
        return checked

    def _shard(self, idx: int) -> np.ndarray:
        mm = self._mmaps.get(idx)
        if mm is None:
            self._verify_shard(idx)
            fname = os.path.join(self.path, f"shard_{idx:05d}.npy")
            mm = np.load(fname, mmap_mode="r")
            self._mmaps[idx] = mm
        return mm

    def read(self, start: int, stop: int) -> np.ndarray:
        if not (0 <= start <= stop <= self.num_rows):
            raise IndexError(f"rows [{start}, {stop}) out of range {self.num_rows}")
        out = np.empty((stop - start, self.num_features), np.dtype(self.meta["dtype"]))
        pos = start
        while pos < stop:
            idx = pos // self.shard_rows
            lo = pos - idx * self.shard_rows
            hi = min(self.shard_rows, lo + (stop - pos))
            out[pos - start : pos - start + hi - lo] = self._shard(idx)[lo:hi]
            pos += hi - lo
        return out


class SyntheticSource:
    """Generator-backed source: rows are synthesized on demand from a
    deterministic per-tile generator, so arbitrarily large datasets occupy no
    storage at all.

    ``tile_fn(tile_idx)`` must return the full ``(tile_rows, n)`` tile for
    its index, deterministically — reads slice tiles, so any chunking of the
    row range sees the identical values (the chunk-size-invariance the
    bit-exactness guarantees rest on).  The last produced tile is cached,
    which makes sequential chunk scans at any ``chunk_rows <= tile_rows`` (or
    multiples) cheap.
    """

    def __init__(
        self,
        tile_fn: Callable[[int], np.ndarray],
        num_rows: int,
        num_features: int,
        tile_rows: int = 4096,
    ):
        self.tile_fn = tile_fn
        self.num_rows = int(num_rows)
        self.num_features = int(num_features)
        self.tile_rows = int(tile_rows)
        self._cache: Optional[Tuple[int, np.ndarray]] = None

    def _tile(self, idx: int) -> np.ndarray:
        if self._cache is not None and self._cache[0] == idx:
            return self._cache[1]
        tile = np.asarray(self.tile_fn(idx))
        if tile.shape != (self.tile_rows, self.num_features):
            raise ValueError(
                f"tile_fn({idx}) returned shape {tile.shape}, expected "
                f"({self.tile_rows}, {self.num_features})"
            )
        self._cache = (idx, tile)
        return tile

    def read(self, start: int, stop: int) -> np.ndarray:
        if not (0 <= start <= stop <= self.num_rows):
            raise IndexError(f"rows [{start}, {stop}) out of range {self.num_rows}")
        parts = []
        pos = start
        while pos < stop:
            idx = pos // self.tile_rows
            lo = pos - idx * self.tile_rows
            hi = min(self.tile_rows, lo + (stop - pos))
            parts.append(self._tile(idx)[lo:hi])
            pos += hi - lo
        if len(parts) == 1:
            return parts[0]
        return np.concatenate(parts, axis=0)


class ScaledSource:
    """A source composed with a fitted min-max scaler: reads are transformed
    chunk-by-chunk.  The transform is elementwise, so the scaled stream is
    bit-identical to scaling the materialized array."""

    def __init__(self, source: DataSource, scaler):
        if scaler.lo is None or scaler.scale is None:
            raise ValueError(
                "ScaledSource needs a *fitted* scaler; fit it first (e.g. "
                "StreamingMinMaxScaler.fit_source)"
            )
        self.source = as_source(source)
        self.scaler = scaler

    # delegate, don't cache: a growing wrapped source (ShardDirSource after
    # refresh()) must propagate its new row count through the wrapper
    @property
    def num_rows(self) -> int:
        return self.source.num_rows

    @property
    def num_features(self) -> int:
        return self.source.num_features

    def read(self, start: int, stop: int) -> np.ndarray:
        return self.scaler.transform(self.source.read(start, stop))
