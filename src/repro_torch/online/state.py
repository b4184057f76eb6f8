"""Persisted fit state for incremental OAVI.

Counterpart of the JAX package's ``repro.online.state``, saved in its bytes:
a state saved by either package loads in the other.

The streaming fit's only O(m) work is folding row chunks into per-degree
Gram accumulators ``(accQL, accC) = (A^T B, B^T B)``; everything downstream
(the statistics-only degree step, the IHB factors) is m-independent.  Those
accumulators are additive over rows *and* bit-reproducible under the
:func:`repro_torch.kernels.ops.gram_accumulate` carry-in contract — its fp32
reduction runs strictly left-to-right over fixed :data:`GRAM_BLOCK`-row
blocks, so statistics over rows ``[0, r)`` extended with rows ``[r, m)``
equal a one-shot pass over ``[0, m)`` exactly, *provided* ``r`` sits on a
block boundary.  A :class:`FitState` therefore snapshots each degree's
accumulators over the block-aligned prefix ``aligned_rows = (m // B) * B``;
the (< B-row) unaligned tail is re-read from the source at update time.

A degree's snapshot is only reusable while the fit's decision history up to
that degree is unchanged: the term book is built prefix-append-only, so a
record is valid iff the stored book prefix of length ``ell`` (the |O| at
that degree's start) matches the book the new fit has built so far, at the
same capacities.  Once new data flips one accept/reject decision, that
degree and all later ones replay from row 0 — :mod:`repro_torch.online.update`
handles both cases degree by degree.

Serialized via :func:`repro_torch.api.save_state_dict` under the versioned
format tag :data:`FIT_STATE_FORMAT` (``repro.online_fit_state.v1``), through
the same atomic :mod:`repro_torch.checkpoint.store` manifest machinery as
models.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core import terms as terms_mod
from ..core.oavi import OAVIConfig
from ..core.oracles import OracleConfig

FIT_STATE_FORMAT = "repro.online_fit_state.v1"


# keys of the JAX package's OAVIConfig that the port's lacks, written with
# that package's defaults so that it reads the port's states
_REFERENCE_ONLY = {"tol_dependent": 1e-9, "kernel": "auto"}


def config_to_dict(config: OAVIConfig) -> Dict:
    """JSON-safe dict of an :class:`OAVIConfig` (nested solver included), in
    the JAX package's keys."""
    return {**dataclasses.asdict(config), **_REFERENCE_ONLY}


def config_from_dict(d: Dict) -> OAVIConfig:
    """The port's :class:`OAVIConfig` from either package's dict (keys the
    port does not have are dropped)."""
    known = {f.name for f in dataclasses.fields(OAVIConfig)}
    d = {k: v for k, v in d.items() if k in known}
    solver_keys = {f.name for f in dataclasses.fields(OracleConfig)}
    d["solver"] = OracleConfig(**{k: v for k, v in d["solver"].items() if k in solver_keys})
    return OAVIConfig(**d)


@dataclasses.dataclass
class DegreeRecord:
    """One degree's Gram statistics over the block-aligned row prefix.

    ``ell`` is |O| when the degree started (the occupied accQL rows), ``K``
    the border size; ``Lcap`` / ``Kcap`` the capacity buckets the
    accumulators were shaped with — all four must match for the record to be
    foldable (capacity changes the padding, and padded fp32 shapes are part
    of the bit contract).
    """

    degree: int
    ell: int
    K: int
    Lcap: int
    Kcap: int
    accQL: np.ndarray  # (Lcap, Kcap) fp32 = A^T B over rows [0, aligned_rows)
    accC: np.ndarray  # (Kcap, Kcap) fp32 = B^T B over rows [0, aligned_rows)


@dataclasses.dataclass
class FitState:
    """Everything an :func:`repro_torch.online.update` needs besides the source.

    ``book_parents`` / ``book_vars`` are the FINAL term book of the fit that
    produced this state; a :class:`DegreeRecord` for degree ``d`` validates
    against their length-``ell`` prefix.  ``moments`` is the float64 Pearson
    one-pass state ``(s1, s2)`` (present iff the config orders features), so
    an update folds only the new rows before re-deriving the permutation.
    ``scaler_lo`` / ``scaler_hi`` record the frozen min-max statistics the
    source was scaled with — reference material for drift monitoring; the
    update itself never rescales.  ``probe_first`` / ``probe_last`` are raw
    copies of rows ``0`` and ``num_rows - 1``: an update re-reads them to
    catch the unrecoverable error of feeding a source whose prefix is not
    the data this state accumulated.
    """

    n: int
    num_rows: int
    aligned_rows: int
    chunk_rows: int
    config: OAVIConfig
    book_parents: np.ndarray  # (L,) int32 — final book, prefix-validates records
    book_vars: np.ndarray  # (L,) int32
    records: List[DegreeRecord]
    feature_perm: Optional[np.ndarray] = None
    moments: Optional[Tuple[np.ndarray, np.ndarray]] = None  # (s1, s2) float64
    moment_rows: int = 0  # rows covered by ``moments`` (chunk-grid aligned)
    scaler_lo: Optional[np.ndarray] = None
    scaler_hi: Optional[np.ndarray] = None
    probe_first: Optional[np.ndarray] = None
    probe_last: Optional[np.ndarray] = None

    def record_for(self, degree: int) -> Optional[DegreeRecord]:
        for rec in self.records:
            if rec.degree == degree:
                return rec
        return None

    def record_matches(
        self, degree: int, book: terms_mod.TermBook, K: int, Lcap: int, Kcap: int
    ) -> Optional[DegreeRecord]:
        """The stored record for ``degree`` iff it was accumulated under the
        identical decision history (book prefix) and capacities — the exact
        condition under which folding new rows into it is bit-identical to a
        full pass.  The book is append-only, so a prefix match at length
        ``ell`` pins every prior degree's decisions."""
        rec = self.record_for(degree)
        if rec is None:
            return None
        ell = len(book)
        if (rec.ell, rec.K, rec.Lcap, rec.Kcap) != (ell, K, Lcap, Kcap):
            return None
        if not (
            np.array_equal(self.book_parents[:ell], np.asarray(book.parents))
            and np.array_equal(self.book_vars[:ell], np.asarray(book.vars))
        ):
            return None
        return rec

    # -- serialization ------------------------------------------------------

    def to_state_dict(self) -> Tuple[Dict[str, np.ndarray], Dict]:
        arrays: Dict[str, np.ndarray] = {
            "book_parents": np.asarray(self.book_parents, np.int32),
            "book_vars": np.asarray(self.book_vars, np.int32),
        }
        if self.feature_perm is not None:
            arrays["feature_perm"] = np.asarray(self.feature_perm, np.int64)
        if self.moments is not None:
            arrays["moment_s1"] = np.asarray(self.moments[0], np.float64)
            arrays["moment_s2"] = np.asarray(self.moments[1], np.float64)
        if self.scaler_lo is not None:
            arrays["scaler_lo"] = np.asarray(self.scaler_lo, np.float64)
        if self.scaler_hi is not None:
            arrays["scaler_hi"] = np.asarray(self.scaler_hi, np.float64)
        if self.probe_first is not None:
            arrays["probe_first"] = np.asarray(self.probe_first)
        if self.probe_last is not None:
            arrays["probe_last"] = np.asarray(self.probe_last)
        recs_meta = []
        for rec in self.records:
            arrays[f"deg{rec.degree:03d}_accQL"] = np.asarray(rec.accQL)
            arrays[f"deg{rec.degree:03d}_accC"] = np.asarray(rec.accC)
            recs_meta.append(
                {
                    "degree": rec.degree,
                    "ell": rec.ell,
                    "K": rec.K,
                    "Lcap": rec.Lcap,
                    "Kcap": rec.Kcap,
                }
            )
        meta = {
            "kind": "online_fit_state",
            "n": int(self.n),
            "num_rows": int(self.num_rows),
            "aligned_rows": int(self.aligned_rows),
            "chunk_rows": int(self.chunk_rows),
            "moment_rows": int(self.moment_rows),
            "config": config_to_dict(self.config),
            "records": recs_meta,
        }
        return arrays, meta

    @classmethod
    def from_state_dict(cls, arrays: Dict, meta: Dict) -> "FitState":
        records = [
            DegreeRecord(
                degree=int(r["degree"]),
                ell=int(r["ell"]),
                K=int(r["K"]),
                Lcap=int(r["Lcap"]),
                Kcap=int(r["Kcap"]),
                accQL=np.asarray(arrays[f"deg{int(r['degree']):03d}_accQL"]),
                accC=np.asarray(arrays[f"deg{int(r['degree']):03d}_accC"]),
            )
            for r in meta["records"]
        ]
        moments = None
        if "moment_s1" in arrays:
            moments = (
                np.asarray(arrays["moment_s1"]),
                np.asarray(arrays["moment_s2"]),
            )
        get = lambda k: np.asarray(arrays[k]) if k in arrays else None  # noqa: E731
        return cls(
            n=int(meta["n"]),
            num_rows=int(meta["num_rows"]),
            aligned_rows=int(meta["aligned_rows"]),
            chunk_rows=int(meta["chunk_rows"]),
            config=config_from_dict(meta["config"]),
            book_parents=np.asarray(arrays["book_parents"]),
            book_vars=np.asarray(arrays["book_vars"]),
            records=records,
            feature_perm=get("feature_perm"),
            moments=moments,
            moment_rows=int(meta.get("moment_rows", 0)),
            scaler_lo=get("scaler_lo"),
            scaler_hi=get("scaler_hi"),
            probe_first=get("probe_first"),
            probe_last=get("probe_last"),
        )

    def save(self, path: str, step: int = 0) -> str:
        """Persist atomically (committed checkpoint manifest) at ``path``.

        ``step`` versions successive snapshots inside one directory so a
        corrupted head (detected by the manifest-v2 leaf checksums) falls
        back to the previous committed state on :meth:`load`; pair with
        :func:`repro_torch.checkpoint.store.cleanup` to bound retention."""
        from .. import api

        arrays, meta = self.to_state_dict()
        return api.save_state_dict(path, arrays, meta, FIT_STATE_FORMAT, step=step)

    @classmethod
    def load(cls, path: str) -> "FitState":
        """Load the newest *verifiable* persisted state at ``path``: every
        Gram snapshot leaf is checksum-verified first, and a corrupt head
        checkpoint falls back to the newest older committed one (an
        :class:`~repro_torch.resilience.integrity.IntegrityError` naming the
        bad file propagates only when nothing under ``path`` verifies)."""
        from .. import api

        arrays, metadata = api.load_state_dict(path, FIT_STATE_FORMAT)
        return cls.from_state_dict(arrays, metadata["meta"])
