"""Datasets of the paper's experiments, for the port.

A copy of ``appendix_c``, ``uci_like``, ``multiclass_planted``,
``lognormal_sizes``, ``random_cube`` and ``train_test_split`` from the JAX
package's ``repro.data.synthetic`` (numpy only; the port imports nothing of
that package):

* :func:`appendix_c` — the paper's 2M-sample synthetic dataset, to its exact
  specification (Appendix C): class 1 satisfies ``x1^2 + 0.01 x2 + x3^2 = 1``,
  class 2 satisfies ``x1^2 + x3^2 = 1.3``, both perturbed by N(0, 0.05^2).
* :func:`uci_like` — datasets matching the (m, n, #classes) shapes of the
  paper's UCI table, with classes planted on distinct random algebraic sets.
* :func:`multiclass_planted`, :func:`lognormal_sizes` — k planted classes of
  given (lognormal-skewed) sizes: the multi-class fit benchmark's regime.
* :func:`random_cube` — uniform noise in [0,1]^n (Figure 1's setting).
* :func:`planted_stream_tile`, :func:`planted_source`, :func:`write_shards`
  — the out-of-core data: a tile-deterministic planted stream as a
  generator-backed source, and the ``.npy`` shard directory writer, with the
  reference's chaos sites ``shards.shard_written`` and ``shards.committed``.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

# (m, n, num_classes) of the paper's Table 2 datasets.
UCI_SHAPES: Dict[str, Tuple[int, int, int]] = {
    "bank": (1372, 4, 2),
    "credit": (30000, 22, 2),
    "htru": (17898, 8, 2),
    "seeds": (210, 7, 3),
    "skin": (245057, 3, 2),
    "spam": (4601, 57, 2),
}


def appendix_c(m: int = 2_000_000, seed: int = 0, noise: float = 0.05):
    """The paper's synthetic dataset (Appendix C).  Returns (X, y) raw
    (un-scaled); apply min-max scaling as the pipeline does."""
    rng = np.random.default_rng(seed)
    m1 = m // 2
    m2 = m - m1
    # class 1: x1^2 + 0.01 x2 + x3^2 - 1 = 0
    x2 = rng.uniform(0.0, 1.0, m1)
    theta = rng.uniform(0.0, 2.0 * np.pi, m1)
    r2 = np.maximum(1.0 - 0.01 * x2, 0.0)
    x1 = np.sqrt(r2) * np.cos(theta)
    x3 = np.sqrt(r2) * np.sin(theta)
    c1 = np.stack([x1, x2, x3], axis=1)
    # class 2: x1^2 + x3^2 - 1.3 = 0  (x2 free)
    theta = rng.uniform(0.0, 2.0 * np.pi, m2)
    x1 = np.sqrt(1.3) * np.cos(theta)
    x3 = np.sqrt(1.3) * np.sin(theta)
    x2 = rng.uniform(0.0, 1.0, m2)
    c2 = np.stack([x1, x2, x3], axis=1)
    X = np.concatenate([c1, c2], axis=0)
    X += rng.normal(0.0, noise, X.shape)
    y = np.concatenate([np.zeros(m1, np.int32), np.ones(m2, np.int32)])
    perm = rng.permutation(m)
    return X[perm].astype(np.float32), y[perm]


def _planted_class(rng, m: int, n: int, degree: int = 2, noise: float = 0.03):
    """Sample points near a random degree-``degree`` algebraic set in R^n.

    We draw a random polynomial constraint on the first 3 (or n) coordinates
    and project random points onto it approximately via one Newton step, then
    add noise — cheap, and guarantees an approximately-vanishing polynomial
    exists for the class.
    """
    k = min(3, n)
    w = rng.uniform(0.5, 1.5, k)
    c = rng.uniform(0.5, 1.5)
    X = rng.uniform(0.0, 1.0, (m, n))
    # constraint sum_j w_j x_j^degree = c on the first k coords; rescale those
    s = (w * X[:, :k] ** degree).sum(axis=1)
    scale = (c / np.maximum(s, 1e-9)) ** (1.0 / degree)
    X[:, :k] *= scale[:, None]
    X += rng.normal(0.0, noise, X.shape)
    return X


def uci_like(name: str, seed: int = 0):
    """Procedural stand-in with the (m, n, k) shape of the named UCI set."""
    if name not in UCI_SHAPES:
        raise KeyError(f"unknown dataset {name!r}; options: {sorted(UCI_SHAPES)}")
    m, n, k = UCI_SHAPES[name]
    rng = np.random.default_rng(seed)
    sizes = [m // k] * k
    sizes[-1] += m - sum(sizes)
    Xs, ys = [], []
    for c, mc in enumerate(sizes):
        Xs.append(_planted_class(rng, mc, n, degree=2 + (c % 2)))
        ys.append(np.full(mc, c, np.int32))
    X = np.concatenate(Xs, axis=0)
    y = np.concatenate(ys)
    perm = rng.permutation(m)
    return X[perm].astype(np.float32), y[perm]


def multiclass_planted(sizes, n: int = 4, seed: int = 0):
    """k classes of the given ``sizes``, each planted on its own random
    algebraic set (see :func:`_planted_class`) — the multi-class fit
    benchmark's dataset.  Returns shuffled ``(X, y)``."""
    rng = np.random.default_rng(seed)
    Xs, ys = [], []
    for c, mc in enumerate(sizes):
        Xs.append(_planted_class(rng, int(mc), n, degree=2 + (c % 2)))
        ys.append(np.full(int(mc), c, np.int32))
    X = np.concatenate(Xs, axis=0)
    y = np.concatenate(ys)
    perm = rng.permutation(X.shape[0])
    return X[perm].astype(np.float32), y[perm]


def lognormal_sizes(k: int, mean_rows: int, sigma: float = 0.8, seed: int = 0):
    """Lognormal-skewed class sizes with the given mean — the skewed-classes
    regime of the multi-class benchmark (min size clipped to 32)."""
    rng = np.random.default_rng(seed)
    raw = rng.lognormal(mean=0.0, sigma=sigma, size=k)
    sizes = np.maximum((raw / raw.mean() * mean_rows).astype(int), 32)
    return [int(s) for s in sizes]


def random_cube(m: int, n: int, seed: int = 0):
    """Uniform [0,1]^n noise (Figure 1 setting: no algebraic structure)."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (m, n)).astype(np.float32)


def train_test_split(X, y, test_frac: float = 0.4, seed: int = 0):
    """Paper's 60/40 random partition."""
    rng = np.random.default_rng(seed)
    m = X.shape[0]
    perm = rng.permutation(m)
    cut = int(round(m * (1.0 - test_frac)))
    tr, te = perm[:cut], perm[cut:]
    return X[tr], y[tr], X[te], y[te]


# ---------------------------------------------------------------------------
# Streaming data: deterministic planted-polynomial tiles + .npy shard writer
# ---------------------------------------------------------------------------

STREAM_TILE_ROWS = 4096  # fixed tile granularity of the streamed generators


def planted_stream_tile(
    tile_idx: int, n: int = 3, seed: int = 0, degree: int = 2, noise: float = 0.03
) -> np.ndarray:
    """One full ``(STREAM_TILE_ROWS, n)`` tile of the planted-polynomial
    stream: the construction of :func:`_planted_class` made
    tile-deterministic (the constraint from ``seed`` alone, each tile its
    own derived rng), so row ``r`` has the same values however the stream is
    chunked and however large ``m`` is."""
    rng_w = np.random.default_rng(seed)
    k = min(3, n)
    w = rng_w.uniform(0.5, 1.5, k)
    c = rng_w.uniform(0.5, 1.5)
    rng = np.random.default_rng(np.random.SeedSequence([seed + 1, tile_idx]))
    X = rng.uniform(0.0, 1.0, (STREAM_TILE_ROWS, n))
    s = (w * X[:, :k] ** degree).sum(axis=1)
    scale = (c / np.maximum(s, 1e-9)) ** (1.0 / degree)
    X[:, :k] *= scale[:, None]
    X += rng.normal(0.0, noise, X.shape)
    return X.astype(np.float32)


def planted_source(m: int, n: int = 3, seed: int = 0, degree: int = 2,
                   noise: float = 0.03):
    """Generator-backed :class:`repro_torch.streaming.source.SyntheticSource`
    over the planted-polynomial stream: ``m`` rows that occupy no storage."""
    from ..streaming.source import SyntheticSource

    return SyntheticSource(
        lambda idx: planted_stream_tile(idx, n=n, seed=seed, degree=degree,
                                        noise=noise),
        num_rows=m,
        num_features=n,
        tile_rows=STREAM_TILE_ROWS,
    )


def write_shards(
    path: str,
    data,
    shard_rows: int = 1 << 16,
    dtype: str = "float32",
    append: bool = False,
) -> Dict:
    """Write a source (or array) as a memory-mappable ``.npy`` shard
    directory (``shard_00000.npy``, ... and ``meta.json``, format
    ``repro.shards.v1``) that :class:`repro_torch.streaming.source.
    ShardDirSource` reads.  Returns the metadata dict.

    ``meta.json`` records a CRC32 and byte length per shard, checked before
    a shard's rows are served.  Chaos sites (:mod:`repro_torch.resilience.
    chaos`): ``shards.shard_written`` after each shard file (before the meta
    commit: a kill there is a torn write) and ``shards.committed`` after
    ``meta.json``.  ``append=True`` grows an existing directory:
    the new shard files are written first and ``meta.json`` is replaced last
    by an atomic rename, so a reader sees either the old or the new
    directory.  Appending needs every existing shard full (the reader
    indexes rows as ``pos // shard_rows``).
    """
    from ..resilience import chaos
    from ..resilience.integrity import checksum_file
    from ..streaming.source import SHARD_FORMAT, SHARD_META, as_source

    source = as_source(data)
    m, n = source.num_rows, source.num_features
    os.makedirs(path, exist_ok=True)
    np_dtype = np.dtype(dtype)
    first_shard, row_offset = 0, 0
    checksums: list = []
    shard_bytes: list = []
    if append:
        with open(os.path.join(path, SHARD_META)) as f:
            meta = json.load(f)
        if meta.get("format") != SHARD_FORMAT:
            raise ValueError(
                f"{path!r} is not a {SHARD_FORMAT} shard directory "
                f"(format={meta.get('format')!r})"
            )
        if int(meta["num_features"]) != n or str(meta["dtype"]) != str(np_dtype):
            raise ValueError(
                f"append mismatch at {path!r}: existing "
                f"(n={meta['num_features']}, dtype={meta['dtype']}), "
                f"appending (n={n}, dtype={np_dtype})"
            )
        shard_rows = int(meta["shard_rows"])
        row_offset = int(meta["num_rows"])
        if row_offset % shard_rows != 0:
            raise ValueError(
                f"cannot append to {path!r}: existing num_rows={row_offset} "
                f"is not a multiple of shard_rows={shard_rows} (the trailing "
                "shard is partial; readers assume all but the last shard are "
                "full)"
            )
        first_shard = int(meta["num_shards"])
        if first_shard * shard_rows != row_offset:
            raise ValueError(
                f"{path!r}: meta.json is inconsistent — "
                f"num_shards={first_shard} * shard_rows={shard_rows} != "
                f"num_rows={row_offset} (partial write?)"
            )
        # a directory written without checksums keeps None (unknown) for
        # its existing shards
        checksums = list(meta.get("checksums") or [None] * first_shard)
        shard_bytes = list(meta.get("shard_bytes") or [None] * first_shard)
    num_new = max((m + shard_rows - 1) // shard_rows, 0 if append else 1)
    for idx in range(num_new):
        lo = idx * shard_rows
        hi = min(lo + shard_rows, m)
        block = np.asarray(source.read(lo, hi), np_dtype)
        fname = os.path.join(path, f"shard_{first_shard + idx:05d}.npy")
        np.save(fname, block)
        crc, nbytes = checksum_file(fname)
        checksums.append(crc)
        shard_bytes.append(nbytes)
        chaos.fire("shards.shard_written", path=fname)
    meta = {
        "format": SHARD_FORMAT,
        "num_rows": int(row_offset + m),
        "num_features": int(n),
        "shard_rows": int(shard_rows),
        "num_shards": int(first_shard + num_new),
        "dtype": str(np_dtype),
        "checksums": checksums,
        "shard_bytes": shard_bytes,
    }
    # meta commits the write: tmp + rename is atomic on POSIX
    tmp = os.path.join(path, SHARD_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, SHARD_META))
    chaos.fire("shards.committed", path=os.path.join(path, SHARD_META))
    return meta
