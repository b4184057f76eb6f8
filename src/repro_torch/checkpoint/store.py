"""Checkpoints with an atomic manifest commit.

Counterpart of ``src/repro/checkpoint/store.py``, without JAX.  The on-disk
format is the reference's, byte for byte, so each package reads the other's
checkpoints::

    <dir>/step_000123/
        manifest.json       # tree structure, shapes, dtypes, checksums, metadata
        leaf_00000.npy ...  # one file per leaf
        COMMITTED           # written last: a checkpoint without it is junk

* **atomicity** — leaves are written into ``step_N.tmp`` and the directory
  is renamed only after the COMMITTED marker is fsync'd; a crash mid-save
  leaves a ``.tmp`` directory that restore ignores and the next save
  overwrites.
* **integrity** — manifest v2 records a CRC32 and the byte length of each
  leaf file, computed from the exact bytes written; :func:`restore` verifies
  them before deserializing, raising
  :class:`~repro_torch.resilience.integrity.IntegrityError` naming the bad
  file.  v1 manifests (no checksums) still load.
* **fallback** — :func:`load_latest` / :func:`latest_verifiable_step` walk
  committed steps newest first and land on the newest one that verifies.
* **async** — :class:`AsyncSaver` copies the leaves to the host on the call
  and writes them in a daemon thread; a failed write re-raises on ``wait()``
  or the next ``save``.

A tree is a leaf (a numpy array, a torch tensor or a scalar), or a dict, list
or tuple of trees.  Leaves are flattened as JAX flattens them (dict keys in
sorted order), so leaf ``i`` is the same array in both packages.  Tensors are
copied to the host (``.cpu()``) and written as numpy arrays in C order, as
``jax.device_get`` gives them; ``restore`` returns numpy arrays.

As in the reference, a save runs in an ``obs.span("checkpoint/save")``, a
committed save fires the chaos site ``store.committed`` (with the committed
directory as ``path``: corrupt-after-commit faults), emits the
``checkpoint/committed`` event and counts ``checkpoint.saves``; a restore
runs in ``checkpoint/restore``.

The reference's ``shardings`` (a restored tree put under a mesh's
shardings) is a placement here: one device for the whole tree, or a tree of
devices matching ``like`` (:func:`place`); each leaf then comes back as a
tensor on its device.
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import obs
from ..resilience import chaos
from ..resilience.integrity import IntegrityError, checksum_bytes, verify_file

_MANIFEST = "manifest.json"
_MARKER = "COMMITTED"
MANIFEST_VERSION = 2  # v1: no checksums; v2: per-leaf crc32 + byte length

log = logging.getLogger("repro_torch.checkpoint")

# torch types numpy cannot hold: stored upcast to float32 (exact), their name
# recorded as the reference records its ml_dtypes extension types
_EXTENSION = {torch.bfloat16: "bfloat16", torch.float8_e4m3fn: "float8_e4m3fn",
              torch.float8_e5m2: "float8_e5m2"}


def _flatten(tree) -> Tuple[str, list]:
    """``(treedef string, leaves)`` in JAX's flattening order and with JAX's
    ``str(treedef)`` spelling for dicts, lists and tuples."""
    leaves: list = []

    def walk(node) -> str:
        if isinstance(node, dict):
            keys = sorted(node)
            return "{" + ", ".join(f"{k!r}: {walk(node[k])}" for k in keys) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(walk(v) for v in node) + "]"
        if isinstance(node, tuple):
            inner = ", ".join(walk(v) for v in node)
            return "(" + inner + ("," if len(node) == 1 else "") + ")"
        if node is None:
            return "None"
        leaves.append(node)
        return "*"

    return f"PyTreeDef({walk(tree)})", leaves


def _unflatten(like, leaves: list):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            items = [build(v) for v in node]
            return type(node)(*items) if hasattr(node, "_fields") else type(node)(items)
        if node is None:
            return None
        return next(it)

    return build(like)


def _is_device(x) -> bool:
    return isinstance(x, (str, torch.device))


def place(tree, shardings):
    """``tree`` with its leaves as tensors on the devices of ``shardings``:
    one device (a ``torch.device`` or its name) for every leaf below it, a
    dict, list or tuple of those matching ``tree``'s structure, or ``None``
    to leave that part of the tree as it is.  A numpy leaf becomes a tensor
    of its type, a tensor moves; the values are not changed."""
    if shardings is None or tree is None:
        return tree
    one = _is_device(shardings)
    if isinstance(tree, dict):
        if not one and (not isinstance(shardings, dict) or set(shardings) != set(tree)):
            raise ValueError("shardings do not match the tree's dict keys")
        return {k: place(v, shardings if one else shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        if not one and (not isinstance(shardings, (list, tuple))
                        or len(shardings) != len(tree)):
            raise ValueError("shardings do not match the tree's sequence")
        subs = [shardings] * len(tree) if one else shardings
        items = [place(v, sh) for v, sh in zip(tree, subs)]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    if not one:
        raise ValueError(f"no device for a leaf: shardings {shardings!r}")
    if torch.is_tensor(tree):
        return tree.to(torch.device(shardings))
    return torch.from_numpy(np.ascontiguousarray(np.asarray(tree))).to(torch.device(shardings))


def _host(leaf) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as the numpy array that is written, and the extension type it
    stands for (None for plain numpy types)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype in _EXTENSION:
            return t.to(torch.float32).numpy(), _EXTENSION[t.dtype]
        return t.numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name.startswith(("bfloat", "float8")):
        return arr.astype(np.float32), arr.dtype.name
    return arr, None


def _decode_leaf(arr: np.ndarray, stored_as: Optional[str]):
    """Leaves of an extension type come back as torch tensors of that type
    (numpy has none); every other leaf as the numpy array that was saved."""
    if stored_as is None:
        return arr
    dtype = getattr(torch, stored_as)
    return torch.from_numpy(arr).to(dtype)


def save(directory: str, step: int, tree, metadata: Optional[Dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed checkpoint path."""
    with obs.span("checkpoint/save", step=step):
        return _save(directory, step, tree, metadata)


def _save(directory: str, step: int, tree, metadata: Optional[Dict] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    treedef, leaves = _flatten(tree)
    entries = []
    for i, leaf in enumerate(leaves):
        encoded, stored_as = _host(leaf)
        fname = f"leaf_{i:05d}.npy"
        # serialize in memory first: the checksum must cover the exact bytes
        # that land on disk (npy header included)
        buf = io.BytesIO()
        np.save(buf, encoded)
        payload = buf.getvalue()
        with open(os.path.join(tmp, fname), "wb") as f:
            f.write(payload)
        entry = {
            "file": fname,
            "shape": list(encoded.shape),
            "dtype": stored_as or str(encoded.dtype),
            "bytes": len(payload),
            "checksum": checksum_bytes(payload),
        }
        if stored_as is not None:
            entry["extension_dtype"] = stored_as
        entries.append(entry)
    manifest = {
        "manifest_version": MANIFEST_VERSION,
        "step": step,
        "treedef": treedef,
        "num_leaves": len(leaves),
        "leaves": entries,
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, _MARKER), "w") as f:
        f.write("ok")
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    chaos.fire("store.committed", path=final)
    obs.event("checkpoint/committed", step=step, leaves=len(leaves))
    obs.registry().counter("checkpoint.saves").inc()
    return final


class AsyncSaver:
    """Overlap checkpoint I/O with other work: copy to the host on the call,
    write in a daemon thread.  ``wait()`` joins the save in flight.

    A failed background write is never swallowed: it is re-raised on the
    next ``wait()`` or ``save()``."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self.last_path: Optional[str] = None

    def save(self, directory: str, step: int, tree, metadata=None):
        self.wait()
        _, leaves = _flatten(tree)
        host_tree = _unflatten(tree, [_host_copy(x) for x in leaves])

        def work():
            try:
                self.last_path = save(directory, step, host_tree, metadata)
            except BaseException as e:  # noqa: BLE001 - surfaced on wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                "async checkpoint write failed (the checkpoint does NOT exist)"
            ) from err


def _host_copy(leaf):
    """A snapshot of ``leaf`` that later writes to it cannot change."""
    if torch.is_tensor(leaf):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def committed_steps(directory: str) -> List[int]:
    """All committed steps in ``directory``, ascending (ignores .tmp wreckage)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        full = os.path.join(directory, name)
        if (
            name.startswith("step_")
            and not name.endswith(".tmp")
            and os.path.exists(os.path.join(full, _MARKER))
        ):
            try:
                steps.append(int(name.split("_")[1]))
            except ValueError:
                continue
    return sorted(steps)


def latest_step(directory: str) -> Optional[int]:
    """Largest committed step in ``directory`` (ignores .tmp wreckage)."""
    steps = committed_steps(directory)
    return steps[-1] if steps else None


def verify(directory: str, step: int) -> None:
    """Verify one committed step: every leaf file must match its manifest
    checksum and byte length.  Raises :class:`IntegrityError` naming the
    first bad file, or :class:`FileNotFoundError` when the step is not
    committed.  v1 manifests (no checksums) verify only file presence."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise IntegrityError(
            f"{os.path.join(path, _MANIFEST)}: unreadable manifest ({e})",
            path=os.path.join(path, _MANIFEST),
        ) from e
    for entry in manifest["leaves"]:
        leaf_path = os.path.join(path, entry["file"])
        if "checksum" in entry:
            verify_file(leaf_path, entry["checksum"], entry.get("bytes"))
        elif not os.path.exists(leaf_path):
            raise IntegrityError(
                f"{leaf_path}: leaf file missing from committed checkpoint",
                path=leaf_path,
            )


def latest_verifiable_step(directory: str) -> Optional[int]:
    """Newest committed step that passes :func:`verify`."""
    for step in reversed(committed_steps(directory)):
        try:
            verify(directory, step)
            return step
        except IntegrityError as e:
            log.warning("checkpoint step %d fails verification (%s); falling back", step, e)
    return None


def read_metadata(directory: str, step: Optional[int] = None) -> Tuple[Dict, int]:
    """User metadata of the newest (or given) committed step without
    touching any leaf.  Returns ``(metadata, step)``; raises
    ``FileNotFoundError`` when nothing is committed."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {directory!r}")
    path = os.path.join(directory, f"step_{step:08d}", _MANIFEST)
    with open(path) as f:
        return json.load(f)["metadata"], step


def restore(directory: str, step: int, like, shardings: Any = None, *,
            verify_integrity: bool = True):
    """Restore the step's tree, shaped like ``like``.  Returns ``(tree,
    metadata)``: numpy leaves (torch tensors for bf16 and fp8 leaves), or,
    with ``shardings``, each leaf a tensor on its device (:func:`place`).

    ``verify_integrity`` (default on) checks every leaf file against its
    manifest checksum before deserializing."""
    path = os.path.join(directory, f"step_{step:08d}")
    if not os.path.exists(os.path.join(path, _MARKER)):
        raise FileNotFoundError(f"no committed checkpoint at {path}")
    with obs.span("checkpoint/restore", step=step):
        tree, metadata = _restore_committed(directory, step, path, like, verify_integrity)
    return place(tree, shardings), metadata


def _restore_committed(directory: str, step: int, path: str, like, verify_integrity: bool):
    if verify_integrity:
        verify(directory, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    _, like_leaves = _flatten(like)
    if manifest["num_leaves"] != len(like_leaves):
        raise ValueError(
            f"checkpoint has {manifest['num_leaves']} leaves, expected {len(like_leaves)}"
        )
    arrs = [
        _decode_leaf(np.load(os.path.join(path, e["file"])), e.get("extension_dtype"))
        for e in manifest["leaves"]
    ]
    return _unflatten(like, arrs), manifest["metadata"]


def load_latest(directory: str, like, shardings: Any = None):
    """Restore the newest *verifiable* committed checkpoint: a corrupt head
    is skipped with a warning.  Returns ``(tree, metadata, step)``; raises
    :class:`FileNotFoundError` when nothing is committed and
    :class:`IntegrityError` when every committed step is damaged."""
    steps = committed_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no committed checkpoint under {directory!r}")
    last_err: Optional[IntegrityError] = None
    for step in reversed(steps):
        try:
            tree, metadata = restore(directory, step, like, shardings)
        except IntegrityError as e:
            log.warning("step %d: %s", step, e)
            last_err = e
            continue
        if step != steps[-1]:
            log.warning("restored step %d (newest committed step %d failed "
                        "verification)", step, steps[-1])
        return tree, metadata, step
    raise IntegrityError(
        f"every committed checkpoint under {directory!r} fails verification "
        f"(newest failure: {last_err})",
        path=getattr(last_err, "path", None),
    )


def cleanup(directory: str, keep_last: int = 3):
    """Delete all but the newest ``keep_last`` committed checkpoints."""
    for s in committed_steps(directory)[:-keep_last]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"), ignore_errors=True)
