"""Content checksums: corruption is never silent.

Counterpart of ``src/repro/resilience/integrity.py`` (standard library
only), kept as the port's own copy so that ``repro_torch`` imports nothing
of ``repro``; the serialized checksums are the same strings, so either
package verifies the other's checkpoints.

A flipped bit in a Gram accumulator or a truncated leaf file does not crash
OAVI — it produces confidently-wrong polynomials (the spurious-vanishing
failure mode).  The only defense is end-to-end content verification: every
persisted payload (checkpoint leaves, shard files, journal records) carries a
CRC32 of its exact bytes, and every load verifies before the bytes reach a
kernel.

CRC32 (``zlib.crc32``) is the right tool here: it is in the stdlib (no new
dependency), runs at memory bandwidth, and — being a linear code — detects
**every** single-bit flip and every burst error up to 32 bits, which covers
the physically plausible corruption modes (bit rot, torn page, truncation;
truncation additionally changes the recorded byte length, checked first so
the error says "truncated" rather than "mismatch").  It is *not* a defense
against an adversary; these files are trusted-writer state, not inputs.

Checksums are serialized as ``"crc32:%08x"`` so a future algorithm switch
(xxhash when available, sha256 for untrusted sources) is a new prefix, not a
format break.
"""

from __future__ import annotations

import os
import zlib
from typing import Optional, Tuple

_PREFIX = "crc32:"
_CHUNK = 1 << 20  # stream files in 1 MiB pieces: O(1) memory at any size


class IntegrityError(ValueError):
    """A persisted payload failed content verification.

    ``path`` names the offending file — the one piece of information an
    operator needs to decide between restore-from-replica and delete.
    Subclasses :class:`ValueError` so pre-existing callers that treat load
    problems as value errors keep working.
    """

    def __init__(self, message: str, path: Optional[str] = None):
        super().__init__(message)
        self.path = path


def checksum_bytes(data: bytes) -> str:
    """Serialized CRC32 of ``data`` (``"crc32:%08x"``)."""
    return f"{_PREFIX}{zlib.crc32(data) & 0xFFFFFFFF:08x}"


def checksum_file(path: str) -> Tuple[str, int]:
    """``(checksum, num_bytes)`` of a file, streamed in bounded memory."""
    crc = 0
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_CHUNK)
            if not block:
                break
            crc = zlib.crc32(block, crc)
            size += len(block)
    return f"{_PREFIX}{crc & 0xFFFFFFFF:08x}", size


def verify_file(path: str, expected: str, expected_bytes: Optional[int] = None) -> None:
    """Raise :class:`IntegrityError` unless ``path`` matches its recorded
    checksum (and byte length, when recorded).  Length is checked first so a
    truncated file reports *truncation*, not a generic mismatch."""
    if not os.path.exists(path):
        raise IntegrityError(f"{path}: missing (expected {expected})", path=path)
    if expected_bytes is not None:
        actual_bytes = os.path.getsize(path)
        if actual_bytes != expected_bytes:
            raise IntegrityError(
                f"{path}: truncated or grown — {actual_bytes} bytes on disk, "
                f"{expected_bytes} recorded",
                path=path,
            )
    actual, _ = checksum_file(path)
    if actual != expected:
        raise IntegrityError(
            f"{path}: checksum mismatch — {actual} on disk, {expected} recorded "
            "(corrupt payload; falling back to an older checkpoint if one exists)",
            path=path,
        )


def flip_bit(path: str, byte_offset: int, bit: int = 0) -> None:
    """Flip one bit of a file in place — the canonical corruption injector
    used by the chaos plans and the property tests.  ``byte_offset`` may be
    negative (from the end)."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot flip a bit in empty file {path!r}")
    offset = byte_offset % size
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ (1 << (bit % 8))]))
        f.flush()
        os.fsync(f.fileno())


def truncate_file(path: str, num_bytes: int) -> None:
    """Truncate a file to ``num_bytes`` (a torn write, frozen mid-flight)."""
    with open(path, "r+b") as f:
        f.truncate(num_bytes)
        f.flush()
        os.fsync(f.fileno())
