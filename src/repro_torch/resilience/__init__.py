"""Failure survival of the port: content checksums for persisted payloads
(:mod:`~repro_torch.resilience.integrity`).  The journal and the chaos
harness of the JAX package's ``repro.resilience`` are ROADMAP.md queue 1
item 13."""

from .integrity import (
    IntegrityError,
    checksum_bytes,
    checksum_file,
    flip_bit,
    truncate_file,
    verify_file,
)

__all__ = [
    "IntegrityError",
    "checksum_bytes",
    "checksum_file",
    "flip_bit",
    "truncate_file",
    "verify_file",
]
