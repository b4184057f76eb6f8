"""Failure survival of the port: content checksums for persisted payloads
(:mod:`~repro_torch.resilience.integrity`) and seeded fault injection
through fixed sites (:mod:`~repro_torch.resilience.chaos`: the serving
engine, the registry, the checkpoint store and the shard writer).  The
reference's journal (``resilience/journal.py``) is ROADMAP.md queue 1 item
13d."""

from .chaos import (
    POISON_SENTINEL,
    Fault,
    FaultPlan,
    InjectedFault,
    PoisonRequestError,
    TransientEngineError,
    fire,
    install,
    installed,
    uninstall,
)
from .integrity import (
    IntegrityError,
    checksum_bytes,
    checksum_file,
    flip_bit,
    truncate_file,
    verify_file,
)

__all__ = [
    "Fault",
    "FaultPlan",
    "InjectedFault",
    "IntegrityError",
    "POISON_SENTINEL",
    "PoisonRequestError",
    "TransientEngineError",
    "checksum_bytes",
    "checksum_file",
    "fire",
    "flip_bit",
    "install",
    "installed",
    "truncate_file",
    "uninstall",
    "verify_file",
]
