"""Failure survival of the port: content checksums for persisted payloads
(:mod:`~repro_torch.resilience.integrity`), seeded fault injection through
fixed sites (:mod:`~repro_torch.resilience.chaos`: the serving engine, the
registry, the checkpoint store, the shard writer and the continuous
controller), and the controller's fsync'd journal
(:mod:`~repro_torch.resilience.journal`)."""

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
from .journal import Journal, JournalError

__all__ = [
    "Fault",
    "FaultPlan",
    "InjectedFault",
    "IntegrityError",
    "Journal",
    "JournalError",
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
