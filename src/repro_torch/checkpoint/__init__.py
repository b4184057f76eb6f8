"""Checkpoints: atomic save and verified restore, in the JAX package's
on-disk format (:mod:`~repro_torch.checkpoint.store`)."""
from . import store
from .store import AsyncSaver, cleanup, latest_step, restore, save

__all__ = ["store", "save", "restore", "latest_step", "cleanup", "AsyncSaver"]
