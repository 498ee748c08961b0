"""Atomic, resumable checkpoints: the reference's ``repro.checkpoint``."""
from .manager import CheckpointManager
