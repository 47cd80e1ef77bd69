"""Crash recovery (the port of ``repro.runtime``)."""
from .supervisor import Supervisor, SupervisorConfig

__all__ = ["Supervisor", "SupervisorConfig"]
