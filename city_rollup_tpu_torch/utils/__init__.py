"""Shared utilities: trace timers, logging helpers.

Counterpart of the reference's ``utils/``: a copy.
"""

from .timers import TraceTimer, DebugTimer
