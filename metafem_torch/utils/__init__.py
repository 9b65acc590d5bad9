"""Utilities: profiling hooks and the device-memory ledger."""

from .profiling import memory_report, phase_timer, trace_profile  # noqa: F401
