"""Deterministic fault injection (see plan.py for the site table)."""

from .plan import FaultInjected, FaultPlan, FaultRule, FiredFault, maybe_crash

__all__ = ["FaultInjected", "FaultPlan", "FaultRule", "FiredFault", "maybe_crash"]
