"""Fault-tolerant drivers of the distributed Power-ψ."""
from .psi_driver import DriverReport, PsiDriver, PsiDriverBase, SlowChunk

__all__ = ["DriverReport", "PsiDriver", "PsiDriverBase", "SlowChunk"]
