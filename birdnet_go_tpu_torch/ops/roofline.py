"""The least time an NVIDIA H100 SXM could take for a kernel's work.

Each kernel module has a ``*_work`` function beside its wrapper that returns
``(flops, nbytes)`` from a call's shapes: ``flops`` maps an arithmetic type
("f32" on CUDA cores, "tf32", "bf16" on tensor cores) to the floating-point
operations the function needs in that type, and ``nbytes`` counts each input
byte read once and each output byte written once. ``bound_ms`` divides them
by the card's published peaks (NVIDIA's data sheet, SXM part, dense, at its
700 W limit); a card set to a lower power limit runs slower under load.
"""

from __future__ import annotations

PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12          # HBM3, bytes/s


def bound_ms(flops: dict[str, float], nbytes: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the
    memory time and the sum over types of each type's operations at its
    peak."""
    ops_ms = sum(n / PEAK_FLOPS[t] for t, n in flops.items()) * 1e3
    mem_ms = nbytes / PEAK_BYTES * 1e3
    return (mem_ms, "bytes") if mem_ms >= ops_ms else (ops_ms, "operations")
