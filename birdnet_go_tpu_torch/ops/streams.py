"""Where the aux planes' device work runs: a device that must exist, and,
on a card, a CUDA stream of the caller's own.

The served step runs on the card's current stream. A spectrogram render,
a sound-level pass or a range rebuild queued there would wait behind the
step, and the next step behind it; on a stream of its own it overlaps.
"""

from __future__ import annotations

import contextlib

import torch


def aux_device(device: torch.device | str, what: str) -> torch.device:
    """`device` as a ``torch.device``; raises where it names a CUDA card
    and there is none (no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what} on {dev} needs a CUDA card "
                           "(torch.cuda.is_available() is false)")
    return dev


def side_stream(dev: torch.device) -> torch.cuda.Stream | None:
    """A CUDA stream of `dev` other than its default one (None on the
    CPU)."""
    return torch.cuda.Stream(dev) if dev.type == "cuda" else None


def on_stream(stream: torch.cuda.Stream | None):
    """Run the body with `stream` current in this thread (no stream:
    nothing changes)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())
