"""Overlapped analysis-window slicing on a torch device (port of
``birdnet_go_tpu/ops/windows.py``).

The reference's AnalysisBuffer yields one window per ClipLength/2 of fresh
audio (50% default overlap; user overlap 0–2.9 s on the 3 s base scales per
model — internal/classifier/model.go:40-54, internal/analysis/overlap.go:8).
For offline analysis a whole signal becomes [W, window_samples] windows:
a zero-padded tail and ``Tensor.unfold``, so the windows are a view of the
signal on its device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_hop_samples(clip_samples: int, overlap_seconds: float,
                       sample_rate: int, base_clip_seconds: float = 3.0,
                       clip_seconds: float | None = None) -> int:
    """User overlap (seconds on the 3 s base) → hop in samples for a model.

    Mirrors analysis/overlap.go:8-33: overlap is expressed on a 3 s base and
    scaled proportionally to the model's clip length; hop = clip − overlap.
    """
    if clip_seconds is None:
        clip_seconds = clip_samples / float(sample_rate)
    scaled_overlap = overlap_seconds * (clip_seconds / base_clip_seconds)
    scaled_overlap = min(max(scaled_overlap, 0.0), clip_seconds - 0.1)
    hop = clip_samples - int(round(scaled_overlap * sample_rate))
    return max(hop, 1)


def num_windows(total_samples: int, clip_samples: int, hop_samples: int,
                pad_final: bool = True) -> int:
    if total_samples <= 0:
        return 0
    if total_samples <= clip_samples:
        return 1 if pad_final or total_samples == clip_samples else 0
    n_full = (total_samples - clip_samples) // hop_samples + 1
    rem = total_samples - ((n_full - 1) * hop_samples + clip_samples)
    if rem > 0 and pad_final:
        n_full += 1
    return n_full


def slice_overlapped_windows(x: torch.Tensor, clip_samples: int,
                             hop_samples: int, pad_final: bool = True
                             ) -> torch.Tensor:
    """[T] (or [..., T]) → [..., W, clip_samples] overlapped windows.

    The final partial window is zero-padded (matching the reference's offline
    file analysis, which pads the tail — doc/wiki/file-analysis.md). Without
    a padded tail the result is a view of `x`.
    """
    t = x.shape[-1]
    w = num_windows(t, clip_samples, hop_samples, pad_final)
    if w == 0:
        return x.new_zeros((*x.shape[:-1], 0, clip_samples))
    pad_to = (w - 1) * hop_samples + clip_samples
    if pad_to > t:
        x = F.pad(x, (0, pad_to - t))
    return x.unfold(-1, clip_samples, hop_samples)
