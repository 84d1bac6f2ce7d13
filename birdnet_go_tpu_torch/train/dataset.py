"""Training datasets: directory-per-species WAV layout → window batches
(port of ``birdnet_go_tpu/train/dataset.py``).

The layout custom classifiers are trained from (one subdirectory per
species label, WAV files inside — the same convention BirdNET-Analyzer
custom training uses). Windows, labels, the split and the batch order equal
the JAX package's: the same numpy RNG draws them, and only full batches are
yielded. A file at another sample rate is resampled on `device` and comes
back to host memory.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path

import numpy as np
import torch

from birdnet_go_tpu_torch.audio.wav import read_wav
from birdnet_go_tpu_torch.ops.resample import (
    ResampleConfig,
    polyphase_resample,
)

log = logging.getLogger("birdnet_tpu.train")


@dataclasses.dataclass
class WindowDataset:
    windows: np.ndarray            # [N, clip_samples] float32
    labels: np.ndarray             # [N] int32 class indices
    class_names: list[str]

    def __len__(self) -> int:
        return len(self.windows)

    def one_hot(self) -> np.ndarray:
        out = np.zeros((len(self.labels), len(self.class_names)), np.float32)
        out[np.arange(len(self.labels)), self.labels] = 1.0
        return out

    def split(self, val_fraction: float = 0.1, seed: int = 0
              ) -> tuple["WindowDataset", "WindowDataset"]:
        """Stratified train/validation split (≥1 val window per class when
        the class has ≥2 windows)."""
        rng = np.random.default_rng(seed)
        val_idx: list[int] = []
        for ci in range(len(self.class_names)):
            idx = np.nonzero(self.labels == ci)[0]
            if len(idx) < 2:
                continue
            take = max(1, int(round(len(idx) * val_fraction)))
            val_idx.extend(rng.permutation(idx)[:take].tolist())
        val_mask = np.zeros(len(self.windows), bool)
        val_mask[val_idx] = True
        mk = lambda m: WindowDataset(self.windows[m], self.labels[m],
                                     self.class_names)
        return mk(~val_mask), mk(val_mask)

    def batches(self, batch_size: int, seed: int = 0, epochs: int = 1):
        """(windows [B, clip], one-hot labels [B, classes]) in a seeded
        order, full batches only; a dataset smaller than one batch is
        yielded whole, once an epoch."""
        rng = np.random.default_rng(seed)
        n = len(self.windows)
        labels_1h = self.one_hot()
        for _ in range(epochs):
            order = rng.permutation(n)
            if n < batch_size:
                yield self.windows[order], labels_1h[order]
                continue
            for start in range(0, n - batch_size + 1, batch_size):
                idx = order[start:start + batch_size]
                yield self.windows[idx], labels_1h[idx]


def load_directory_dataset(root: str | Path, sample_rate: int = 48000,
                           clip_seconds: float = 3.0,
                           max_windows_per_file: int = 20,
                           device: torch.device | str = "cpu"
                           ) -> WindowDataset:
    """<root>/<species label>/*.wav → non-overlapping training windows; a
    file longer than half a clip but shorter than one is zero-padded to
    one window."""
    root = Path(root)
    class_dirs = sorted(d for d in root.iterdir() if d.is_dir())
    if not class_dirs:
        raise ValueError(f"no class directories under {root}")
    clip = int(sample_rate * clip_seconds)
    windows, labels = [], []
    class_names = [d.name for d in class_dirs]
    for ci, d in enumerate(class_dirs):
        for wav in sorted(d.glob("*.wav")):
            try:
                samples, info = read_wav(wav)
            except ValueError as e:
                log.warning("skipping %s: %s", wav, e)
                continue
            if info.sample_rate != sample_rate:
                x = torch.from_numpy(np.ascontiguousarray(
                    samples, np.float32)).to(device)
                samples = polyphase_resample(
                    x, ResampleConfig(info.sample_rate, sample_rate)
                ).cpu().numpy()
            n_win = min(len(samples) // clip, max_windows_per_file)
            if n_win == 0 and len(samples) > clip // 2:
                padded = np.zeros(clip, np.float32)
                padded[:len(samples)] = samples
                windows.append(padded)
                labels.append(ci)
                continue
            for w in range(n_win):
                windows.append(samples[w * clip:(w + 1) * clip]
                               .astype(np.float32))
                labels.append(ci)
    if not windows:
        raise ValueError(f"no usable audio under {root}")
    return WindowDataset(windows=np.stack(windows),
                         labels=np.asarray(labels, np.int32),
                         class_names=class_names)
