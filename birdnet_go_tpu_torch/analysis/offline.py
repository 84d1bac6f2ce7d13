"""Offline file analysis: WAV → windows → batched device inference → table
(port of ``birdnet_go_tpu/analysis/offline.py``).

Behavior spec: doc/wiki/file-analysis.md (the reference's legacy `file`
command). The samples go to the classifier's device once; resampling and
window slicing run there, and each batch of ``batch_size`` windows is a
slice of the device windows, the last one zero-padded to the full batch.
The model takes float32 PCM through the plain mel (``MelCnnModel.apply``),
as the JAX analyzer does, so no hand-written kernel runs here.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from birdnet_go_tpu_torch.analysis.results import Detection, WindowResult
from birdnet_go_tpu_torch.audio.wav import read_wav
from birdnet_go_tpu_torch.inference.backend import TorchClassifier
from birdnet_go_tpu_torch.ops.resample import (
    ResampleConfig,
    polyphase_resample,
)
from birdnet_go_tpu_torch.ops.windows import (
    slice_overlapped_windows,
    window_hop_samples,
)
from birdnet_go_tpu_torch.taxonomy.labels import LabelSet
from birdnet_go_tpu_torch.utils import tracing


@dataclasses.dataclass
class OfflineConfig:
    threshold: float = 0.8          # conf/defaults.go:77 global default
    sensitivity: float = 1.0        # conf/defaults.go:76
    overlap: float = 0.0            # seconds on the 3 s base (cmd/root.go:96)
    batch_size: int = 64            # windows per device step
    top_k: int = 10
    all_results: bool = False       # emit all top-K above threshold per window


@dataclasses.dataclass
class OfflineReport:
    detections: list[Detection]
    windows: list[WindowResult]
    duration_seconds: float
    elapsed_seconds: float

    @property
    def realtime_factor(self) -> float:
        return self.duration_seconds / max(self.elapsed_seconds, 1e-9)


class OfflineAnalyzer:
    """Analyze files/arrays with one classifier."""

    def __init__(self, classifier: TorchClassifier, labels: LabelSet,
                 config: OfflineConfig | None = None):
        self.classifier = classifier
        self.labels = labels
        self.config = config or OfflineConfig()
        spec = classifier.model.spec
        self.clip_samples = spec.clip_samples
        self.model_rate = spec.sample_rate
        self.clip_seconds = spec.clip_seconds

    def analyze_file(self, path: str | Path) -> OfflineReport:
        samples, info = read_wav(path)
        return self.analyze_samples(samples, info.sample_rate)

    def analyze_samples(self, samples: np.ndarray, sample_rate: int
                        ) -> OfflineReport:
        t_start = time.perf_counter()
        with tracing.span("offline.analyze"):
            window_results, detections = self._analyze(samples, sample_rate)
        elapsed = time.perf_counter() - t_start
        return OfflineReport(detections=detections, windows=window_results,
                             duration_seconds=len(samples) / sample_rate,
                             elapsed_seconds=elapsed)

    def _analyze(self, samples: np.ndarray, sample_rate: int
                 ) -> tuple[list[WindowResult], list[Detection]]:
        cfg = self.config
        hop = window_hop_samples(self.clip_samples, cfg.overlap,
                                 self.model_rate,
                                 clip_seconds=self.clip_seconds)
        windows = self._device_windows(samples, sample_rate, hop)
        n_win = windows.shape[0]

        window_results: list[WindowResult] = []
        detections: list[Detection] = []
        b = cfg.batch_size
        for start in range(0, n_win, b):
            chunk = windows[start:start + b]
            if chunk.shape[0] < b:       # pad to the full batch
                chunk = F.pad(chunk, (0, 0, 0, b - chunk.shape[0]))
            vals, idx = self.classifier.predict_topk(
                chunk, sensitivity=cfg.sensitivity, k=cfg.top_k)
            with tracing.span("offline.results"):
                for j in range(min(b, n_win - start)):
                    w = start + j
                    begin = w * hop / self.model_rate
                    end = begin + self.clip_seconds
                    wr = WindowResult(
                        window_index=w, begin_seconds=begin,
                        end_seconds=end,
                        model_id=self.classifier.model_id,
                        indices=[int(i) for i in idx[j]],
                        confidences=[float(v) for v in vals[j]])
                    window_results.append(wr)
                    detections.extend(self._detections_for(wr))
        return window_results, detections

    def _device_windows(self, samples: np.ndarray, sample_rate: int,
                        hop: int) -> torch.Tensor:
        """Samples at `sample_rate` → [W, clip] float32 windows at the
        model's rate on the classifier's device, with the zero-padded tail
        of the JAX analyzer's ``_host_slice``: a signal shorter than a clip
        still gives one window."""
        with tracing.span("offline.upload"):
            x = torch.as_tensor(np.asarray(samples, np.float32),
                                device=self.classifier.device)
        if sample_rate != self.model_rate:
            with tracing.span("offline.resample"):
                x = polyphase_resample(x, ResampleConfig(sample_rate,
                                                         self.model_rate))
        if x.shape[-1] < self.clip_samples:
            x = F.pad(x, (0, self.clip_samples - x.shape[-1]))
        return slice_overlapped_windows(x, self.clip_samples, hop)

    def _detections_for(self, wr: WindowResult) -> list[Detection]:
        cfg = self.config
        out = []
        for conf, sp_idx in zip(wr.confidences, wr.indices):
            if conf < cfg.threshold:
                break                    # top-K is sorted descending
            sp = self.labels[sp_idx]
            out.append(Detection(
                species=sp, confidence=conf,
                begin_seconds=wr.begin_seconds, end_seconds=wr.end_seconds,
                model_id=wr.model_id, window_index=wr.window_index,
                species_code=self.labels.code_for(sp)))
            if not cfg.all_results:
                break                    # top-1 per window (Raven default)
        return out
