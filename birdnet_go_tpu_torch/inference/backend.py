"""Classifier and range-filter backends on a torch device (ports of
``JaxClassifier`` and ``JaxRangeFilter`` in
``birdnet_go_tpu/inference/backend.py``), and the range mask a classifier
takes from the filter."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from birdnet_go_tpu_torch.models.geomodel import Geomodel
from birdnet_go_tpu_torch.ops.streams import on_stream, side_stream
from birdnet_go_tpu_torch.ops.postprocess import (
    sigmoid_confidence,
    top_k_results,
)
from birdnet_go_tpu_torch.utils import tracing


class TorchClassifier:
    """A mel-CNN model (``MelCnnModel``) or an imported graph
    (``loader.ImportedModel``) moved to `device`, the card unless the
    caller passes another, with an optional range mask."""

    def __init__(self, model: nn.Module, device: torch.device | str = "cuda",
                 range_mask: np.ndarray | None = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.model_id = model.spec.model_id
        self.num_species = model.num_species
        self.set_range_mask(range_mask)

    def set_range_mask(self, mask: np.ndarray | None) -> None:
        """Swap the included-species mask (range filter rebuild)."""
        self._range_mask = (torch.as_tensor(np.asarray(mask, np.float32),
                                            device=self.device)
                            if mask is not None else None)

    def predict_topk(self, pcm: np.ndarray | torch.Tensor,
                     sensitivity: float = 1.0,
                     k: int = 10) -> tuple[np.ndarray, np.ndarray]:
        """float32 PCM [B, clip_samples] → (confidences [B, k],
        indices [B, k] int32). A tensor already on the classifier's device
        is used where it lies."""
        k = min(k, self.num_species)
        with torch.inference_mode():
            with tracing.span("predict.step"):
                x = torch.as_tensor(pcm, dtype=torch.float32,
                                    device=self.device)
                conf = sigmoid_confidence(self.model.apply(x)["logits"],
                                          sensitivity)
                if self._range_mask is not None:
                    conf = conf * self._range_mask
                vals, idx = top_k_results(conf, k)
            # the copies wait for the card
            with tracing.span("predict.sync"):
                return vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()

    def embed(self, pcm: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            x = torch.as_tensor(np.asarray(pcm, np.float32),
                                device=self.device)
            return self.model.apply(x)["embedding"].cpu().numpy()


class TorchRangeFilter:
    """Geomodel-backed range filter (reference: onnx/rangefilter.go) on
    `device`, the card unless the caller passes another.

    On a card its work runs on a CUDA stream of its own (``stream``;
    ``ops/streams.py``), as the aux planes' does, and its scores come
    back into pinned memory (PyTorch's host cache keeps it for the next
    call). The API's range heatmap copies a [16,200, S] float32 array
    back (423 MB for v2.4's 6,522 species): on the served step's stream it
    queued between the step's batches, and a pageable copy, which CUDA
    stages through host buffers on the calling thread, held the step's
    launches back even from a stream of its own (``PERF.md`` §6)."""

    def __init__(self, geomodel: Geomodel,
                 device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.geomodel = geomodel.to(self.device).eval()
        self.stream = side_stream(self.device)
        if self.stream is not None:          # the weights' copy first
            self.stream.wait_stream(torch.cuda.current_stream(self.device))

    def _scores(self, coords) -> np.ndarray:
        with torch.inference_mode(), on_stream(self.stream):
            x = torch.as_tensor(np.asarray(coords, np.float32),
                                device=self.device)
            out = self.geomodel(x)
            if self.stream is None:                  # the CPU
                return out.numpy()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            self.stream.synchronize()
            return host.numpy()

    def predict(self, lat: float, lon: float, week: int) -> np.ndarray:
        """One location and week → scores [S]."""
        self._validate(lat, lon)
        return self._scores([[lat, lon, float(week)]])[0]

    def predict_batch(self, coords: np.ndarray) -> np.ndarray:
        """[N, 3] (lat, lon, week) → [N, S] scores (range heatmap path)."""
        return self._scores(coords)

    @staticmethod
    def _validate(lat: float, lon: float) -> None:
        # onnx/rangefilter.go:211-222 coordinate validation
        if not (-90.0 <= lat <= 90.0):
            raise ValueError(f"latitude {lat} outside [-90, 90]")
        if not (-180.0 <= lon <= 180.0):
            raise ValueError(f"longitude {lon} outside [-180, 180]")


def range_mask(rf: TorchRangeFilter, lat: float, lon: float, week: int,
               threshold: float = 0.01) -> np.ndarray:
    """The included-species mask for one location and week, float32 [S]:
    1 where the occurrence score reaches `threshold` (reference:
    BuildRangeFilter at startup, range_filter.go:100). It goes to
    ``TorchClassifier.set_range_mask``."""
    return (rf.predict(lat, lon, week) >= threshold).astype(np.float32)
