"""Device numerics: PCM conversion, the mel front end and its fused CUDA
kernel, the fused MBConv kernels, and post-processing; resampling, window
slicing and sound levels (``resample``, ``windows``, ``soundlevel``) for
offline analysis. Nothing here builds or loads the kernel library at
import time."""

from birdnet_go_tpu_torch.ops.melspec import MelConfig, frame_signal, melspec
from birdnet_go_tpu_torch.ops.pallas_mbconv import (
    expand_dw_pool,
    expand_dw_pool_plain,
    fused_block_ok,
    mbconv_fused,
    scale_project,
    scale_project_plain,
)
from birdnet_go_tpu_torch.ops.pallas_melspec import (
    melspec_fused,
    melspec_fused_plain,
)
from birdnet_go_tpu_torch.ops.pcm import float32_to_pcm16, pcm16_to_float32
from birdnet_go_tpu_torch.ops.postprocess import (
    apply_range_mask,
    occurrence_mask,
    sigmoid_confidence,
    top_k_results,
)

__all__ = [
    "MelConfig",
    "frame_signal",
    "melspec",
    "melspec_fused",
    "melspec_fused_plain",
    "expand_dw_pool",
    "expand_dw_pool_plain",
    "scale_project",
    "scale_project_plain",
    "fused_block_ok",
    "mbconv_fused",
    "pcm16_to_float32",
    "float32_to_pcm16",
    "sigmoid_confidence",
    "top_k_results",
    "apply_range_mask",
    "occurrence_mask",
]
