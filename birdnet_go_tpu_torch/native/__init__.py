"""ctypes bindings to the native host data plane (the repository's
``native/*.cpp``) and to the port's codec library (``csrc/codecs.cpp``),
each built on first use into ``build/torch_native/``; a failed build
raises. See ``native/lib.py``."""

from birdnet_go_tpu_torch.native.lib import (
    AlsaCapture,
    NativeAnalysisBuffer,
    StreamFarm,
    alsa_available,
    alsa_list_devices,
    available,
    avcodec_version,
    build_codecs,
    build_native,
    fill_provider,
    set_malloc_arena_max,
)

__all__ = [
    "available",
    "alsa_available",
    "alsa_list_devices",
    "avcodec_version",
    "build_codecs",
    "build_native",
    "fill_provider",
    "NativeAnalysisBuffer",
    "StreamFarm",
    "AlsaCapture",
    "set_malloc_arena_max",
]
