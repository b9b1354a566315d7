"""Device choice and numerics of the port.

Entry points take `device=None`, meaning the CUDA card; a caller who wants
the CPU says `device="cpu"`. With no card and no explicit request they
raise instead of falling back.

Numerics: f32 throughout, TF32 off. TF32 keeps ~10 mantissa bits; raw
LiDAR coordinates run to ~45 m, where a TF32 contraction corrupts squared
distances by metres squared (the Hopper form of the bf16 hazard the JAX
package pins away with precision=HIGHEST). Deterministic algorithms are on,
so the same scans give the same poses on the card.
"""

from __future__ import annotations

import os
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def pin_numerics() -> None:
    """TF32 off everywhere, full-f32 matmuls, deterministic algorithms."""
    # cuBLAS needs a fixed workspace for reproducible matmuls; it is read
    # when the first cuBLAS handle is made
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    torch.use_deterministic_algorithms(True)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    Raises RuntimeError when no card is present and `device` is None.
    """
    pin_numerics()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mrg_slam_tpu_torch runs on a CUDA card and none is "
                "available; pass device='cpu' to run the plain versions")
        return torch.device("cuda")
    return torch.device(device)
