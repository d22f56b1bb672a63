"""Device resolution for every entry point of the port.

The JAX package picks its backend through ``jax.devices()``; the port
runs on ``cuda`` unless the caller passes ``device="cpu"`` explicitly.
A missing GPU is an error, never a silent move to the CPU: a CPU run
would report host speeds under a device's name.

This is also the one place the port sets its float32 matmul policy:
TF32 is switched off for matmuls and cuDNN, because the bf16x3
certificate tolerance ``2^-14 (||q||^2 + max||t||^2)``
(knn_tpu/ops/pallas_knn.py kernel_tolerance) assumes exact bf16
products accumulated in f32, and the f32 paths assume full f32.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def set_precision_policy() -> None:
    """No TF32 anywhere: f32 matmuls run in full f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``cuda``.  Raises when CUDA is asked for (explicitly
    or by default) and no GPU is visible."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "knn_tpu_torch runs on a CUDA GPU and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        set_precision_policy()
    elif dev.type != "cpu":
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    return dev


def synchronize(device: Optional[torch.device]) -> None:
    """Wait for queued GPU work on ``device`` (no-op on the CPU)."""
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)
