"""Device resolution for the port's entry points.

The port is written for one CUDA card. Entry points take an explicit
``device``; ``None`` means the card, and a missing card is an error,
never a silent fall-back to the CPU. ``device="cpu"`` is the caller's
explicit choice (the tests make it): every kernel wrapper then runs its
plain PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no CUDA device is visible);
    anything else is passed to ``torch.device`` unchanged."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "lightgbm_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def config_device(config):
    """The device a config's ``device_type`` names for the entry points
    that take only params (the CLI, ``task=pipeline``): ``cpu`` and
    ``cuda:<i>`` as given; anything else (the default ``cuda``, and the
    JAX package's ``tpu`` / ``gpu``) is None, the card."""
    dt = str(getattr(config, "device_type", "") or "").strip().lower()
    if dt == "cpu" or dt.startswith("cuda:"):
        return dt
    return None
