"""Utilities of the PyTorch port: logging, device resolution, the
reference's LCG (``ref_random``) and ``jax.random``'s threefry draws in
integer PyTorch (``threefry``)."""

from .device import resolve_device
from .log import LightGBMError, log_fatal, log_info, log_warning
