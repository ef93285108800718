"""Objectives of the port: every objective of the JAX package's factory."""

from .base import ObjectiveFunction, create_objective
from .binary import BinaryLogloss
