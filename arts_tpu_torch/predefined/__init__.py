"""Predefined absorption models (port of arts_tpu/predefined)."""

from .models import PREDEF_MODELS, predefined_absorption  # noqa: F401
