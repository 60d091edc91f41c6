"""Assigned-architecture configs (one module per arch) + registry."""
from .registry import ARCHS, get_config, get_smoke_config, input_specs, shape_cells  # noqa: F401
