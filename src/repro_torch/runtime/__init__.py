"""Runtime substrate: typed faults and deterministic fault injection,
fault-tolerant checkpointing, elastic resharding, straggler detection."""
from .checkpoint import CheckpointManager  # noqa: F401
from .elastic import StragglerDetector, elastic_mesh_plan  # noqa: F401
