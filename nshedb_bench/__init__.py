"""The benchmark of the NSHEDB port (`src/repro_torch`): one cell a run,
driven by the data under this directory (see harness.py)."""
