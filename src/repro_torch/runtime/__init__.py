"""Runtime substrate: typed faults and deterministic fault injection."""
