"""A system under test, one module a kind of configuration: set-up, one
query at a time, the launch counts, and the check against the plain
reference."""


def sync(device) -> None:
    """Wait for the device (a no-op off the card)."""
    if device.type == "cuda":
        import torch
        torch.cuda.synchronize(device)
