"""Command-line entry points."""

import torch


def device_of(name: str) -> torch.device:
    """The torch device a CLI runs on. Exits with a message when a CUDA
    device is asked for (the default) and there is none: a CLI runs on the
    CPU only when told to (`--device cpu`)."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available; "
                         "pass --device cpu to run on the CPU")
    return device
