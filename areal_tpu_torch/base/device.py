"""Where the port's entry points run: the CUDA card unless told otherwise."""

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; a CUDA device without a card raises.
    Only an explicit "cpu" runs on the host."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "passes device='cpu'"
        )
    return device
