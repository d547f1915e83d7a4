"""Device choice for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device" = "cuda") -> torch.device:
    """The device an entry point runs on: the CUDA card unless the
    caller asks for another. Asking for CUDA where there is no card
    raises rather than running on the CPU behind the caller's back;
    pass ``device="cpu"`` to ask for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return device
