"""The device rule of the port's entry points: they run on the card unless
the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the CUDA device, or RuntimeError where there is none (the
    port never carries on on the CPU unasked); anything else ->
    torch.device(device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the card unless the "
                "caller passes device='cpu'")
        return torch.device("cuda")
    return torch.device(device)
