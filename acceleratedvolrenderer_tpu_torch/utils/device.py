"""The device an entry point runs on."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.  Without CUDA
    and without an explicit device this raises: an entry point never falls
    back to the CPU unless asked (device="cpu")."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda")
