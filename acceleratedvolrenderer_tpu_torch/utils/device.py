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


def per_device(obj, device, make):
    """make(device), computed once per (obj, device) and kept on obj: the
    constant tensors of a scene object (a shape, a light) are copied to the
    card once, not in every iteration of a render loop."""
    cache = obj.__dict__.get("_device_cache")
    if cache is None:
        cache = {}
        object.__setattr__(obj, "_device_cache", cache)
    key = str(device)
    if key not in cache:
        cache[key] = make(device)
    return cache[key]
