"""Device engines (PyTorch + CUDA): batched FM-index ranks, interval lists,
D bounds, exact search, the ring-queue inexact search and the queued
alignment pipeline."""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.  None means CUDA, and without a
    CUDA device that raises: the port never carries on on the CPU by
    itself (tests and `--device cpu` ask for the CPU explicitly)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bwbble_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' (CLI: --device cpu) to run "
                "the plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev


def index_device(didx, device=None) -> torch.device:
    """The device of `didx`, after checking that it is the one the caller
    asked for (None means CUDA)."""
    dev = resolve_device(device)
    if didx.device.type != dev.type:
        raise ValueError(f"index lives on {didx.device}, not on {dev}")
    return didx.device
