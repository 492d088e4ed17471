"""Device and process selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU by
name.  There is no silent fallback: without a card and without an explicit
CPU request they raise.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the current CUDA device; anything else is taken as
    given.  Raises when CUDA is asked for (explicitly or by default) and no
    card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def model_device(model: torch.nn.Module, device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device `model` lies on, after checking that it is the one the
    caller asked for (`resolve_device(device)`); raises when they differ."""
    dev = resolve_device(device)
    found = next(model.parameters()).device
    if found.type != dev.type:
        raise RuntimeError(f"the model lies on {found}, the caller asked for {dev}")
    return found


def process_topology() -> Tuple[int, int]:
    """(rank, world size) of the initialised `torch.distributed` group, else
    (0, 1): which slice of the data a process loads and which files it
    owns beside a checkpoint."""
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_rank(), torch.distributed.get_world_size()
    return 0, 1


def describe_device(device: Union[str, torch.device]) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them for a
    CUDA device (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"), else the device's
    type ("cpu"): what a measurement is written beside."""
    import subprocess

    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev.type
    index = torch.cuda.current_device() if dev.index is None else dev.index
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                          "-i", str(index)], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
