"""The device an entry point of the port runs on.

The port runs on the card unless the caller asks for the CPU (as the CPU
tests do, with ``device="cpu"``).  It never falls back to the CPU by
itself: without a card, asking for the default raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """`device` as a torch.device; None is the current CUDA device, and a
    RuntimeError where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is False): the port "
            "runs on the card by default; pass device=\"cpu\" to run on "
            "the CPU")
    return torch.device("cuda", torch.cuda.current_device())
