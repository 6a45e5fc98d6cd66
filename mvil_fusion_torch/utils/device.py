"""The device an entry point of the port runs on.

The port runs on the card unless the caller asks for the CPU (as the CPU
tests do, with ``device="cpu"``).  It never falls back to the CPU by
itself: without a card, asking for the default raises.
"""

from __future__ import annotations

import numpy as np
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


def upload(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A host array (or a tensor) as `dtype` on `device`, without waiting
    for the stream: a blocking copy of a host value to a card waits for
    it."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.ascontiguousarray(x))
    return x.to(device, dtype, non_blocking=True)


def work_event(device: torch.device):
    """An event recorded after the work queued so far on the current
    stream of `device` (a producer's last write, for a consumer on another
    stream to wait for), or None off the card."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev
