"""Device resolution shared by every entry point of the port, and the
count of calls that synchronize the host with the card."""
from __future__ import annotations

import threading
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    There is no silent CPU fallback: without a card the caller must ask
    for the CPU explicitly (``device="cpu"``), as the tests do.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    return torch.device(device)



_HOST_SYNCS = threading.local()


def note_host_syncs(n: int = 1) -> None:
    """Record ``n`` calls that synchronize the host with a CUDA device: a
    read of a device value, a boolean-mask selection (torch reads its size
    back) or an upload from pageable host memory.  Each such call site
    records itself whatever the device, so the count is the same on the
    CPU, where nothing waits.  The count is per thread."""
    _HOST_SYNCS.n = host_sync_count() + n


def host_sync_count() -> int:
    """This thread's recorded host syncs so far (``note_host_syncs``)."""
    return getattr(_HOST_SYNCS, "n", 0)
