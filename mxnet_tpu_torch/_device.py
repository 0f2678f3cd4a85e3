"""Device selection for the port's entry points: the card unless the
caller asks for the CPU."""
from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device", "bind_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a :class:`torch.device`, ``cuda`` when it is None.
    Raises when CUDA is asked for (explicitly or by default) and no
    CUDA device is available — the port never drops to the CPU on its
    own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (device=%r); pass device='cpu' "
            "to run on the CPU" % (str(dev),))
    return dev


def bind_device(device) -> None:
    """Make ``device`` the calling thread's current CUDA device
    (``torch.cuda``'s current device is per thread).  ``cuda`` without
    an index means the current one; CPU devices need nothing."""
    if isinstance(device, torch.device) and device.type == "cuda" \
            and device.index is not None:
        torch.cuda.set_device(device.index)
