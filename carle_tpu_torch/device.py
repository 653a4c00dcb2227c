"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``"cuda"``, and asking for CUDA where there is none raises instead of
falling back to the CPU.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
