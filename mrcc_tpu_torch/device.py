"""The port's device rule for its entry points: the card unless the
caller asks for another device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"`` and raises where no card is present; any
    other value is taken as given (``"cpu"`` runs the plain twins)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mrcc_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)
