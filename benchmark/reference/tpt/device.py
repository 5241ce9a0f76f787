"""Device selection for the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; raise if there is none.  Anything else is
    passed to ``torch.device`` (``"cpu"`` runs the kernels' plain
    PyTorch versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)
