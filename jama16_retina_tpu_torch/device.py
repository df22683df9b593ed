"""Device selection shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` means the card. Asking for the card where there is none
    raises: a run never drops to the CPU unless the caller said so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; want 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU deliberately"
        )
    return dev
