"""kubernetes_tpu_torch: the PyTorch/CUDA port of the kubernetes_tpu
scheduler, for an NVIDIA H100.

The port mirrors the reference package's layout (api/, state/, models/,
ops/, engine/) and imports nothing of it. Entry points run on the card
unless the caller names another device; see resolve_device.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means the card
    (``cuda``), and raises RuntimeError when there is none — no path
    quietly continues on the CPU. Anything else is taken as given
    (``"cpu"`` is how the tests ask for the CPU)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "kubernetes_tpu_torch runs on a CUDA device by default and "
                "none is available; pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)
