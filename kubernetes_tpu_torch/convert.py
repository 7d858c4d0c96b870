"""Carry the reference package's host arrays into the port's tensors.

The reference and the port build the same numpy arrays on the host (node
arrays from ClusterSnapshot, class arrays from PodBatch, affinity arrays
from AffinityData). ``arrays_from_numpy`` turns such a dict into the
port's tensor dict: every array is copied (never aliased, so a snapshot
that mutates its buffers in place cannot reach a tensor in use), dtypes
are kept, and uint32 arrays (``port_bitmap``) become int32 tensors
holding the same bits, since torch has no uint32 arithmetic.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def tensor_from_numpy(a, device) -> torch.Tensor:
    """One host array -> a fresh tensor on ``device``."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    a = np.array(a, copy=True, order="C")
    return torch.from_numpy(a).to(device)


def arrays_from_numpy(d: Mapping[str, np.ndarray],
                      device) -> Dict[str, torch.Tensor]:
    """Node, class or affinity array dict (numpy) -> tensor dict."""
    return {k: tensor_from_numpy(v, device) for k, v in d.items()}
