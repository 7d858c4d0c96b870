"""Runtime aliasing sanitizer for the device-upload seams.

PyTorch port of kubernetes_tpu/analysis/sanitize.py. The port's rule is
that every host buffer is COPIED on upload (convert.tensor_from_numpy):
the snapshot and the harvest mutate their numpy buffers in place while a
wave job may still read the tensors. Under ``GRAFT_SANITIZE=1`` the
upload helpers check that rule instead of trusting it:

- ``upload_copied(host, device)`` — seams whose contract is "the device
  gets its OWN buffer" (``_nodes_on_device``, the committed-occupancy
  seed): after the copy, assert the tensor does NOT share memory with the
  host source. On the CPU ``torch.from_numpy`` aliases its argument, so
  ``np.shares_memory`` sees straight through a constructor that silently
  degraded to an alias — the race class the copy rule exists for, caught
  at the seam instead of as a placement flake.
- ``upload_frozen(host, device)`` — seams whose host source is IMMUTABLE
  from now on (AffinityData tensors, the wave encodings' static topology
  views): the upload still copies, and sanitize mode seals the source
  (``ndarray.flags.writeable = False``) so a later in-place write dies at
  the WRITE site with numpy's read-only error.
- ``upload_view(host, device)`` — seams consumed synchronously by the
  caller (``predicates.node_arrays``): a copy, verified under sanitize.

The card adds no cross-stream form of the race on the wave path: a wave
job ends with its one device->host fetch (``packed.cpu()``) on the stream
that made its outputs, after the SPMD shards have joined that stream, so
every output is complete before the harvest can take the job's result.

With a mesh ``placement`` (parallel/mesh.Placement) the copy seams upload
one contiguous shard per mesh device (mesh.place_host); the checks run per
shard. With ``GRAFT_SANITIZE`` unset every helper is the copy it wraps,
plus one environment read per upload.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kubernetes_tpu_torch.convert import tensor_from_numpy

__all__ = ["AliasingViolation", "enabled", "freeze", "upload_copied",
           "upload_frozen", "upload_view"]


class AliasingViolation(RuntimeError):
    """A device upload that is contractually a copy aliases its host
    source — the data race the copy rule exists to prevent, observed
    live."""


def enabled() -> bool:
    """Read the knob per call (not cached): tests toggle it around
    individual drains, and a spawned process inherits it through the
    environment."""
    return os.environ.get("GRAFT_SANITIZE", "") == "1"


# indirection point: the deliberate-regression test swaps in an aliasing
# constructor (torch.from_numpy) to prove the shares-memory check fires
_copy_ctor = tensor_from_numpy


def upload_copied(host, device, placement=None):
    """Device upload with copy semantics, verified under GRAFT_SANITIZE=1.
    With `placement` the result is a mesh.ShardedTensor whose shards are
    contiguous copies of the host rows each device owns."""
    if placement is not None:
        from kubernetes_tpu_torch.parallel.mesh import place_host
        out = place_host(host, placement, _copy_ctor)
        if enabled() and isinstance(host, np.ndarray):
            for t in out.shards:
                _assert_no_alias(t, host)
        return out
    dev = _copy_ctor(host, device)
    if enabled() and isinstance(host, np.ndarray):
        _assert_no_alias(dev, host)
    return dev


def upload_frozen(host, device, placement=None):
    """Upload of a host buffer that is IMMUTABLE from this point on. The
    port copies it like every upload; sanitize mode verifies the copy and
    seals the source, so a violation crashes at the offending write."""
    out = upload_copied(host, device, placement)
    if enabled() and isinstance(host, np.ndarray):
        freeze(host)
    return out


def upload_view(host, device):
    """Upload consumed synchronously by the caller. The port copies it;
    sanitize mode verifies the copy."""
    return upload_copied(host, device)


def freeze(host: np.ndarray) -> np.ndarray:
    """Make every future in-place write to `host` raise. Reducing
    permissions is always legal, even on views; freezing a view does not
    freeze its base, so walk to the owner first when possible."""
    base = host
    while base.base is not None and isinstance(base.base, np.ndarray):
        base = base.base
    for arr in (base, host):
        try:
            arr.flags.writeable = False
        except ValueError:
            pass  # non-owning exotic view: freezing `host` itself suffices
    return host


def _assert_no_alias(dev, host: np.ndarray) -> None:
    if not isinstance(dev, torch.Tensor) or dev.device.type != "cpu":
        return  # a card's tensor lives in device memory: no alias possible
    if np.shares_memory(dev.numpy(), host):
        raise AliasingViolation(
            f"device upload of {host.shape} {host.dtype} buffer aliases its "
            "host source — a copy-contract seam degraded to zero-copy; "
            "upload with convert.tensor_from_numpy or fix the constructor")
