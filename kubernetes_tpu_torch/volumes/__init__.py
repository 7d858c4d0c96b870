"""The volume subsystem's plugin layer: plugin interface + drivers +
the kubelet-side volume manager (reference: pkg/volume/, 42.8k LoC)."""

from kubernetes_tpu_torch.volumes.plugins import (  # noqa: F401
    Attacher,
    Detacher,
    Mounter,
    Unmounter,
    VolumeHost,
    VolumePlugin,
    VolumePluginManager,
    VolumeSpec,
)
from kubernetes_tpu_torch.volumes.drivers import default_plugins  # noqa: F401
from kubernetes_tpu_torch.volumes.manager import VolumeManager  # noqa: F401
