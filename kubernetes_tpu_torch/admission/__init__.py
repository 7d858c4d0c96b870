from kubernetes_tpu_torch.admission.chain import (  # noqa: F401
    AdmissionChain,
    AdmissionRequest,
    Rejected,
    default_plugins,
)
