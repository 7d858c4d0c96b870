from kubernetes_tpu_torch.cloud.provider import (  # noqa: F401
    CloudProvider,
    FakeCloud,
    GCELikeCloud,
    AWSLikeCloud,
    get_provider,
    register_provider,
)
