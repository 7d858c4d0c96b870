from kubernetes_tpu_torch.quota.evaluator import (  # noqa: F401
    pod_usage,
    object_count_usage,
    usage_for,
    quota_scopes_match,
    add_usage,
    sub_usage,
    exceeds,
)
