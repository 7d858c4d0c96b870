"""The benchmark of kubernetes_tpu_torch (README.md)."""
