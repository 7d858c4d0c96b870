"""graftlint over the port, and the runtime hazard checks its host modules
share.

- `lint` + `rules/`: the AST rules engine, copied from the reference
  (GL001–GL009, `# graftlint:` pragmas, JSON baselines). By default it
  lints the kubernetes_tpu_torch package directory. CLI:
  `python -m kubernetes_tpu_torch.analysis <paths>`.
- `lockcheck`: the lock-order checker armed by ``GRAFT_LOCKCHECK=1``.
- `sanitize`: the upload-seam aliasing checks armed by
  ``GRAFT_SANITIZE=1``.
"""

from kubernetes_tpu_torch.analysis.lint import (  # noqa: F401
    Finding,
    lint_gate,
    load_baseline,
    run_paths,
    write_baseline,
)
