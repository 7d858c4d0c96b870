"""graftlint rule registry: GL001-GL009, one module each.

A rule module exports `RULE` (the id) and `check(ctx, index) -> [Finding]`,
plus an optional `prepare(contexts, index)` hook run after pass 1 over the
WHOLE linted set (GL006 uses it to build the project-wide lock graph).
The engine (analysis/lint.py) applies pragma suppression and baselines;
rules only report.
"""

from kubernetes_tpu_torch.analysis.rules import (  # noqa: F401
    gl001_aliasing,
    gl002_hostsync,
    gl003_recompile,
    gl004_tracer,
    gl005_generation,
    gl006_lockorder,
    gl007_tornread,
    gl008_blockloop,
    gl009_spawnsafety,
)
from kubernetes_tpu_torch.analysis.rules.base import (  # noqa: F401
    FileContext,
    Finding,
    ProjectIndex,
)

ALL_RULES = (gl001_aliasing, gl002_hostsync, gl003_recompile,
             gl004_tracer, gl005_generation, gl006_lockorder,
             gl007_tornread, gl008_blockloop, gl009_spawnsafety)

RULE_IDS = tuple(m.RULE for m in ALL_RULES)

CATALOG = {
    "GL001": "aliasing upload: jnp.asarray of an in-place-mutated host "
             "buffer / broken copy-required seam",
    "GL002": "hidden device->host sync on a device value in the hot path",
    "GL003": "recompile hazard: jit built in a function/loop, ragged "
             "shapes into a jitted call in a loop",
    "GL004": "tracer leak: host state mutated inside a traced scope",
    "GL005": "snapshot dynamic-row write without dirty/generation bump",
    "GL006": "lock-order cycle / self-deadlock over the project-wide "
             "acquisition graph (declare with lock-order(...))",
    "GL007": "torn read/write: lock-guarded field accessed outside "
             "any lock region",
    "GL008": "blocking call (sleep, threading lock, socket op, device "
             "sync) on an asyncio event-loop thread",
    "GL009": "spawn-unsafe Process target: closure/bound-method "
             "entrypoint or module-global mutable/lock/device capture",
}
