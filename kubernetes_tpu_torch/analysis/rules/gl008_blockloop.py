"""GL008 — blocking call on the event-loop thread.

The binary wire's whole design premise (r13) is ONE asyncio loop owning
every socket: accepts, frame parsing and response writes all run on the
loop thread, and anything that can block hops to the executor. That
invariant lived in prose ("the backend walk takes the backend lock —
off the event loop like every service touch"); this rule is the prose,
enforced. Inside `async def` bodies — excluding nested defs and
lambdas, which run on some OTHER call stack (the executor hop itself) —
four blocking shapes fire:

1. `time.sleep(...)` — the loop sleeps, every connection stalls (the
   async twin is `await asyncio.sleep`);
2. acquiring a threading lock: `with <lock>:` / `<lock>.acquire()` on a
   provable lock (class attr, local, or module lock) — under contention
   the loop parks on a host mutex while holding every socket;
3. blocking socket ops: `socket.create_connection`, `socket.getaddrinfo`
   and `.recv/.recv_into/.recvfrom/.accept/.sendall` method calls — the
   loop already owns the sockets; raw ops belong behind
   `loop.sock_*`/streams or on the executor;
4. a device->host sync on a jitted result (the GL002 registry's taint
   machinery, re-run here): fetching a device value parks the loop
   behind the accelerator queue — the one stall no executor hop hides.

Blessed hops — a provably tiny critical section the loop may take, a
deliberate startup-path block — carry `# graftlint: block-ok` naming
why the loop can afford it.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from kubernetes_tpu_torch.analysis.rules.base import (
    SYNC_BUILTINS,
    SYNC_METHODS,
    SYNC_WRAPPERS,
    FileContext,
    Finding,
    ProjectIndex,
    class_lock_attrs,
    dotted,
    functions_of,
    local_aliases,
    lock_ctor_kind,
    module_id,
    resolve,
    walk_shallow,
)
from kubernetes_tpu_torch.analysis.rules.gl002_hostsync import (
    _taint_events,
    _taint_of,
)

RULE = "GL008"

_SOCKET_FUNCS = frozenset({"socket.create_connection",
                           "socket.getaddrinfo", "socket.gethostbyname"})
_SOCKET_METHODS = frozenset({"recv", "recv_into", "recvfrom", "accept",
                             "sendall"})


def _lock_path(ctx: FileContext, fn: ast.AST, expr: ast.AST,
               aliases) -> Optional[str]:
    """The resolved dotted path when `expr` provably names a threading
    lock visible from `fn` (self attr / local binding / module lock)."""
    path = resolve(dotted(expr), aliases)
    if path is None:
        return None
    if path.startswith("self.") and path.count(".") == 1:
        attr = path.split(".", 1)[1]
        klass = ctx.enclosing_class(fn)
        if klass is not None and attr in class_lock_attrs(klass):
            return path
        return None
    if "." not in path:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) \
                    and any(isinstance(t, ast.Name) and t.id == path
                            for t in node.targets) \
                    and lock_ctor_kind(node.value) is not None:
                return path
    return None


def _module_lock(ctx: FileContext, index: ProjectIndex,
                 path: Optional[str]) -> bool:
    return path is not None and "." not in path and \
        f"{module_id(ctx.path)}.{path}" in index.module_locks


def check(ctx: FileContext, index: ProjectIndex) -> List[Finding]:
    findings: List[Finding] = []

    def fire(node: ast.AST, fn: ast.AST, what: str) -> None:
        findings.append(Finding(
            RULE, ctx.path, node.lineno, node.col_offset,
            f"{what} inside `async def` {fn.name} blocks the event-loop "
            "thread — every connection this loop owns stalls with it; "
            "hop to the executor (run_in_executor), use the async twin, "
            "or bless a provably tiny block with `# graftlint: "
            "block-ok`",
            context=ctx.qualname(fn)))

    for fn in functions_of(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        aliases = local_aliases(fn)
        events = _taint_events(fn, index.jitted_names)
        for node in walk_shallow(fn):
            if isinstance(node, ast.With):
                for item in node.items:
                    p = _lock_path(ctx, fn, item.context_expr, aliases)
                    if p is None and _module_lock(
                            ctx, index, dotted(item.context_expr)):
                        p = dotted(item.context_expr)
                    if p is not None:
                        fire(item.context_expr, fn,
                             f"acquiring threading lock {p}")
                continue
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if fname == "time.sleep":
                fire(node, fn, "time.sleep")
            elif fname in _SOCKET_FUNCS:
                fire(node, fn, f"blocking {fname}")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _SOCKET_METHODS:
                fire(node, fn, f"blocking socket .{node.func.attr}()")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "acquire":
                p = _lock_path(ctx, fn, node.func.value, aliases)
                if p is None and _module_lock(ctx, index,
                                              dotted(node.func.value)):
                    p = dotted(node.func.value)
                if p is not None:
                    fire(node, fn, f"acquiring threading lock {p}")
            else:
                forced = None
                why = None
                if fname in SYNC_WRAPPERS and node.args:
                    why = _taint_of(node.args[0], events, node.lineno)
                    forced = fname
                elif fname in SYNC_BUILTINS and len(node.args) == 1:
                    why = _taint_of(node.args[0], events, node.lineno)
                    forced = f"{fname}()"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in SYNC_METHODS:
                    why = _taint_of(node.func.value, events, node.lineno)
                    forced = f".{node.func.attr}()"
                if why is not None:
                    fire(node, fn,
                         f"device->host sync ({forced} on {why})")
    return findings
