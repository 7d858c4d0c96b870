"""Shared AST plumbing for the graftlint rules.

Every rule is a pure function of one parsed file (`FileContext`) plus the
cross-file `ProjectIndex` (the jit registry — which bare names are jitted
callables anywhere in the linted set). Rules return `Finding`s; pragma
suppression and baselines are applied by the engine (analysis/lint.py), so
rules stay oblivious to both.

Design bias: PRECISION over recall. The clean-tree gate runs in tier-1, so
a false positive is a broken build for every future PR; a false negative is
just a hazard the next reviewer still has to catch by eye. Rules therefore
fire only on shapes they can actually prove from the AST (exact dotted
paths, same-function ordering, class-scoped lifetimes) and leave the
undecidable rest to the runtime sanitizer (analysis/sanitize.py).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
from typing import Dict, Iterator, List, Optional, Set, Tuple

# rule -> pragma tag that suppresses it (plus the generic disable=GLxxx)
SUPPRESS_TAGS = {
    "GL001": "alias-ok",
    "GL002": "sync-ok",
    "GL003": "recompile-ok",
    "GL004": "tracer-ok",
    "GL005": "gen-ok",
    "GL006": "lock-ok",
    "GL007": "torn-ok",
    "GL008": "block-ok",
    "GL009": "spawn-ok",
}

# WaveHandle fields documented as un-fetched DEVICE arrays: touching one
# with a sync-forcer is a pipeline stall whether or not the local dataflow
# shows the producing jit call (the handle crosses dispatch->harvest).
DEVICE_ATTRS = frozenset({"packed", "state_out", "counter_out",
                          "committed_out"})

# snapshot arrays mutated in place by the delta-refresh/assume machinery;
# a row write to one of these without a paired dirty-note/generation bump
# leaves every (vocab_gen/version)-keyed consumer reading a stale mirror
DYNAMIC_ATTRS = frozenset({
    "requested", "nonzero", "pod_count", "port_bitmap", "_raw_dyn",
    "vol_present", "vol_rw", "pd_present", "pd_counts", "labels",
    "image_sizes",
})

# ndarray methods that mutate the receiver in place
MUTATOR_METHODS = frozenset({"fill", "sort", "put", "partition", "resize",
                             "itemset", "setfield"})

SYNC_WRAPPERS = frozenset({"np.asarray", "np.array", "numpy.asarray",
                           "numpy.array", "jax.device_get"})
SYNC_METHODS = frozenset({"item", "tolist", "block_until_ready"})
SYNC_BUILTINS = frozenset({"float", "int", "bool"})

TRACE_CONSUMERS = frozenset({"while_loop", "scan", "cond", "fori_loop",
                             "switch", "vmap", "grad", "checkpoint",
                             "remat"})

# lock constructors the concurrency family (GL006-GL009) recognizes:
# the raw threading primitives AND the lockcheck factories the shipped
# tree uses (analysis/lockcheck.py — same object either way, plus the
# tsan-lite instrumentation under GRAFT_LOCKCHECK=1). kind matters:
# re-acquiring a non-reentrant "lock" on the same object is a provable
# self-deadlock; "rlock"/"condition" are reentrant.
LOCK_CTORS = {
    "threading.Lock": "lock", "Lock": "lock",
    "threading.RLock": "rlock", "RLock": "rlock",
    "threading.Condition": "condition", "Condition": "condition",
    "lockcheck.make_lock": "lock", "make_lock": "lock",
    "lockcheck.make_rlock": "rlock", "make_rlock": "rlock",
    "lockcheck.make_condition": "condition", "make_condition": "condition",
}

# container/ndarray methods that mutate the receiver in place — the
# write half of GL007's guarded-field accounting (MUTATOR_METHODS is the
# ndarray subset GL001/GL005 already key on)
MUTATING_METHODS = MUTATOR_METHODS | frozenset({
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "clear", "update", "setdefault", "add",
    "discard", "move_to_end",
})


@dataclasses.dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str
    context: str = ""  # enclosing qualname — the line-drift-stable anchor

    def fingerprint(self) -> str:
        """Stable identity for baseline suppression: deliberately excludes
        the line number so unrelated edits above a known finding don't
        un-suppress it."""
        raw = f"{self.rule}|{self.path}|{self.context}|{self.message}"
        return hashlib.sha1(raw.encode()).hexdigest()[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


class ProjectIndex:
    """Cross-file facts collected in a first pass over the whole linted set."""

    def __init__(self) -> None:
        # bare names that resolve to jit-compiled callables somewhere in the
        # set: decorated defs and module-level `NAME = jax.jit(...)` binds.
        # Imports carry the same bare name, so last-component matching on
        # call sites works across modules without an import resolver.
        self.jitted_names: Set[str] = set()
        # def names handed to jax.jit at module level (the wrapped function
        # itself is a traced scope for GL004 even though callers go through
        # the wrapper name)
        self.traced_defs: Set[str] = set()
        # class name -> {attr: lock kind} for every class in the linted set
        # that binds a threading/lockcheck primitive to self.<attr> (or a
        # class-level attr). Lock IDs are "<ClassName>.<attr>" — the same
        # spelling the lockcheck factories are handed at the call sites,
        # so the static graph and the runtime checker speak one namespace.
        self.lock_classes: Dict[str, Dict[str, str]] = {}
        # module-level locks: "<module id>.<name>" -> kind
        self.module_locks: Dict[str, str] = {}
        # GL006 project-wide state, filled by gl006_lockorder.prepare():
        # observed edges (a, b) -> [(path, qualname, b-site line)] meaning
        # lock b was acquired while a was held; declared edges from
        # `# graftlint: lock-order(a,b,...)` pragmas -> declaration site.
        self.lock_edges: Dict[Tuple[str, str], List[Tuple[str, str, int]]] \
            = {}
        self.lock_decls: Dict[Tuple[str, str], str] = {}

    def scan(self, tree: ast.Module, path: Optional[str] = None) -> None:
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_jit_expr(d) for d in node.decorator_list):
                    self.jitted_names.add(node.name)
                    self.traced_defs.add(node.name)
            elif isinstance(node, ast.ClassDef):
                attrs = class_lock_attrs(node)
                if attrs:
                    self.lock_classes.setdefault(node.name, {}).update(attrs)
        for stmt in tree.body:
            if isinstance(stmt, ast.Assign) and _is_jit_expr(stmt.value):
                for t in stmt.targets:
                    if isinstance(t, ast.Name):
                        self.jitted_names.add(t.id)
                call = stmt.value
                if isinstance(call, ast.Call):
                    for a in call.args:
                        if isinstance(a, ast.Name):
                            self.traced_defs.add(a.id)
            elif isinstance(stmt, ast.Assign):
                kind = lock_ctor_kind(stmt.value)
                if kind is not None:
                    mod = module_id(path) if path else "<module>"
                    for t in stmt.targets:
                        if isinstance(t, ast.Name):
                            self.module_locks[f"{mod}.{t.id}"] = kind


class FileContext:
    def __init__(self, path: str, source: str) -> None:
        self.path = path
        self.source = source
        self.tree = ast.parse(source, filename=path)
        self.pragmas: Dict[int, Set[str]] = _parse_pragmas(source)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent

    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def ancestors(self, node: ast.AST) -> Iterator[ast.AST]:
        cur = self._parents.get(node)
        while cur is not None:
            yield cur
            cur = self._parents.get(cur)

    def qualname(self, node: ast.AST) -> str:
        parts: List[str] = []
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(anc.name)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            parts.insert(0, node.name)
        return ".".join(reversed(parts))

    def enclosing_function(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def enclosing_class(self, node: ast.AST):
        for anc in self.ancestors(node):
            if isinstance(anc, ast.ClassDef):
                return anc
        return None

    def tags_at(self, line: int) -> Set[str]:
        return self.pragmas.get(line, set())

    def tags_for_span(self, lo: int, hi: int) -> Set[str]:
        out: Set[str] = set()
        for ln in range(lo, hi + 1):
            out |= self.pragmas.get(ln, set())
        return out

    def suppressed(self, rule: str, node: ast.AST) -> bool:
        """A finding anchored at `node` is suppressed by a matching pragma
        (a) on any physical line of the anchoring statement, (b) on the
        line directly above it, or (c) on the enclosing `def` line (or the
        line above THAT) — the function-scope form for seams whose whole
        body shares one justification."""
        want = {SUPPRESS_TAGS[rule], f"disable={rule}", "disable=all"}
        # anchor on the SMALLEST enclosing statement; for a compound
        # statement (with/if/for — and def/class, which are ast.stmt too)
        # use only its header lines, else one pragma would smear over the
        # whole body and silently bless unrelated findings inside it
        stmt = node
        if not isinstance(node, ast.stmt):
            for anc in self.ancestors(node):
                if isinstance(anc, ast.stmt):
                    stmt = anc
                    break
        lo = getattr(stmt, "lineno", node.lineno)
        hi = getattr(stmt, "end_lineno", lo) or lo
        body = getattr(stmt, "body", None)
        if isinstance(body, list) and body:
            hi = min(hi, body[0].lineno - 1)
        hi = max(hi, getattr(node, "end_lineno", lo) or lo)
        if (self.tags_for_span(lo, hi) | self.tags_at(lo - 1)) & want:
            return True
        fn = self.enclosing_function(node)
        while fn is not None:
            d = fn.lineno
            span = self.tags_at(d) | self.tags_at(d - 1)
            for dec in fn.decorator_list:
                span |= self.tags_at(dec.lineno)
            if span & want:
                return True
            fn = self.enclosing_function(fn)
        return False


_TAG_CHARS = set("abcdefghijklmnopqrstuvwxyz0123456789-=_,GL")


def _parse_pragmas(source: str) -> Dict[int, Set[str]]:
    """line (1-based) -> pragma tags. Grammar: `# graftlint: tag [tag ...]`
    followed by optional free prose (anything that stops looking like a
    tag ends the tag list — em-dashes, parens, capitalized words).

    A pragma inside a FULL-LINE comment block also applies to the first
    code line after the block, so a multi-line justification above a def
    still reaches it."""
    out: Dict[int, Set[str]] = {}
    lines = source.splitlines()
    for i, raw in enumerate(lines, start=1):
        pos = raw.find("graftlint:")
        if pos < 0 or "#" not in raw[:pos]:
            continue
        tags: Set[str] = set()
        for tok in raw[pos + len("graftlint:"):].split():
            tok = tok.strip(",;")
            if not tok or not set(tok) <= _TAG_CHARS:
                break
            for part in tok.split(","):
                if part:
                    tags.add(part)
        if tags:
            out.setdefault(i, set()).update(tags)
            if raw.lstrip().startswith("#"):
                j = i  # 0-based index of the NEXT line
                while j < len(lines) and lines[j].lstrip().startswith("#"):
                    j += 1
                if j < len(lines):
                    out.setdefault(j + 1, set()).update(tags)
    return out


# ------------------------------------------------------------- AST helpers


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` as a string for Name/Attribute chains, else None."""
    parts: List[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def last_component(path: str) -> str:
    return path.rsplit(".", 1)[-1]


def chain_without_root(path: str) -> str:
    """`enc.committed_nodes` -> `committed_nodes`; bare names -> ''."""
    _, _, rest = path.partition(".")
    return rest


def _is_jit_expr(node: ast.AST) -> bool:
    """jax.jit(...) / @jax.jit / functools.partial(jax.jit, ...) /
    @partial(jax.jit, ...)"""
    if isinstance(node, ast.Call):
        fn = dotted(node.func)
        if fn in ("jax.jit", "jit"):
            return True
        if fn is not None and last_component(fn) == "partial":
            return any(dotted(a) in ("jax.jit", "jit") for a in node.args)
        return False
    return dotted(node) in ("jax.jit", "jit")


def local_aliases(fn: ast.AST) -> Dict[str, str]:
    """name -> dotted path for simple `name = obj.attr[...]`-free aliases
    (`requested = self.requested`), resolved ONE level. A name rebound more
    than once is dropped — ambiguous aliases must not match anything."""
    seen: Dict[str, Optional[str]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            name = node.targets[0].id
            path = dotted(node.value)
            if name in seen:
                seen[name] = None
            else:
                seen[name] = path if path is not None and "." in path \
                    else None
    return {k: v for k, v in seen.items() if v}


def resolve(path: Optional[str], aliases: Dict[str, str]) -> Optional[str]:
    if path is None:
        return None
    root, sep, rest = path.partition(".")
    if root in aliases:
        return aliases[root] + (sep + rest if rest else "")
    return path


def mutations_in(fn: ast.AST, aliases: Dict[str, str]
                 ) -> List[Tuple[str, int]]:
    """(dotted path, line) of every in-place buffer mutation in `fn`:
    subscript stores, augmented assigns, `np.<ufunc>.at(x, ...)`, and the
    in-place ndarray methods. Paths are alias-resolved."""
    out: List[Tuple[str, int]] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, ast.AugAssign):
            targets = [node.target]
        else:
            targets = []
        for t in targets:
            if isinstance(t, ast.Subscript):
                p = resolve(dotted(t.value), aliases)
                if p:
                    out.append((p, node.lineno))
            elif isinstance(node, ast.AugAssign):
                p = resolve(dotted(t), aliases)
                if p:
                    out.append((p, node.lineno))
        if isinstance(node, ast.Call):
            fname = dotted(node.func)
            if fname and fname.endswith(".at") and node.args \
                    and fname.count(".") >= 2:
                # np.add.at(x, idx, v) / np.subtract.at / ...
                p = resolve(dotted(node.args[0]), aliases)
                if p:
                    out.append((p, node.lineno))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in MUTATOR_METHODS:
                p = resolve(dotted(node.func.value), aliases)
                if p:
                    out.append((p, node.lineno))
    return out


def functions_of(tree: ast.Module) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


# ------------------------------------------------------------ lock helpers


def lock_ctor_kind(node: ast.AST) -> Optional[str]:
    """"lock" / "rlock" / "condition" when `node` is a call to a known
    lock constructor (threading primitive or lockcheck factory), else
    None."""
    if isinstance(node, ast.Call):
        fn = dotted(node.func)
        if fn in LOCK_CTORS:
            return LOCK_CTORS[fn]
    return None


def class_lock_attrs(klass: ast.ClassDef) -> Dict[str, str]:
    """attr -> lock kind for every `self.<attr> = <lock ctor>` (or
    class-level `<attr> = <lock ctor>`) binding inside the class body."""
    attrs: Dict[str, str] = {}
    for node in ast.walk(klass):
        if not isinstance(node, ast.Assign):
            continue
        kind = lock_ctor_kind(node.value)
        if kind is None:
            continue
        for t in node.targets:
            p = dotted(t)
            if p is not None and p.startswith("self.") and p.count(".") == 1:
                attrs[p.split(".", 1)[1]] = kind
            elif isinstance(t, ast.Name):
                attrs[t.id] = kind
    return attrs


def module_id(path: str) -> str:
    """A short dotted module id for lock naming: the file path with the
    extension, path separators and any leading `kubernetes_tpu_torch.`
    prefix folded away (`kubernetes_tpu_torch/api/pb/__init__.py` ->
    `api.pb`), so the port's lock ids read like the reference's. Files
    outside a package tree reduce to their stem (`snippet.py` ->
    `snippet`)."""
    p = path.replace("\\", "/")
    if p.endswith(".py"):
        p = p[:-3]
    parts = [c for c in p.split("/") if c not in ("", ".", "..")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    if parts and parts[0] == "kubernetes_tpu_torch":
        parts = parts[1:]
    return ".".join(parts[-3:]) if parts else "<module>"


def walk_shallow(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk `fn`'s body WITHOUT descending into nested function/lambda
    bodies — their statements run on some other call stack (an executor
    hop, a callback), so they must not be attributed to `fn`'s own
    execution context (GL008's whole point is WHICH thread runs a
    statement)."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
