"""ktctl: the kubectl-equivalent CLI.

Command palette mirrors pkg/kubectl/cmd/cmd.go NewKubectlCommand's verbs that
operate on this control plane (reference: pkg/kubectl, 69k LoC — resource
builder in pkg/kubectl/resource, printers in pkg/printers):

  get | describe | create -f | apply -f | delete | scale | label | annotate |
  taint | cordon | uncordon | drain | rollout (status|history|undo) |
  top node | api-resources | version

Resource aliasing matches kubectl's short names (po, no, svc, rs, rc,
deploy, sts, ds, ns, pv, pvc, quota, sa, cm, pdb). Output: table (default),
-o wide | json | yaml | name. The backend is either an in-process ApiServer
or a RestServer URL (--server) — both expose the same verbs, like kubectl
against the secure/insecure ports.

`apply` is kubectl's full THREE-way strategic merge
(pkg/kubectl/cmd/apply.go:658, patch.go CreateThreeWayMergePatch): the
patch combines deletions from (last-applied, manifest) with
additions/updates from (live, manifest), played onto the live object —
manifest-dropped fields are pruned, live drift on manifest-specified
fields is reverted, and controller-owned fields survive untouched
(cli/strategicpatch.py; `diff` previews the same merge).

PyTorch port of kubernetes_tpu/cli/ktctl.py. One departure: PyYAML is
imported by the three places that read or write YAML (`-o yaml`, manifest
loading for `create -f` / `apply -f` / `diff`, and `edit`), not at module
level, so every other verb works where PyYAML is not installed."""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Sequence

from kubernetes_tpu_torch.api import wire
from kubernetes_tpu_torch.api.cluster import Eviction
from kubernetes_tpu_torch.api.types import Node, Pod, Taint, TaintEffect
from kubernetes_tpu_torch.server.apiserver import ApiServer, KIND_INFO

LAST_APPLIED = "kubectl.kubernetes.io/last-applied-configuration"

_ABSENT = object()  # _project_to_raw sentinel (None is a real YAML value)

ALIASES = {
    "po": "pods", "pod": "pods",
    "no": "nodes", "node": "nodes",
    "svc": "services", "service": "services",
    "rs": "replicasets", "replicaset": "replicasets",
    "rc": "replicationcontrollers",
    "deploy": "deployments", "deployment": "deployments",
    "sts": "statefulsets", "statefulset": "statefulsets",
    "ds": "daemonsets", "daemonset": "daemonsets",
    "ns": "namespaces", "namespace": "namespaces",
    "pv": "persistentvolumes", "pvc": "persistentvolumeclaims",
    "quota": "resourcequotas", "sa": "serviceaccounts",
    "cm": "configmaps", "secret": "secrets",
    "pdb": "poddisruptionbudgets", "ep": "endpoints",
    "job": "jobs", "limits": "limitranges",
    "ev": "events", "event": "events",
}
RESOURCE_TO_KIND = {res: kind for kind, (res, _) in KIND_INFO.items()}


def resolve_kind(arg: str) -> str:
    res = ALIASES.get(arg.lower(), arg.lower())
    kind = RESOURCE_TO_KIND.get(res)
    if kind is None:
        # allow exact kind names too
        for k in KIND_INFO:
            if k.lower() == arg.lower():
                return k
        raise SystemExit(f"error: the server doesn't have a resource type "
                         f"{arg!r}")
    return kind


def kind_plural(kind: str) -> str:
    return KIND_INFO.get(kind, (kind.lower() + "s", False))[0]


# ---------------------------------------------------------------- printers

def _pod_row(p: Pod) -> List[str]:
    ready = "1/1" if p.phase == "Running" else "0/1"
    return [p.name, ready, p.phase, p.node_name or "<none>"]


def _node_row(n: Node) -> List[str]:
    status = "Ready" if n.is_ready() else "NotReady"
    if n.unschedulable:
        status += ",SchedulingDisabled"
    return [n.name, status, str(n.allocatable.milli_cpu) + "m",
            str(n.allocatable.memory)]


HEADERS = {
    "Pod": ["NAME", "READY", "STATUS", "NODE"],
    "Node": ["NAME", "STATUS", "CPU", "MEMORY"],
}


def table(kind: str, objs: Sequence[Any], wide: bool = False) -> str:
    if kind == "Pod":
        rows = [_pod_row(o) for o in objs]
        headers = HEADERS["Pod"]
    elif kind == "Node":
        rows = [_node_row(o) for o in objs]
        headers = HEADERS["Node"]
    elif hasattr(objs[0] if objs else None, "replicas"):
        headers = ["NAME", "DESIRED", "READY"]
        rows = [[o.name, str(getattr(o, "replicas", "")),
                 str(getattr(o, "ready_replicas", ""))] for o in objs]
    else:
        headers = ["NAME", "NAMESPACE"]
        rows = [[getattr(o, "name", ""), getattr(o, "namespace", "")]
                for o in objs]
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for r in rows:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)


def jsonpath_get(doc: Any, path: str) -> List[Any]:
    """The jsonpath subset kubectl output uses most (pkg/util/jsonpath):
    dotted fields, [N] indexing, [*] fan-out — '{.items[*].name}'.
    Returns the list of leaf matches."""
    path = path.strip()
    if path.startswith("{") and path.endswith("}"):
        path = path[1:-1]
    cur = [doc]
    for raw in filter(None, path.replace("]", "").split(".")):
        # a segment may carry an index suffix: "items[*" / "conditions[0"
        parts = raw.split("[")
        fieldname, indices = parts[0], parts[1:]
        nxt: List[Any] = []
        for c in cur:
            if fieldname:
                if not isinstance(c, dict) or fieldname not in c:
                    continue
                c = c[fieldname]
            vals = [c]
            for idx in indices:
                stepped: List[Any] = []
                for v in vals:
                    if not isinstance(v, list):
                        continue
                    if idx == "*":
                        stepped.extend(v)
                    else:
                        try:
                            i = int(idx)
                        except ValueError:
                            # filters/slices are outside the subset —
                            # fail like every other bad CLI input
                            raise SystemExit(
                                f"error: unsupported jsonpath "
                                f"expression [{idx}] (only [N] and [*] "
                                f"indexing is supported)") from None
                        if -len(v) <= i < len(v):
                            stepped.append(v[i])
                vals = stepped
            nxt.extend(vals)
        cur = nxt
    return cur


def _fmt_cell(v: Any) -> str:
    if v is None:
        return "<none>"
    if isinstance(v, (dict, list)):
        return json.dumps(v, default=str)
    return str(v)


def render(kind: str, objs: Sequence[Any], output: str,
           plural: str = "", sort_by: str = "") -> str:
    encoded = None
    if sort_by or output.startswith(("custom-columns=", "jsonpath=")):
        encoded = [wire.encode(o, kind=kind) for o in objs]
    if sort_by:
        # kubectl --sort-by: a jsonpath over each row (pkg/kubectl/
        # sorting_printer.go); unkeyed rows sort first, numeric keys
        # compare numerically (900 before 1000, not lexicographically)
        def keyf(pair):
            hits = jsonpath_get(pair[0], sort_by)
            if not hits:
                return (0, 0, 0.0, "")
            v = hits[0]
            if isinstance(v, bool) or not isinstance(v, (int, float)):
                try:
                    return (1, 0, float(v), "")
                except (TypeError, ValueError):
                    return (1, 1, 0.0, str(v))
            return (1, 0, float(v), "")
        order = sorted(zip(encoded, objs), key=keyf)
        encoded = [e for e, _ in order]
        objs = [o for _, o in order]
    if output.startswith("custom-columns="):
        # NAME:.path,HEADER:.other.path (pkg/printers/customcolumn.go)
        cols = []
        for spec in output[len("custom-columns="):].split(","):
            header, _, path = spec.partition(":")
            cols.append((header, path))
        rows = [[_fmt_cell((jsonpath_get(e, p) or [None])[0])
                 for _h, p in cols] for e in encoded]
        headers = [h for h, _p in cols]
        widths = [max(len(h), *(len(r[i]) for r in rows)) if rows
                  else len(h) for i, h in enumerate(headers)]
        lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
        lines += ["  ".join(c.ljust(w) for c, w in zip(r, widths))
                  for r in rows]
        return "\n".join(lines)
    if output.startswith("jsonpath="):
        # applied to the List document like kubectl ({.items[*].name})
        doc = {"kind": kind + "List", "items": encoded}
        hits = jsonpath_get(doc, output[len("jsonpath="):])
        return " ".join(_fmt_cell(h) for h in hits)
    if output == "json":
        return json.dumps(
            encoded if encoded is not None
            else [wire.encode(o, kind=kind) for o in objs], indent=2)
    if output == "yaml":
        import yaml
        return yaml.safe_dump(
            encoded if encoded is not None
            else [wire.encode(o, kind=kind) for o in objs])
    if output == "name":
        res = plural or kind_plural(kind)
        return "\n".join(f"{res}/{getattr(o, 'name', '')}" for o in objs)
    return table(kind, objs, wide=(output == "wide"))


def describe(kind: str, obj: Any) -> str:
    enc = wire.encode(obj, kind=kind)
    lines = [f"Name:       {enc.pop('name', '')}"]
    if "namespace" in enc:
        lines.append(f"Namespace:  {enc.pop('namespace')}")
    for k, v in enc.items():
        lines.append(f"{k}: {json.dumps(v, default=str)}"
                     if not isinstance(v, str) else f"{k}: {v}")
    return "\n".join(lines)


# --------------------------------------------------------------- the tool

class _BoundApi:
    """Binds a client credential onto every authenticated verb — the
    kubeconfig current-context: ktctl code stays credential-agnostic and
    the secure-port path just works (client-go's rest.Config analog)."""

    _CRED_VERBS = frozenset({
        "create", "get", "list", "update", "delete", "scale", "evict",
        "bind", "bind_many", "update_status", "watch_since",
        "finalize_namespace"})

    def __init__(self, api, cred):
        self._api = api
        self._cred = cred

    def __getattr__(self, name):
        fn = getattr(self._api, name)
        if name in self._CRED_VERBS:
            import functools
            return functools.partial(fn, cred=self._cred)
        return fn


class Ktctl:
    """The CLI against an in-process ApiServer (tests, single binary) or a
    remote REST endpoint (via RestClient below)."""

    def __init__(self, api: ApiServer, out=None, federation=None,
                 federation_contexts=None, cred=None,
                 kubeconfig: Optional[str] = None, kubelets=None):
        # `kubelets`: node name -> kubelet API base URL (nodes/
        # kubelet_server.py) or in-process HollowKubelet — the routing
        # table `logs`/`exec` use, the way kubectl reaches kubelets
        # through the apiserver proxy
        self.kubelets = kubelets or {}
        if kubeconfig is not None:
            # a ktadm-written kubeconfig (cli/ktadm.py phase_kubeconfig):
            # carry its identity record as the client credential
            from kubernetes_tpu_torch.auth.authn import Credential
            with open(kubeconfig) as f:
                cfg = json.load(f)
            cred = Credential(cert=cfg["cert"])
        # only the in-process ApiServer takes per-call credentials; a
        # RestClient authenticates at the transport (its bearer token)
        self.api = api if cred is None or not isinstance(api, ApiServer) \
            else _BoundApi(api, cred)
        self.out = out if out is not None else sys.stdout
        # kubefed mode (cmd_federate): `federation` is a
        # FederationControlPlane, `federation_contexts` maps cluster name ->
        # member ApiServer (the kubeconfig-contexts analog kubefed joins by)
        self.federation = federation
        self.federation_contexts = federation_contexts or {}

    def _print(self, s: str) -> None:
        self.out.write(s + "\n")

    # each method returns the text it printed (handy for tests)

    def run(self, argv: Sequence[str]) -> int:
        if not argv:
            self._print("ktctl controls the kubernetes_tpu control plane")
            return 0
        cmd, *rest = argv
        fn = getattr(self, "cmd_" + cmd.replace("-", "_"), None)
        if fn is None:
            self._print(f"error: unknown command {cmd!r}")
            return 1
        # kubectl --as / --as-group: rebind this invocation's credential
        # with impersonation headers (the server's impersonation filter
        # authorizes the REAL user for the impersonate verb)
        restore = None
        try:
            has_as = any(a == "--as" or a.startswith("--as=")
                         or a == "--as-group"
                         or a.startswith("--as-group=") for a in rest)
            if cmd != "auth" and has_as:
                # (`auth can-i --as` consumes the flag itself — it runs a
                # SubjectAccessReview about the target, not as them)
                if not isinstance(self.api, _BoundApi):
                    # silently running at the caller's full privilege
                    # would make "can X do this?" probes lie
                    raise SystemExit(
                        "error: --as requires an authenticated "
                        "in-process backend (credential-bound)")
                import dataclasses as _dc
                # normalize the equals form kubectl users routinely type
                # (--as=user) so it cannot slip past as an ordinary flag
                norm = []
                for a in rest:
                    if a.startswith("--as="):
                        norm += ["--as", a.split("=", 1)[1]]
                    elif a.startswith("--as-group="):
                        norm += ["--as-group", a.split("=", 1)[1]]
                    else:
                        norm.append(a)
                rest = norm
                as_user, as_groups = "", []
                while "--as" in rest:
                    i = rest.index("--as")
                    if i + 1 >= len(rest):
                        raise SystemExit(
                            "error: flag --as needs an argument")
                    as_user = rest[i + 1]
                    del rest[i:i + 2]
                while "--as-group" in rest:
                    i = rest.index("--as-group")
                    if i + 1 >= len(rest):
                        raise SystemExit(
                            "error: flag --as-group needs an argument")
                    as_groups.append(rest[i + 1])
                    del rest[i:i + 2]
                if as_groups and not as_user:
                    raise SystemExit(
                        "error: --as-group requires --as (kubectl "
                        "rejects group-only impersonation)")
                restore = self.api
                self.api = _BoundApi(restore._api, _dc.replace(
                    restore._cred, impersonate_user=as_user,
                    impersonate_groups=tuple(as_groups)))
            rc = fn(rest)
            # verbs with exit-code semantics beyond ok/error (diff's
            # "1 = differences found") return an int
            return rc if isinstance(rc, int) else 0
        except SystemExit as e:
            self._print(str(e))
            return 1
        finally:
            if restore is not None:
                self.api = restore

    # flags that never take a value (boolean presence flags)
    BOOL_FLAGS = frozenset({"all-namespaces", "watch", "wide", "force",
                            "ignore-daemonsets"})

    @classmethod
    def _flags(cls, args: List[str]) -> (List[str], Dict[str, str]):
        pos, flags = [], {}
        i = 0
        while i < len(args):
            a = args[i]
            if a.startswith("--"):
                if "=" in a:
                    k, _, v = a[2:].partition("=")
                    flags[k] = v
                elif a[2:] in cls.BOOL_FLAGS or i + 1 >= len(args) \
                        or args[i + 1].startswith("-"):
                    flags[a[2:]] = ""
                else:
                    flags[a[2:]] = args[i + 1]
                    i += 1
            elif a == "-n":
                flags["namespace"] = args[i + 1]
                i += 1
            elif a == "-o":
                flags["output"] = args[i + 1]
                i += 1
            elif a == "-f":
                flags["filename"] = args[i + 1]
                i += 1
            elif a == "-l":
                flags["selector"] = args[i + 1]
                i += 1
            elif a == "-p":
                flags["patch"] = args[i + 1]
                i += 1
            else:
                pos.append(a)
            i += 1
        return pos, flags

    # -- dynamic resource resolution (discovery-backed, CRDs included) ----

    def _discovery_resources(self) -> List[Dict[str, Any]]:
        try:
            return self.api.discovery().get("resources", [])
        except Exception:
            return []

    def _resolve_kind(self, arg: str) -> str:
        """Builtin aliases first, then the discovery doc — so
        `ktctl get tputopologies` (or a CRD short name) works as soon as
        the CRD is Established, like kubectl's RESTMapper over the
        discovery client."""
        try:
            return resolve_kind(arg)
        except SystemExit:
            low = arg.lower()
            res = ALIASES.get(low, low)
            for r in self._discovery_resources():
                if not r.get("group"):
                    continue
                if r["name"] == res or r["kind"].lower() == low or low in \
                        [s.lower() for s in r.get("shortNames", [])]:
                    return r["kind"]
            raise

    def _cluster_scoped(self, kind: str) -> bool:
        if kind in KIND_INFO:
            return KIND_INFO[kind][1]
        for r in self._discovery_resources():
            if r["kind"] == kind:
                return not r["namespaced"]
        return False

    def _plural(self, kind: str) -> str:
        """Resource name for output (`pods/x created`, `-o name`) — the
        discovery doc is authoritative for CRD kinds, so the printed name
        round-trips back into ktctl."""
        if kind in KIND_INFO:
            return KIND_INFO[kind][0]
        for r in self._discovery_resources():
            if r["kind"] == kind:
                return r["name"]
        return kind_plural(kind)

    def _objs_rv(self, kind: str, ns: str, name: str = "",
                 selector: str = "", field_selector: str = ""):
        """_objs plus the list resourceVersion — the watch path needs the
        rv of the SAME snapshot the table rendered, or events landing
        between two lists are lost."""
        objs = self._objs(kind, ns, name, selector, field_selector,
                          _rv_box=(box := []))
        return objs, (box[0] if box else 0)

    def _objs(self, kind: str, ns: str, name: str = "",
              selector: str = "", field_selector: str = "",
              _rv_box=None) -> List[Any]:
        if name:
            if selector or field_selector:
                # kubectl refuses a resource name combined with selectors
                # — silently ignoring the filter the user typed is worse
                raise SystemExit(
                    "error: selectors cannot be combined with a "
                    "resource name")
            return [self.api.get(kind, ns if not self._cluster_scoped(kind) else "",
                                 name)]
        from kubernetes_tpu_torch.cli.rest_client import HttpError
        from kubernetes_tpu_torch.server.apiserver import Invalid
        # field AND namespace selection run SERVER-side (the reference's
        # namespaced list endpoints scope the RBAC check too — a user
        # with only a namespaced Role must be able to `get pods -n ns`);
        # kwargs are passed only when set so a bare ApiServerLite backend
        # (kubefed's member clusters) keeps working
        kwargs = {}
        if field_selector:
            kwargs["field_selector"] = field_selector
        namespaced = not self._cluster_scoped(kind) and ns != "*"
        if namespaced:
            kwargs["namespace"] = ns
        if kwargs:
            # signature check, NOT try/except TypeError: a TypeError
            # raised inside a supporting backend must surface, not
            # silently retry with the user's filters stripped
            import inspect
            try:
                params = inspect.signature(self.api.list).parameters
                supported = all(k in params for k in kwargs)
            except (TypeError, ValueError):
                supported = False
            if not supported:
                kwargs = {}
        try:
            objs, rv = self.api.list(kind, **kwargs)
            if _rv_box is not None:
                _rv_box.append(rv)
        except (Invalid, HttpError) as e:
            raise SystemExit(f"error: {e}") from None
        if namespaced and "namespace" not in kwargs:
            objs = [o for o in objs if getattr(o, "namespace", "") == ns]
        if field_selector and "field_selector" not in kwargs:
            # fallback backend: apply the fields axis client-side so the
            # output is FILTERED either way, never silently unfiltered
            from kubernetes_tpu_torch.api.fields import (
                FieldSelectorError,
                filter_objects,
                parse_field_selector,
            )
            try:
                objs = filter_objects(kind, objs,
                                      parse_field_selector(field_selector))
            except FieldSelectorError as e:
                raise SystemExit(f"error: {e}") from None
        if selector:
            want = dict(kv.split("=", 1) for kv in selector.split(",")
                        if "=" in kv)
            objs = [o for o in objs
                    if all(getattr(o, "labels", {}).get(k) == v
                           for k, v in want.items())]
        return objs

    def cmd_get(self, args):
        pos, flags = self._flags(args)
        if not pos:
            raise SystemExit("error: resource type required")
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        if "all-namespaces" in flags:
            ns = "*"
        name = pos[1] if len(pos) > 1 else ""
        sel = flags.get("selector", "")
        fsel = flags.get("field-selector", "")
        output = flags.get("output", "table")
        objs, list_rv = self._objs_rv(kind, ns, name, sel, fsel)
        self._print(render(kind, objs, output,
                           plural=self._plural(kind),
                           sort_by=flags.get("sort-by", "")))
        if "watch" in flags:
            # kubectl get --watch: stream subsequent changes as rows
            # (cmd/get.go watch path), scoped by the SAME name/label/field
            # filters as the table and resumed from the table's own rv so
            # no intervening event is lost. Bounded by --watch-timeout
            # (default 2s) — the library/test harness cannot block
            # forever the way an interactive kubectl does.
            try:
                timeout = float(flags.get("watch-timeout") or 2.0)
            except ValueError:
                raise SystemExit(
                    f"error: invalid --watch-timeout "
                    f"{flags['watch-timeout']!r}") from None
            self._watch_loop(kind, ns, name, sel, fsel, output,
                             list_rv, timeout)

    def _event_matches(self, kind: str, obj, ns: str, name: str,
                       selector: str, field_selector: str) -> bool:
        if name and getattr(obj, "name", "") != name:
            return False
        if ns != "*" and not self._cluster_scoped(kind) \
                and getattr(obj, "namespace", "") != ns:
            return False
        if selector:
            want = dict(kv.split("=", 1) for kv in selector.split(",")
                        if "=" in kv)
            if not all(getattr(obj, "labels", {}).get(k) == v
                       for k, v in want.items()):
                return False
        if field_selector:
            from kubernetes_tpu_torch.api.fields import (
                filter_objects,
                parse_field_selector,
            )
            if not filter_objects(kind, [obj],
                                  parse_field_selector(field_selector)):
                return False
        return True

    def _watch_loop(self, kind, ns, name, sel, fsel, output, rv,
                    timeout) -> None:
        import time as _time
        deadline = _time.monotonic() + timeout
        while True:
            remaining = deadline - _time.monotonic()
            if remaining <= 0:
                return
            try:
                evs = self.api.watch_since((kind,), rv,
                                           timeout=min(remaining, 0.25))
            except Exception as e:
                # HttpError in REST mode, TooOldResourceVersion on log
                # compaction: the CLI contract is error + exit 1
                raise SystemExit(
                    f"error: watch failed: {e} (relist and re-watch)"
                ) from None
            for ev in evs:
                rv = max(rv, ev.rv)
                if not self._event_matches(kind, ev.obj, ns, name, sel,
                                           fsel):
                    continue
                row = render(kind, [ev.obj], output,
                             plural=self._plural(kind))
                if output in ("table", "wide"):
                    row = row.splitlines()[-1]  # drop the repeated header
                self._print(f"{ev.type}\t{row}")

    def cmd_describe(self, args):
        pos, flags = self._flags(args)
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        try:
            events, _ = self.api.list("Event")  # one fetch for all objects
        except Exception:
            events = []
        for obj in self._objs(kind, ns, pos[1] if len(pos) > 1 else ""):
            self._print(describe(kind, obj))
            # the Events section kubectl describe ends with
            # (pkg/printers/internalversion/describe.go DescribeEvents):
            # recorder convention — namespaced objects key as <ns>/<name>
            # (obj.key()), cluster-scoped ones by bare name (Node/PV
            # events would never match a "/name" key)
            key = obj.key() if hasattr(obj, "key") else (
                (getattr(obj, "namespace", "") + "/" + obj.name)
                if getattr(obj, "namespace", "") else obj.name)
            rows = [e for e in events
                    if getattr(e, "involved_key", "") == key
                    and getattr(e, "involved_kind", kind) == kind]
            if rows:
                self._print("Events:")
                self._print("  TYPE\tREASON\tCOUNT\tMESSAGE")
                for e in rows:
                    self._print(f"  {e.type}\t{e.reason}\t"
                                f"{getattr(e, 'count', 1)}\t{e.message}")

    def _load_manifests(self, flags) -> List[Any]:
        text = open(flags["filename"]).read() \
            if flags.get("filename", "-") != "-" else sys.stdin.read()
        import yaml
        docs = [d for d in yaml.safe_load_all(text) if d]
        return [wire.decode_any(d) for d in docs], docs

    def cmd_create(self, args):
        _, flags = self._flags(args)
        objs, raws = self._load_manifests(flags)
        for obj, raw in zip(objs, raws):
            kind = raw.get("kind")
            self.api.create(kind, obj)
            self._print(f"{self._plural(kind)}/{obj.name} created")

    # ---- the canonical manifest shape the merge machinery operates on.
    # Pod/Node use the serde metadata/spec shape — precisely the SPEC
    # surface, so a merge can never stomp status or server bookkeeping;
    # everything else uses the flat reflective wire shape. User manifests
    # in either accepted shape are normalized through decode->encode
    # before diffing, so 3-way inputs always agree on shape.

    def _canon_manifest(self, kind: str, obj) -> Dict[str, Any]:
        from kubernetes_tpu_torch.api import serde
        if kind == "Pod":
            return serde.encode_pod(obj)
        if kind == "Node":
            return serde.encode_node(obj)
        return wire.encode(obj, kind)

    @staticmethod
    def _with_last_applied(canon: Dict[str, Any],
                           canon_txt: str) -> Dict[str, Any]:
        import copy as _copy
        out = _copy.deepcopy(canon)
        if "metadata" in out:
            out["metadata"].setdefault("annotations", {})[LAST_APPLIED] = \
                canon_txt
        elif isinstance(out.get("annotations"), dict) or \
                "annotations" not in out:
            out.setdefault("annotations", {})[LAST_APPLIED] = canon_txt
        return out

    # Node annotation keys the CONTROL PLANE owns (controllers write them
    # between a client's read and its update): survive apply/patch/edit
    # even when the user's manifest omits them. Everything else in
    # metadata.annotations is client-owned — the merged manifest is
    # authoritative, so a user-requested annotation change sticks.
    SERVER_OWNED_NODE_ANNOTATIONS = (
        "node.alpha.kubernetes.io/ttl",           # quota_sa TTL controller
        "volumes.kubernetes.io/attached",         # attach-detach controller
        "volumes.kubernetes.io/in-use",           # kubelet status sync — the
        # attach-detach controller's detach guard reads it (cloudctrl.py);
        # losing it to an apply could detach a still-mounted volume
    )

    def _decode_canon(self, kind: str, data: Dict[str, Any], cur):
        """Canonical manifest -> live object, restoring the status/server
        fields the spec-surface encoding doesn't carry (apply and patch
        never touch status — the reference's status-subresource split).
        Annotations are NOT wholesale-restored: the merge already computed
        them from (live, manifest), and clobbering that with the live map
        silently discarded every user-requested annotation change; only
        the server-owned keys above are re-added if the merge lost them."""
        new_obj = wire.decode_any(data, kind)
        if cur is not None:
            if kind == "Pod":
                new_obj.phase = cur.phase
                new_obj.ready = cur.ready
                new_obj.restart_count = cur.restart_count
            elif kind == "Node":
                new_obj.heartbeat = cur.heartbeat
                for k in self.SERVER_OWNED_NODE_ANNOTATIONS:
                    if k in cur.annotations and k not in new_obj.annotations:
                        new_obj.annotations[k] = cur.annotations[k]
            new_obj.resource_version = cur.resource_version
        return new_obj

    @staticmethod
    def _norm_key(k: str) -> str:
        return k.replace("_", "").replace("-", "").lower()

    def _project_to_raw(self, canon, raw):
        """Keep only the canonical keys the user's manifest actually wrote
        (tolerant of camelCase vs snake_case spelling, positional for
        lists, which decode preserves). The canonical shape is a
        decode->encode round trip, so it materializes DEFAULTS for every
        absent field; the drift-reverting delta half of the 3-way merge
        must not treat those as user intent — kubectl computes `modified`
        from the file bytes for exactly this reason
        (GetModifiedConfiguration).

        Shape-tolerant: decode_any accepts BOTH the metadata/spec nesting
        and the flat native shape, so the projection must not require the
        raw manifest to nest the same way the canonical encoding does — a
        flat-shape Pod manifest would otherwise project to an EMPTY delta
        and apply would silently drop every field update. Canonical
        metadata/spec levels match against the flat raw directly, and flat
        canonical keys also search raw's metadata/spec levels."""
        if isinstance(canon, dict) and isinstance(raw, dict):
            # lookup spaces: raw itself first, then its metadata/spec
            # levels (for flat-canon x nested-raw); first hit wins
            raw_by = {self._norm_key(k): v for k, v in raw.items()}
            for lvl in ("metadata", "spec"):
                sub = raw.get(lvl)
                if isinstance(sub, dict):
                    for k, v in sub.items():
                        raw_by.setdefault(self._norm_key(k), v)
            out = {}
            for k, v in canon.items():
                if k in ("metadata", "spec") and isinstance(v, dict) \
                        and not isinstance(raw.get(k), dict):
                    # nested-canon x flat-raw: the user's keys live at the
                    # raw top level — project the nesting against it
                    out[k] = self._project_to_raw(v, raw)
                    continue
                rv = raw_by.get(self._norm_key(k), _ABSENT)
                if rv is _ABSENT:
                    continue
                if isinstance(v, dict) and isinstance(rv, dict):
                    out[k] = self._project_to_raw(v, rv)
                elif isinstance(v, list) and isinstance(rv, list) \
                        and len(v) == len(rv):
                    out[k] = [self._project_to_raw(ci, ri)
                              if isinstance(ci, dict) and isinstance(ri, dict)
                              else ci
                              for ci, ri in zip(v, rv)]
                else:
                    out[k] = v
            return out
        return canon

    def _merge_preview(self, kind: str, obj, raw=None):
        """THE 3-way merge apply performs, shared by apply and diff so the
        preview can never drift from the write: returns (cur, cur_manifest,
        merged, canon_txt, changed). cur is None for would-create. Like
        kubectl, the modified object carries the new last-applied
        annotation INTO the diff — metadata.annotations is then never
        absent from `modified`, so dropping the user's annotations from a
        manifest prunes them per-key instead of nuking the whole map
        (controller-set keys survive). `raw` (the manifest as the user
        wrote it) narrows the drift-reverting delta half to
        manifest-specified fields (_project_to_raw)."""
        from kubernetes_tpu_torch.cli import strategicpatch
        ns = getattr(obj, "namespace", "")
        canon_new = self._canon_manifest(kind, obj)
        canon_txt = json.dumps(canon_new, sort_keys=True)
        try:
            cur = self.api.get(
                kind, ns if not self._cluster_scoped(kind) else "",
                obj.name)
        except Exception:
            cur = None
        if cur is None:
            return None, None, None, canon_txt, True
        prev_txt = getattr(cur, "annotations", {}).get(LAST_APPLIED, "")
        prev = json.loads(prev_txt) if prev_txt else {}
        cur_manifest = self._canon_manifest(kind, cur)
        modified = self._with_last_applied(canon_new, canon_txt)
        delta_view = self._project_to_raw(canon_new, raw) \
            if raw is not None else None
        merged = strategicpatch.three_way_merge(prev, modified,
                                                cur_manifest,
                                                modified_for_delta=delta_view)
        changed = not (merged == cur_manifest and prev_txt == canon_txt)
        return cur, cur_manifest, merged, canon_txt, changed

    def cmd_apply(self, args):
        """kubectl apply: THREE-way strategic merge (apply.go:658) — the
        patch is computed from (last-applied, new manifest) and played
        onto the LIVE object, so manifest-removed fields/list items are
        pruned while controller-owned fields (an HPA's replicas, status,
        defaults) survive untouched."""
        _, flags = self._flags(args)
        objs, raws = self._load_manifests(flags)
        for obj, raw in zip(objs, raws):
            kind = raw.get("kind")
            cur, _cur_manifest, merged, canon_txt, changed = \
                self._merge_preview(kind, obj, raw=raw)
            if cur is None:
                if hasattr(obj, "annotations"):
                    obj.annotations[LAST_APPLIED] = canon_txt
                self.api.create(kind, obj)
                self._print(f"{self._plural(kind)}/{obj.name} created")
                continue
            if not changed:
                self._print(f"{self._plural(kind)}/{obj.name} unchanged")
                continue
            new_obj = self._decode_canon(kind, merged, cur)
            if hasattr(new_obj, "annotations"):
                new_obj.annotations[LAST_APPLIED] = canon_txt
            self.api.update(kind, new_obj)
            self._print(f"{self._plural(kind)}/{obj.name} configured")

    def cmd_diff(self, args):
        """kubectl diff -f FILE: show what apply WOULD change — the same
        3-way merge apply performs, rendered as a unified diff of the
        live object vs the merged result, without writing anything
        (kubectl cmd/diff.go's server-dry-run shape, computed with the
        strategic-merge machinery apply already uses). Exit code 1 when
        differences exist, 0 when clean — kubectl's contract."""
        import difflib

        _, flags = self._flags(args)
        objs, raws = self._load_manifests(flags)
        any_changed = False
        for obj, raw in zip(objs, raws):
            kind = raw.get("kind")
            cur, cur_manifest, merged, canon_txt, changed = \
                self._merge_preview(kind, obj, raw=raw)
            if cur is None:
                any_changed = True
                self._print(f"+ {self._plural(kind)}/{obj.name} "
                            f"(would be created)")
                continue
            if not changed:
                continue
            any_changed = True
            # render what apply will actually WRITE: the merge result plus
            # the refreshed last-applied stamp (apply sets it after decode,
            # outside the merge). Without it, a run where only last-applied
            # moves exits 1 with an EMPTY diff; kubectl renders the
            # annotation change in this case
            after_obj = self._with_last_applied(merged, canon_txt)
            before = json.dumps(cur_manifest, indent=2,
                                sort_keys=True).splitlines()
            after = json.dumps(after_obj, indent=2,
                               sort_keys=True).splitlines()
            for line in difflib.unified_diff(
                    before, after,
                    fromfile=f"live/{self._plural(kind)}/{obj.name}",
                    tofile=f"merged/{self._plural(kind)}/{obj.name}",
                    lineterm=""):
                self._print(line)
        return 1 if any_changed else 0

    def cmd_patch(self, args):
        """kubectl patch -p '<json>': server-state strategic merge patch
        (pkg/kubectl/cmd/patch.go, default --type=strategic): merge-keyed
        lists merge per item, null deletes a key, $patch: delete removes a
        keyed list item."""
        from kubernetes_tpu_torch.cli import strategicpatch
        pos, flags = self._flags(args)
        if "patch" not in flags:
            raise SystemExit("error: -p / --patch is required")
        kind = self._resolve_kind(pos[0])
        ns = "" if self._cluster_scoped(kind) \
            else flags.get("namespace", "default")
        patch = json.loads(flags["patch"])
        cur = self.api.get(kind, ns, pos[1])
        # the patch follows the object's manifest shape (metadata/spec for
        # Pod/Node, flat for the rest) — same contract as apply manifests
        merged = strategicpatch.strategic_merge_patch(
            self._canon_manifest(kind, cur), patch)
        new_obj = self._decode_canon(kind, merged, cur)
        self.api.update(kind, new_obj)
        self._print(f"{self._plural(kind)}/{pos[1]} patched")

    def cmd_edit(self, args):
        """kubectl edit: round the live object through $EDITOR as YAML and
        update with whatever comes back (pkg/kubectl/cmd/edit.go's
        edit-reapply loop collapsed to one pass; KTCTL_EDITOR/EDITOR)."""
        import os
        import subprocess
        import tempfile

        import yaml
        pos, flags = self._flags(args)
        kind = self._resolve_kind(pos[0])
        ns = "" if self._cluster_scoped(kind) \
            else flags.get("namespace", "default")
        cur = self.api.get(kind, ns, pos[1])
        editor = os.environ.get("KTCTL_EDITOR") or os.environ.get(
            "EDITOR")
        if not editor:
            raise SystemExit("error: no KTCTL_EDITOR or EDITOR defined")
        manifest = self._canon_manifest(kind, cur)
        with tempfile.NamedTemporaryFile(
                "w", suffix=".yaml", delete=False) as f:
            yaml.safe_dump(manifest, f)
            path = f.name
        try:
            try:
                subprocess.run(editor.split() + [path], check=True)
            except subprocess.CalledProcessError:
                # vim :cq and friends — the conventional abort signal
                self._print("Edit cancelled, no changes made.")
                return
            with open(path) as f:
                edited = yaml.safe_load(f)
        finally:
            os.unlink(path)
        if edited is None or edited == manifest:
            self._print("Edit cancelled, no changes made.")
            return
        new_obj = self._decode_canon(kind, edited, cur)
        self.api.update(kind, new_obj)
        self._print(f"{self._plural(kind)}/{pos[1]} edited")

    def cmd_delete(self, args):
        pos, flags = self._flags(args)
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        for obj in self._objs(kind, ns, pos[1] if len(pos) > 1 else "",
                              flags.get("selector", "")):
            self.api.delete(kind, getattr(obj, "namespace", ""), obj.name)
            self._print(f"{self._plural(kind)}/{obj.name} deleted")

    def cmd_scale(self, args):
        pos, flags = self._flags(args)
        kind = self._resolve_kind(pos[0])
        reps = int(flags["replicas"])
        self.api.scale(kind, flags.get("namespace", "default"), pos[1],
                       replicas=reps)
        self._print(f"{self._plural(kind)}/{pos[1]} scaled")

    def _mutate_meta(self, args, field: str):
        pos, flags = self._flags(args)
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        obj = self._objs(kind, ns, pos[1])[0]
        d = getattr(obj, field)
        for kv in pos[2:]:
            if kv.endswith("-"):
                d.pop(kv[:-1], None)
            elif "=" in kv:
                k, _, v = kv.partition("=")
                d[k] = v
        self.api.update(kind, obj)
        self._print(f"{self._plural(kind)}/{pos[1]} {field[:-1]}ed")

    def cmd_label(self, args):
        self._mutate_meta(args, "labels")

    def cmd_annotate(self, args):
        self._mutate_meta(args, "annotations")

    def cmd_taint(self, args):
        pos, flags = self._flags(args)
        if pos[0] not in ("nodes", "node", "no"):
            raise SystemExit("error: taint only supports nodes")
        node = self.api.get("Node", "", pos[1])
        for spec in pos[2:]:
            if spec.endswith("-"):
                body = spec[:-1]
                key = body.split("=", 1)[0].split(":", 1)[0]
                node.taints = [t for t in node.taints if t.key != key]
                continue
            kv, _, effect = spec.rpartition(":")
            k, _, v = kv.partition("=")
            node.taints = list(node.taints) + [
                Taint(k, v, TaintEffect(effect))]
        self.api.update("Node", node)
        self._print(f"node/{pos[1]} tainted")

    def cmd_cordon(self, args):
        pos, _ = self._flags(args)
        node = self.api.get("Node", "", pos[0])
        node.unschedulable = True
        self.api.update("Node", node)
        self._print(f"node/{pos[0]} cordoned")

    def cmd_uncordon(self, args):
        pos, _ = self._flags(args)
        node = self.api.get("Node", "", pos[0])
        node.unschedulable = False
        self.api.update("Node", node)
        self._print(f"node/{pos[0]} uncordoned")

    def cmd_drain(self, args):
        """cordon + evict every pod on the node (kubectl drain,
        pkg/kubectl/cmd/drain.go; evictions honor PDBs server-side)."""
        pos, flags = self._flags(args)
        self.cmd_cordon([pos[0]])
        pods, _ = self.api.list("Pod")
        for p in pods:
            if p.node_name == pos[0]:
                self.api.evict(Eviction(p.name, p.namespace))
                self._print(f"pod/{p.name} evicted")

    def cmd_rollout(self, args):
        pos, flags = self._flags(args)
        if len(pos) < 3:
            raise SystemExit(
                "error: usage: rollout "
                "{status|history|undo|pause|resume|restart} KIND NAME")
        sub, kind_arg, name = pos[0], pos[1], pos[2]
        kind = self._resolve_kind(kind_arg)
        ns = flags.get("namespace", "default")
        obj = self.api.get(kind, ns, name)
        if sub == "status":
            ready = getattr(obj, "ready_replicas", 0)
            want = getattr(obj, "replicas", 0)
            if ready >= want:
                self._print(f'{self._plural(kind)} "{name}" successfully '
                            "rolled out")
            else:
                self._print(f"Waiting for rollout to finish: {ready} of "
                            f"{want} updated replicas are available...")
        elif sub == "history":
            for rev in getattr(obj, "revision_history", []) or ["<none>"]:
                self._print(str(rev))
        elif sub == "undo":
            hist = getattr(obj, "revision_history", None)
            if not hist:
                raise SystemExit("error: no rollout history found")
            obj.template = hist[-1]
            self.api.update(kind, obj)
            self._print(f"{self._plural(kind)}/{name} rolled back")
        elif sub in ("pause", "resume"):
            # kubectl rollout pause/resume (cmd/rollout_pause.go): the
            # deployment controller skips paused deployments, freezing
            # the rollout without touching the spec
            if not hasattr(obj, "paused"):
                raise SystemExit(
                    f"error: {kind} does not support pausing")
            want = sub == "pause"
            if obj.paused == want:
                # kubectl's exact wording (cmd/rollout_pause.go /
                # rollout_resume.go)
                raise SystemExit(
                    f"error: {self._plural(kind)}/{name} is "
                    f"{'already paused' if want else 'not paused'}")
            obj.paused = want
            self.api.update(kind, obj)
            self._print(f"{self._plural(kind)}/{name} {sub}d")
        elif sub == "restart":
            # kubectl rollout restart (cmd/rollout_restart.go): stamp a
            # restartedAt annotation on the POD TEMPLATE — the template
            # change hashes differently, so the controller rolls new pods
            # without any spec change
            tmpl = getattr(obj, "template", None)
            if tmpl is None or not hasattr(tmpl, "annotations"):
                raise SystemExit(
                    f"error: {kind} does not support restart")
            import time as _time
            tmpl.annotations["kubectl.kubernetes.io/restartedAt"] = \
                str(_time.time())
            self.api.update(kind, obj)
            self._print(f"{self._plural(kind)}/{name} restarted")
        else:
            raise SystemExit(f"error: unknown rollout subcommand {sub!r}")

    def cmd_top(self, args):
        pos, flags = self._flags(args)
        if pos and pos[0] in ("node", "nodes", "no"):
            pods, _ = self.api.list("Pod")
            nodes, _ = self.api.list("Node")
            usage = {}
            for p in pods:
                if p.node_name:
                    r = p.resource_request()
                    u = usage.setdefault(p.node_name, [0, 0])
                    u[0] += r.milli_cpu
                    u[1] += r.memory
            self._print("NAME  CPU(cores)  MEMORY(bytes)")
            for n in nodes:
                u = usage.get(n.name, [0, 0])
                self._print(f"{n.name}  {u[0]}m  {u[1]}")
            return
        if pos and pos[0] in ("pod", "pods", "po"):
            # kubectl top pod (metrics-server path): per-pod usage — the
            # hollow runtime's actual-usage annotations when scripted
            # (the cadvisor stand-in), requests otherwise
            from kubernetes_tpu_torch.nodes.kubelet import ACTUAL_MEM_ANNOTATION
            ns = flags.get("namespace", "default")
            pods, _ = self.api.list("Pod")
            self._print("NAME  CPU(cores)  MEMORY(bytes)")
            for p in pods:
                if p.namespace != ns and "all-namespaces" not in flags:
                    continue
                if not p.node_name:
                    continue  # metrics exist only for running pods
                r = p.resource_request()
                mem = int(p.annotations.get(ACTUAL_MEM_ANNOTATION,
                                            r.memory))
                self._print(f"{p.name}  {r.milli_cpu}m  {mem}")
            return
        raise SystemExit("error: usage: top {node|pod} [...]")

    def cmd_api_resources(self, args):
        self._print("NAME  APIGROUP  KIND  NAMESPACED")
        rows = self._discovery_resources() or [
            {"name": res, "group": "", "kind": kind,
             "namespaced": not cluster}
            for kind, (res, cluster) in KIND_INFO.items()]
        for r in sorted(rows, key=lambda r: (r.get("group", ""), r["name"])):
            self._print(f"{r['name']}  {r.get('group', '')}  {r['kind']}  "
                        f"{str(r['namespaced']).lower()}")

    def cmd_auth(self, args):
        """kubectl auth can-i VERB RESOURCE [NAME] [--as user] [--as-group g]
        [-n ns] — evaluates the configured authorizer chain
        (pkg/kubectl/cmd/auth/cani.go via SelfSubjectAccessReview)."""
        pos, flags = self._flags(args)
        if pos[:1] != ["can-i"] or len(pos) < 3:
            raise SystemExit("error: usage: auth can-i VERB RESOURCE [NAME]")
        authorizer = getattr(self.api, "authorizer", None)
        if authorizer is None:
            raise SystemExit("error: server has no authorizer configured")
        from kubernetes_tpu_torch.auth.authz import ALLOW, Attributes
        from kubernetes_tpu_torch.api.rbac import UserInfo
        groups = [g for g in flags.get("as-group", "").split(",") if g]
        user = UserInfo(name=flags.get("as", "system:admin"), groups=groups)
        attrs = Attributes(
            user=user, verb=pos[1], resource=pos[2],
            namespace=flags.get("namespace", "default"),
            name=pos[3] if len(pos) > 3 else "")
        self._print("yes" if authorizer.authorize(attrs) == ALLOW else "no")

    def cmd_explain(self, args):
        """kubectl explain KIND[.field[.field]]: field documentation from
        the live OpenAPI document (kubectl cmd/explain.go reads the same
        swagger the server publishes — here server/openapi.py, which
        derives from the serving dataclasses, so explain can never drift
        from what the server accepts)."""
        pos, _flags = self._flags(args)
        if not pos:
            raise SystemExit("error: resource name required")
        path = pos[0].split(".")
        kind = self._resolve_kind(path[0])
        store = getattr(self.api, "store", None)
        if store is not None:
            from kubernetes_tpu_torch.server.openapi import build_spec
            spec = build_spec(store)
        else:
            # remote backend: fetch the server-PUBLISHED document so CRD
            # definitions the server serves are visible here too
            spec = self.api.openapi()
        schema = spec["definitions"].get(kind)
        if schema is None:
            raise SystemExit(
                f"error: couldn't find resource for {path[0]!r}")
        is_array = False
        for field_name in path[1:]:
            props = schema.get("properties", {})
            if field_name not in props:
                raise SystemExit(
                    f'error: field "{field_name}" does not exist')
            schema = props[field_name]
            is_array = schema.get("type") == "array"
            if is_array:
                schema = schema.get("items", {})
        self._print(f"KIND:     {kind}")
        self._print(f"VERSION:  v1\n")
        if len(path) > 1:
            t = schema.get("type", "object")
            self._print(f"FIELD:    {path[-1]} "
                        f"<{'[]' + t if is_array else t}>")
        props = schema.get("properties")
        if props:
            self._print("FIELDS:")
            for fname, fschema in sorted(props.items()):
                self._print(f"   {fname}\t<{fschema.get('type', 'object')}>")

    def cmd_run(self, args):
        """kubectl run NAME --image=IMG [--replicas=N] (cmd/run.go, the
        1.7 generator behavior): one pod by default, a Deployment when
        --replicas is given."""
        pos, flags = self._flags(args)
        if not pos or not flags.get("image"):
            raise SystemExit("error: usage: run NAME --image=IMAGE")
        ns = flags.get("namespace", "default")
        name = pos[0]
        from kubernetes_tpu_torch.api.types import (
            Container,
            LabelSelector,
            Pod,
        )
        reps = flags.get("replicas")
        if reps is None:
            pod = Pod(name=name, namespace=ns, labels={"run": name},
                      containers=[Container(name=name,
                                            image=flags["image"])])
            self.api.create("Pod", pod)
            self._print(f"pod/{name} created")
            return
        from kubernetes_tpu_torch.api.workloads import Deployment
        dep = Deployment(
            name=name, namespace=ns, replicas=int(reps),
            selector=LabelSelector(match_labels={"run": name}),
            template=Pod(name="", namespace=ns, labels={"run": name},
                         containers=[Container(name=name,
                                               image=flags["image"])]))
        self.api.create("Deployment", dep)
        self._print(f"deployment/{name} created")

    def cmd_autoscale(self, args):
        """kubectl autoscale KIND NAME --min=N --max=M [--cpu-percent=P]
        (cmd/autoscale.go): create an HPA targeting the workload."""
        pos, flags = self._flags(args)
        if len(pos) < 2 or "max" not in flags:
            raise SystemExit(
                "error: usage: autoscale KIND NAME --max=N [--min=N] "
                "[--cpu-percent=P]")
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        from kubernetes_tpu_torch.server.apiserver_lite import NotFound
        try:
            self.api.get(kind, ns, pos[1])  # target must exist
        except NotFound as e:
            raise SystemExit(f"error: {e}") from None
        from kubernetes_tpu_torch.api.workloads import HorizontalPodAutoscaler
        lo, hi = int(flags.get("min", 1)), int(flags["max"])
        if hi <= 0 or lo > hi:
            # kubectl rejects this at the CLI; letting it through would
            # pin the workload at min forever (the controller clamps
            # max(min, min(max, desired)))
            raise SystemExit(
                f"error: --max={hi} must be at least 1 and >= --min={lo}")
        hpa = HorizontalPodAutoscaler(
            name=pos[1], namespace=ns, target_kind=kind,
            target_name=pos[1], min_replicas=lo, max_replicas=hi,
            target_cpu_utilization=int(flags.get("cpu-percent", 80)))
        self.api.create("HorizontalPodAutoscaler", hpa)
        self._print(f"horizontalpodautoscaler/{pos[1]} autoscaled")

    def cmd_expose(self, args):
        """kubectl expose KIND NAME --port P [--target-port T] [--name N]:
        create a Service selecting the workload's pods
        (pkg/kubectl/cmd/expose.go + the service generator)."""
        from kubernetes_tpu_torch.api.workloads import (
            Service,
            ServicePort,
            selector_of,
        )
        pos, flags = self._flags(args)
        if len(pos) < 2 or "port" not in flags:
            raise SystemExit("error: usage: expose KIND NAME --port P")
        kind = self._resolve_kind(pos[0])
        ns = flags.get("namespace", "default")
        obj = self.api.get(kind, ns, pos[1])
        sel = selector_of(obj)
        if sel.match_expressions:
            raise SystemExit("error: cannot expose via expression selector "
                             "(service selectors are equality-only)")
        if not sel.match_labels:
            raise SystemExit(f"error: {kind} {pos[1]} has no selector")
        try:
            port = int(flags["port"])
            target = int(flags.get("target-port", port))
        except ValueError:
            raise SystemExit("error: --port/--target-port must be integers")
        svc = Service(
            flags.get("name", pos[1]), ns, selector=dict(sel.match_labels),
            ports=[ServicePort(port=port, target_port=target)])
        self.api.create("Service", svc)
        self._print(f"service/{svc.name} exposed")

    def cmd_set(self, args):
        """kubectl set image KIND NAME CONTAINER=IMAGE...: update pod
        template images (pkg/kubectl/cmd/set/set_image.go) — rollouts pick
        the change up through the normal template-hash machinery."""
        import dataclasses as _dc
        pos, flags = self._flags(args)
        if pos[:1] != ["image"] or len(pos) < 4:
            raise SystemExit(
                "error: usage: set image KIND NAME CONTAINER=IMAGE")
        kind = self._resolve_kind(pos[1])
        ns = flags.get("namespace", "default")
        obj = self.api.get(kind, ns, pos[2])
        template = getattr(obj, "template", None)
        if template is None:
            raise SystemExit(f"error: {kind} has no pod template")
        if any("=" not in kv for kv in pos[3:]):
            raise SystemExit(
                "error: usage: set image KIND NAME CONTAINER=IMAGE")
        updates = dict(kv.split("=", 1) for kv in pos[3:])
        new_containers = []
        changed = False
        for c in template.containers:
            if c.name in updates or "*" in updates:
                img = updates.get(c.name, updates.get("*"))
                new_containers.append(_dc.replace(c, image=img))
                changed = True
            else:
                new_containers.append(c)
        if not changed:
            raise SystemExit("error: no matching container")
        new_template = _dc.replace(template, containers=new_containers)
        self.api.update(kind, _dc.replace(obj, template=new_template),
                        expect_rv=obj.resource_version)
        self._print(f"{kind.lower()}/{pos[2]} image updated")

    def cmd_federate(self, args):
        """kubefed verbs (federation/cmd kubefed + federated-RS CRUD):
        federate join <cluster> | unjoin <cluster> | clusters |
        federate create rs <name> --replicas N [--preferences JSON]
                 [--cpu m] [--selector k=v] | scale rs <name> --replicas N |
        federate get | sync"""
        if self.federation is None:
            raise SystemExit("error: no federation control plane configured")
        from kubernetes_tpu_torch.api.types import LabelSelector, make_pod
        from kubernetes_tpu_torch.api.workloads import ReplicaSet
        from kubernetes_tpu_torch.federation.controller import (
            FEDERATED_RS_KIND,
            FederatedReplicaSet,
            FederatedReplicaSetController,
        )
        from kubernetes_tpu_torch.federation.planner import PREFERENCES_ANNOTATION

        pos, flags = self._flags(list(args))
        if not pos:
            raise SystemExit("error: federate verb required")
        verb = pos[0]
        plane = self.federation

        def workload_args():
            """Shared name/namespace/selector/pod-template parsing for the
            three `federate create` flavors."""
            name = pos[2]
            ns = flags.get("namespace", "default")
            sel = dict(kv.split("=", 1) for kv in
                       flags.get("selector", f"app={name}").split(","))
            tmpl_pod = make_pod("", namespace=ns, labels=dict(sel),
                                cpu=int(flags.get("cpu", 100)))
            return name, ns, sel, tmpl_pod
        if verb == "join":
            name = pos[1]
            if name not in self.federation_contexts:
                raise SystemExit(f"error: unknown cluster context {name!r}")
            plane.join(name, self.federation_contexts[name])
            self._print(f"cluster/{name} joined")
        elif verb == "unjoin":
            plane.unjoin(pos[1])
            self._print(f"cluster/{pos[1]} unjoined")
        elif verb == "clusters":
            for c in plane.api.list("Cluster")[0]:
                state = "Ready" if c.ready and c.name in plane.members \
                    else "NotReady"
                self._print(f"{c.name}\t{state}")
        elif verb == "create" and pos[1:2] == ["rs"]:
            name, ns, sel, tmpl_pod = workload_args()
            frs = FederatedReplicaSet(
                name=name, namespace=ns,
                replicas=int(flags.get("replicas", 1)),
                template=ReplicaSet(
                    name=name, namespace=ns,
                    selector=LabelSelector(match_labels=dict(sel)),
                    template=tmpl_pod))
            if flags.get("preferences"):
                frs.annotations[PREFERENCES_ANNOTATION] = flags["preferences"]
            plane.api.create(FEDERATED_RS_KIND, frs)
            self._print(f"federatedreplicaset/{name} created")
        elif verb == "scale" and pos[1:2] == ["rs"]:
            ns = flags.get("namespace", "default")
            cur = plane.api.get(FEDERATED_RS_KIND, ns, pos[2])
            import dataclasses as _dc
            plane.api.update(FEDERATED_RS_KIND, _dc.replace(
                cur, replicas=int(flags["replicas"])),
                expect_rv=cur.resource_version)
            self._print(f"federatedreplicaset/{pos[2]} scaled")
        elif verb == "get":
            from kubernetes_tpu_torch.federation.controller import (
                FEDERATED_DEPLOY_KIND,
            )
            from kubernetes_tpu_torch.federation.service_dns import (
                FEDERATED_SERVICE_KIND,
            )
            for fkind in (FEDERATED_RS_KIND, FEDERATED_DEPLOY_KIND):
                for frs in plane.api.list(fkind)[0]:
                    self._print(f"{fkind.lower()}/{frs.namespace}/"
                                f"{frs.name}\treplicas={frs.replicas}\t"
                                f"ready={frs.ready_replicas}")
            for fsvc in plane.api.list(FEDERATED_SERVICE_KIND)[0]:
                self._print(
                    f"federatedservice/{fsvc.namespace}/{fsvc.name}\t"
                    f"serving={','.join(fsvc.serving_clusters) or '<none>'}")
        elif verb == "create" and pos[1:2] == ["deploy"]:
            from kubernetes_tpu_torch.api.workloads import Deployment
            from kubernetes_tpu_torch.federation.controller import (
                FEDERATED_DEPLOY_KIND,
                FederatedDeployment,
            )
            name, ns, sel, tmpl_pod = workload_args()
            fd = FederatedDeployment(
                name=name, namespace=ns,
                replicas=int(flags.get("replicas", 1)),
                template=Deployment(
                    name=name, namespace=ns,
                    selector=LabelSelector(match_labels=dict(sel)),
                    template=tmpl_pod))
            plane.api.create(FEDERATED_DEPLOY_KIND, fd)
            self._print(f"federateddeployment/{name} created")
        elif verb == "create" and pos[1:2] == ["service"]:
            from kubernetes_tpu_torch.api.workloads import Service, ServicePort
            from kubernetes_tpu_torch.federation.service_dns import (
                FEDERATED_SERVICE_KIND,
                FederatedService,
            )
            name, ns, sel, _tmpl = workload_args()
            plane.api.create(FEDERATED_SERVICE_KIND, FederatedService(
                name=name, namespace=ns,
                template=Service(name=name, namespace=ns, selector=sel,
                                 ports=[ServicePort(
                                     port=int(flags.get("port", 80)))])))
            self._print(f"federatedservice/{name} created")
        elif verb == "dns":
            # read path for the provider zone: `federate dns [name-substr]`
            from kubernetes_tpu_torch.federation.service_dns import (
                FederatedServiceController,
            )
            sub = pos[1] if len(pos) > 1 else ""
            dns = FederatedServiceController(plane).dns
            for (rname, rtype), rec in sorted(dns.records.items()):
                if sub and sub not in rname:
                    continue
                self._print(f"{rname}\t{rtype}\t{','.join(rec.values)}")
        elif verb == "sync":
            from kubernetes_tpu_torch.federation.controller import (
                FederatedDeploymentController,
            )
            from kubernetes_tpu_torch.federation.service_dns import (
                FederatedServiceController,
            )
            FederatedReplicaSetController(plane).sync_all()
            FederatedDeploymentController(plane).sync_all()
            FederatedServiceController(plane).sync_all()
            self._print("synced")
        else:
            raise SystemExit(f"error: unknown federate verb {verb!r}")

    def _kubelet_for(self, node_name: str):
        kubelets = getattr(self, "kubelets", None) or {}
        target = kubelets.get(node_name)
        if target is None:
            raise SystemExit(
                f"error: no kubelet endpoint registered for node "
                f"{node_name!r}")
        return target

    def cmd_logs(self, args):
        """kubectl logs: resolve the pod's node, then read
        /containerLogs/<ns>/<pod> from that node's kubelet API — the
        apiserver-proxies-to-kubelet path (pkg/kubelet/server/server.go
        InstallDebuggingHandlers; kubectl cmd/logs.go)."""
        import urllib.request

        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        from kubernetes_tpu_torch.server.apiserver_lite import NotFound

        pos, flags = self._flags(args)
        if not pos:
            raise SystemExit("error: pod name required")
        ns = flags.get("namespace", "default")
        try:
            pod = self.api.get("Pod", ns, pos[0])
        except NotFound as e:
            raise SystemExit(f"error: {e}") from None
        if not pod.node_name:
            raise SystemExit(f"error: pod {pos[0]!r} is not scheduled yet")
        target = self._kubelet_for(pod.node_name)
        tail = flags.get("tail")
        if isinstance(target, str):  # kubelet API base URL
            q = f"?tailLines={tail}" if tail is not None else ""
            try:
                with urllib.request.urlopen(
                        f"{target}/containerLogs/{ns}/{pos[0]}{q}") as r:
                    self._print(r.read().decode().rstrip("\n"))
            except urllib.error.HTTPError as e:
                raise SystemExit(
                    f"error: logs failed: {e.read().decode() or e}"
                ) from None
            return
        # in-process HollowKubelet: the SAME serve_logs the HTTP server
        # routes through — one implementation of the log semantics
        try:
            self._print(target.serve_logs(ns, pos[0], tail=tail))
        except KubeletApiError as e:
            raise SystemExit(f"error: {e}") from None

    def cmd_exec(self, args):
        """kubectl exec (non-streaming form): POST the command to the
        node's kubelet /exec endpoint."""
        import urllib.request
        from urllib.parse import quote

        # everything after "--" is the command verbatim (kubectl exec's
        # arg contract) — it must never reach the flag parser
        args = list(args)
        if "--" in args:
            split = args.index("--")
            args, cmd_args = args[:split], args[split + 1:]
        else:
            cmd_args = []
        pos, flags = self._flags(args)
        if not pos or not cmd_args:
            raise SystemExit("error: usage: exec POD -- COMMAND")
        ns = flags.get("namespace", "default")
        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        from kubernetes_tpu_torch.server.apiserver_lite import NotFound

        name, cmd = pos[0], " ".join(cmd_args)
        try:
            pod = self.api.get("Pod", ns, name)
        except NotFound as e:
            raise SystemExit(f"error: {e}") from None
        if not pod.node_name:
            raise SystemExit(f"error: pod {name!r} is not scheduled yet")
        target = self._kubelet_for(pod.node_name)
        if isinstance(target, str):
            req = urllib.request.Request(
                f"{target}/exec/{ns}/{name}?command={quote(cmd)}",
                data=b"", method="POST")
            try:
                with urllib.request.urlopen(req) as r:
                    self._print(r.read().decode().rstrip("\n"))
            except Exception as e:
                raise SystemExit(f"error: exec failed: {e}") from None
            return
        try:
            self._print(target.serve_exec(ns, name, cmd))
        except KubeletApiError as e:
            raise SystemExit(f"error: {e}") from None

    def cmd_attach(self, args):
        """kubectl attach (non-streaming form): attach to the RUNNING
        container's output via the node's kubelet /attach endpoint
        (kubectl cmd/attach.go; SPDY streaming elided like exec)."""
        import urllib.request

        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        from kubernetes_tpu_torch.server.apiserver_lite import NotFound

        pos, flags = self._flags(args)
        if not pos:
            raise SystemExit("error: pod name required")
        ns = flags.get("namespace", "default")
        try:
            pod = self.api.get("Pod", ns, pos[0])
        except NotFound as e:
            raise SystemExit(f"error: {e}") from None
        if not pod.node_name:
            raise SystemExit(f"error: pod {pos[0]!r} is not scheduled yet")
        target = self._kubelet_for(pod.node_name)
        if isinstance(target, str):
            req = urllib.request.Request(f"{target}/attach/{ns}/{pos[0]}",
                                         data=b"", method="POST")
            try:
                with urllib.request.urlopen(req) as r:
                    self._print(r.read().decode().rstrip("\n"))
            except Exception as e:
                raise SystemExit(f"error: attach failed: {e}") from None
            return
        try:
            self._print(target.serve_attach(ns, pos[0]))
        except KubeletApiError as e:
            raise SystemExit(f"error: {e}") from None

    def cmd_port_forward(self, args):
        """kubectl port-forward: bind a REAL local TCP port; every
        connection is answered with one round of the pod's port stream
        fetched through the kubelet (cmd/portforward.go; the kubelet leg
        is /portForward). Runs on a daemon thread (the in-process harness
        cannot block the CLI loop the way kubectl's foreground does);
        forwarders are exposed on self.port_forwards with .local_port and
        .stop()."""
        import socket
        import threading

        from kubernetes_tpu_torch.nodes.kubelet_server import KubeletApiError
        from kubernetes_tpu_torch.server.apiserver_lite import NotFound

        pos, flags = self._flags(args)
        if len(pos) < 2 or ":" not in pos[1]:
            raise SystemExit(
                "error: usage: port-forward POD LOCAL:REMOTE")
        ns = flags.get("namespace", "default")
        local_s, _, remote_s = pos[1].partition(":")
        try:
            local, remote = int(local_s), int(remote_s)
        except ValueError:
            raise SystemExit(
                f"error: invalid port mapping {pos[1]!r}") from None
        try:
            pod = self.api.get("Pod", ns, pos[0])
        except NotFound as e:
            raise SystemExit(f"error: {e}") from None
        if not pod.node_name:
            raise SystemExit(f"error: pod {pos[0]!r} is not scheduled yet")
        target = self._kubelet_for(pod.node_name)

        def fetch() -> bytes:
            if isinstance(target, str):
                import urllib.request
                with urllib.request.urlopen(
                        f"{target}/portForward/{ns}/{pos[0]}"
                        f"?port={remote}") as r:
                    return r.read()
            return target.serve_port(ns, pos[0], remote)

        try:
            fetch()  # fail fast: bad pod/port surfaces NOW, not per-conn
        except KubeletApiError as e:
            raise SystemExit(f"error: {e}") from None
        except Exception as e:
            raise SystemExit(f"error: port-forward failed: {e}") from None

        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            srv.bind(("127.0.0.1", local))
        except OSError as e:
            raise SystemExit(
                f"error: unable to listen on port {local}: {e}") from None
        srv.listen(8)

        class Forwarder:
            local_port = srv.getsockname()[1]

            def __init__(self):
                self._alive = True
                self._thread = threading.Thread(target=self._loop,
                                                daemon=True)
                self._thread.start()

            def _loop(self):
                while self._alive:
                    try:
                        conn, _addr = srv.accept()
                    except OSError:
                        return
                    try:
                        conn.sendall(fetch())
                    except Exception:
                        pass
                    finally:
                        conn.close()

            def stop(self):
                self._alive = False
                try:
                    srv.close()
                except OSError:
                    pass

        fwd = Forwarder()
        if not hasattr(self, "port_forwards"):
            self.port_forwards = []
        self.port_forwards.append(fwd)
        self._print(f"Forwarding from 127.0.0.1:{fwd.local_port} -> "
                    f"{remote}")

    def cmd_version(self, args):
        from kubernetes_tpu_torch.server.rest_http import VERSION
        self._print(f"Client Version: {VERSION['gitVersion']}")
        # ask the CONNECTED backend when it can answer (kubectl prints
        # both precisely to diagnose client/server skew)
        server_v = VERSION["gitVersion"]
        version_fn = getattr(self.api, "version", None)
        if callable(version_fn):
            try:
                server_v = version_fn().get("gitVersion", server_v)
            except Exception as e:
                raise SystemExit(
                    f"error: could not fetch server version: {e}"
                ) from None
        self._print(f"Server Version: {server_v}")


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Entry point for
    `python -m kubernetes_tpu_torch.cli.ktctl --server URL ...` (remote
    mode) — in-process mode is the library API (Ktctl(api))."""
    argv = list(sys.argv[1:] if argv is None else argv)
    server = None
    if argv[:1] and argv[0].startswith("--server"):
        if "=" in argv[0]:
            server = argv.pop(0).split("=", 1)[1]
        else:
            argv.pop(0)
            server = argv.pop(0)
    if server:
        from kubernetes_tpu_torch.cli.rest_client import RestClient

        api = RestClient(server)
    else:
        raise SystemExit("error: --server URL required outside a test "
                         "harness (in-process mode is the library API)")
    return Ktctl(api).run(argv)


if __name__ == "__main__":
    raise SystemExit(main())
