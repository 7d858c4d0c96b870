"""Strategic merge patch + the 3-way apply merge.

The reference's apply is NOT a PUT of the manifest: kubectl computes a
three-way strategic merge patch from (last-applied config, new manifest,
live object) — deletions come from last-applied vs new, additions/updates
from new vs live, and everything the user's manifest never mentioned (fields
set by controllers: replicas under HPA, status, server defaults) survives
(pkg/kubectl/cmd/apply.go:658 Patch,
staging/src/k8s.io/apimachinery/pkg/util/strategicpatch/patch.go).

"Strategic" = lists are not JSON-patch atomic: fields carrying a
patchMergeKey struct tag merge per-item by that key (containers by name,
ports by containerPort, env by name — types.go patchMergeKey tags); lists
without a merge key replace atomically. A `$patch: delete` directive inside
a merge-keyed item deletes it (patch.go directive handling).

Operates on manifest-shaped dicts (the CLI's YAML surface, api/wire.py);
MERGE_KEYS centralizes what the reference expresses as struct tags."""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

# field name -> merge-key candidates (the patchMergeKey struct tags of the
# modeled manifest surface). Candidates cover both spellings the two wire
# shapes use (native flat snake_case vs the Pod/Node metadata/spec shape's
# camelCase); _pick_merge_key selects whichever the items carry.
MERGE_KEYS: Dict[str, tuple] = {
    "containers": ("name",),
    "volumes": ("name",),
    "env": ("name",),
    "ports": ("container_port", "containerPort"),
    "tolerations": ("key",),
    "conditions": ("type",),
}

PATCH_DIRECTIVE = "$patch"
DELETE = "delete"
REPLACE = "replace"


def _merge_key_for(field: str, *item_lists: List) -> Optional[str]:
    cands = MERGE_KEYS.get(field)
    if not cands:
        return None
    for cand in cands:
        for items in item_lists:
            if any(isinstance(i, dict) and cand in i for i in items):
                return cand
    return cands[0]


def _index_by(items: List[dict], key: str) -> Dict[Any, dict]:
    out = {}
    for it in items:
        if isinstance(it, dict) and key in it:
            out[it[key]] = it
    return out


def strategic_merge_patch(current: Any, patch: Any,
                          field: str = "") -> Any:
    """Apply `patch` onto `current` (the 2-way half; patch.go
    mergeMap/mergeSlice):

    - maps merge recursively; a None value deletes the key
    - merge-keyed lists merge per item by key; `$patch: delete` removes
      the keyed item; unmatched patch items append
    - un-keyed lists (and scalar/type mismatches) replace atomically
    """
    if isinstance(current, dict) and isinstance(patch, dict):
        if patch.get(PATCH_DIRECTIVE) == REPLACE:
            out = {k: copy.deepcopy(v) for k, v in patch.items()
                   if k != PATCH_DIRECTIVE}
            return out
        out = copy.deepcopy(current)
        for k, v in patch.items():
            if v is None:
                out.pop(k, None)
            elif k in out:
                out[k] = strategic_merge_patch(out[k], v, field=k)
            else:
                out[k] = copy.deepcopy(v)
        return out
    if isinstance(current, list) and isinstance(patch, list):
        key = _merge_key_for(field, patch, current)
        if key is None or not all(isinstance(i, dict) for i in patch):
            return copy.deepcopy(patch)  # atomic replace
        out = [copy.deepcopy(i) for i in current]
        by_key = {i.get(key): idx for idx, i in enumerate(out)
                  if isinstance(i, dict)}
        for item in patch:
            k = item.get(key)
            if item.get(PATCH_DIRECTIVE) == DELETE:
                out = [i for i in out
                       if not (isinstance(i, dict) and i.get(key) == k)]
                by_key = {i.get(key): idx for idx, i in enumerate(out)
                          if isinstance(i, dict)}
                continue
            if k in by_key:
                out[by_key[k]] = strategic_merge_patch(
                    out[by_key[k]], item, field=field)
            else:
                out.append(copy.deepcopy(item))
                by_key[k] = len(out) - 1
        return out
    return copy.deepcopy(patch)


def create_two_way_diff(original: Any, modified: Any,
                        field: str = "") -> Any:
    """The patch that turns `original` into `modified`
    (CreateTwoWayMergePatch): changed/added keys appear; keys in original
    missing from modified appear as None (deletion); merge-keyed list
    items removed from the manifest become `$patch: delete` entries."""
    if isinstance(original, dict) and isinstance(modified, dict):
        patch: Dict[str, Any] = {}
        for k, v in modified.items():
            if k not in original:
                patch[k] = copy.deepcopy(v)
            elif original[k] != v:
                sub = create_two_way_diff(original[k], v, field=k)
                if sub is not _UNCHANGED:
                    patch[k] = sub
        for k in original:
            if k not in modified:
                patch[k] = None
        return patch if patch else _UNCHANGED
    if isinstance(original, list) and isinstance(modified, list):
        key = _merge_key_for(field, original, modified)
        if key is None or not (
                all(isinstance(i, dict) for i in original)
                and all(isinstance(i, dict) for i in modified)):
            return copy.deepcopy(modified) \
                if original != modified else _UNCHANGED
        orig_by = _index_by(original, key)
        mod_by = _index_by(modified, key)
        items: List[dict] = []
        for item in modified:
            k = item.get(key)
            if k in orig_by:
                sub = create_two_way_diff(orig_by[k], item, field=field)
                if sub is not _UNCHANGED:
                    sub = dict(sub) if isinstance(sub, dict) else {}
                    sub[key] = k
                    items.append(sub)
            else:
                items.append(copy.deepcopy(item))
        for k in orig_by:
            if k not in mod_by:
                items.append({key: k, PATCH_DIRECTIVE: DELETE})
        return items if items else _UNCHANGED
    return copy.deepcopy(modified) if original != modified else _UNCHANGED


class _Unchanged:
    def __repr__(self):
        return "<unchanged>"


_UNCHANGED = _Unchanged()


def _diff_deletions_only(original: Any, modified: Any,
                         field: str = "") -> Any:
    """The deletions half of CreateThreeWayMergePatch (patch.go:1958
    diffMaps with IgnoreChangesAndAdditions): ONLY the keys/list items
    present in `original` but absent from `modified` — null markers and
    `$patch: delete` entries, recursing for nested deletions."""
    if isinstance(original, dict) and isinstance(modified, dict):
        patch: Dict[str, Any] = {}
        for k, v in original.items():
            if k not in modified:
                patch[k] = None
            else:
                sub = _diff_deletions_only(v, modified[k], field=k)
                if sub is not _UNCHANGED:
                    patch[k] = sub
        return patch if patch else _UNCHANGED
    if isinstance(original, list) and isinstance(modified, list):
        key = _merge_key_for(field, original, modified)
        if key is None or not (
                all(isinstance(i, dict) for i in original)
                and all(isinstance(i, dict) for i in modified)):
            return _UNCHANGED  # atomic lists replace via the delta diff
        mod_by = _index_by(modified, key)
        items: List[dict] = []
        for k, item in _index_by(original, key).items():
            if k not in mod_by:
                items.append({key: k, PATCH_DIRECTIVE: DELETE})
            else:
                sub = _diff_deletions_only(item, mod_by[k], field=field)
                if sub is not _UNCHANGED:
                    sub = dict(sub)
                    sub[key] = k
                    items.append(sub)
        return items if items else _UNCHANGED
    return _UNCHANGED


def _diff_ignore_deletions(current: Any, modified: Any,
                           field: str = "") -> Any:
    """The delta half of CreateThreeWayMergePatch (diffMaps with
    IgnoreDeletions): additions and UPDATES that bring `current` to
    `modified`, with no null markers — so live drift on manifest-specified
    fields is reverted, while fields only the server/controllers own (absent
    from `modified`) survive."""
    if isinstance(current, dict) and isinstance(modified, dict):
        patch: Dict[str, Any] = {}
        for k, v in modified.items():
            if k not in current:
                patch[k] = copy.deepcopy(v)
            elif current[k] != v:
                sub = _diff_ignore_deletions(current[k], v, field=k)
                if sub is not _UNCHANGED:
                    patch[k] = sub
        return patch if patch else _UNCHANGED
    if isinstance(current, list) and isinstance(modified, list):
        key = _merge_key_for(field, current, modified)
        if key is None or not (
                all(isinstance(i, dict) for i in current)
                and all(isinstance(i, dict) for i in modified)):
            return copy.deepcopy(modified) \
                if current != modified else _UNCHANGED
        cur_by = _index_by(current, key)
        items: List[dict] = []
        for item in modified:
            k = item.get(key)
            if k in cur_by:
                sub = _diff_ignore_deletions(cur_by[k], item, field=field)
                if sub is not _UNCHANGED:
                    sub = dict(sub) if isinstance(sub, dict) else {}
                    sub[key] = k
                    items.append(sub)
            else:
                items.append(copy.deepcopy(item))
        return items if items else _UNCHANGED
    return copy.deepcopy(modified) if current != modified else _UNCHANGED


def three_way_merge(original: Any, modified: Any, current: Any,
                    modified_for_delta: Any = None) -> Any:
    """Apply's merge (CreateThreeWayMergePatch, patch.go:1958, + apply):
    the patch is the union of

      1. deletions from diff(original, modified) — fields/list items the
         user's manifest dropped since last-applied, and
      2. additions/updates from diff(current, modified) IGNORING deletions
         — so a field the manifest specifies is driven to the manifest's
         value even when the LIVE object drifted (a controller or manual
         edit changed it) while last-applied matches the manifest,

    played onto the LIVE object — fields the manifest never managed
    (controller writes, server defaults) pass through untouched.

    modified_for_delta: optional narrower view of `modified` for the delta
    half — callers whose canonical encoding materializes DEFAULTS for
    fields the user never wrote (decode->encode normalization) pass the
    projection onto the manifest's actual keys here, the analog of
    kubectl computing `modified` from the FILE bytes
    (GetModifiedConfiguration) rather than a round-tripped object; without
    it the delta would 'revert' server-owned fields to defaults."""
    deletions = _diff_deletions_only(original or {}, modified or {})
    delta = _diff_ignore_deletions(
        current or {},
        (modified_for_delta if modified_for_delta is not None
         else modified) or {})
    if deletions is _UNCHANGED and delta is _UNCHANGED:
        return copy.deepcopy(current)
    if deletions is _UNCHANGED:
        patch = delta
    elif delta is _UNCHANGED:
        patch = deletions
    else:
        # per-key disjoint by construction (a key deleted from `modified`
        # cannot also appear in the delta), so the merge is a plain overlay
        patch = strategic_merge_patch(deletions, delta)
    return strategic_merge_patch(current, patch)
