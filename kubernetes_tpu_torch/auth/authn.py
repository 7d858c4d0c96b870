"""Authenticators: request credential -> UserInfo.

Mirror of the reference's authenticator stack
(pkg/kubeapiserver/authenticator/config.go New: union of x509, static token
file, bootstrap token, service-account JWT, OIDC, webhook — each tried in
order, first success wins; staging/src/k8s.io/apiserver/pkg/authentication).
TPU-native simplifications: certificates are modeled as signed identity
records (no X.509 parsing — the trust decision, not the encoding, is what the
control plane semantics need); service-account tokens are HMAC-signed JWTs
built with the stdlib (no external crypto deps in the image).
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from kubernetes_tpu_torch.api.rbac import (
    SERVICE_ACCOUNTS_GROUP,
    SYSTEM_AUTHENTICATED,
    UserInfo,
)


class Unauthenticated(Exception):
    """No authenticator recognized the credential (401)."""


@dataclass
class Credential:
    """What a request presents: a bearer token and/or a client 'certificate'
    (a signed identity record standing in for an x509 client cert)."""

    token: str = ""
    cert: Optional[dict] = None  # {"cn":..., "orgs": [...], "sig": ...}
    # Impersonate-User / Impersonate-Group headers (apiserver/pkg/
    # endpoints/filters/impersonation.go): acted on AFTER authentication,
    # gated by the "impersonate" verb on users/groups
    impersonate_user: str = ""
    impersonate_groups: tuple = ()


class TokenAuthenticator:
    """Static token file (--token-auth-file;
    apiserver/pkg/authentication/token/tokenfile)."""

    def __init__(self, tokens: Dict[str, UserInfo]):
        self._tokens = dict(tokens)

    def authenticate(self, cred: Credential) -> Optional[UserInfo]:
        if cred.token and cred.token in self._tokens:
            return self._tokens[cred.token]
        return None


class BootstrapTokenAuthenticator:
    """kubeadm bootstrap tokens of the form <id>.<secret>
    (plugin/pkg/auth/authenticator/token/bootstrap): authenticates as
    system:bootstrap:<id> in group system:bootstrappers. Tokens are
    registered with an expiry and may be revoked (token cleaner)."""

    GROUP = "system:bootstrappers"

    def __init__(self, now=time.time):
        self._tokens: Dict[str, Tuple[str, float]] = {}  # id -> (secret, exp)
        self._now = now

    def add_token(self, token_id: str, secret: str, ttl: float = 86400.0) -> None:
        self._tokens[token_id] = (secret, self._now() + ttl)

    def revoke(self, token_id: str) -> None:
        self._tokens.pop(token_id, None)

    def expired_ids(self) -> List[str]:
        now = self._now()
        return [tid for tid, (_, exp) in self._tokens.items() if exp <= now]

    def authenticate(self, cred: Credential) -> Optional[UserInfo]:
        if not cred.token or "." not in cred.token:
            return None
        tid, _, secret = cred.token.partition(".")
        entry = self._tokens.get(tid)
        if entry is None:
            return None
        want, exp = entry
        if exp <= self._now() or not hmac.compare_digest(want, secret):
            return None
        return UserInfo("system:bootstrap:" + tid, groups=[self.GROUP])


def _b64(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _unb64(s: str) -> bytes:
    pad = -len(s) % 4
    return base64.urlsafe_b64decode(s + "=" * pad)


class ServiceAccountTokenAuthenticator:
    """Service-account JWTs (pkg/serviceaccount/jwt.go): subject
    system:serviceaccount:<ns>:<name>, groups system:serviceaccounts and
    system:serviceaccounts:<ns>. HS256 HMAC instead of RSA (same claims)."""

    ISSUER = "kubernetes/serviceaccount"

    def __init__(self, signing_key: bytes):
        self._key = signing_key

    def issue(self, namespace: str, name: str, uid: str = "") -> str:
        header = _b64(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        claims = _b64(json.dumps({
            "iss": self.ISSUER,
            "sub": f"system:serviceaccount:{namespace}:{name}",
            "kubernetes.io/serviceaccount/namespace": namespace,
            "kubernetes.io/serviceaccount/service-account.name": name,
            "kubernetes.io/serviceaccount/service-account.uid": uid,
        }).encode())
        body = header + "." + claims
        sig = _b64(hmac.new(self._key, body.encode(), hashlib.sha256).digest())
        return body + "." + sig

    def authenticate(self, cred: Credential) -> Optional[UserInfo]:
        parts = cred.token.split(".") if cred.token else []
        if len(parts) != 3:
            return None
        body = parts[0] + "." + parts[1]
        want = _b64(hmac.new(self._key, body.encode(), hashlib.sha256).digest())
        if not hmac.compare_digest(want, parts[2]):
            return None
        try:
            claims = json.loads(_unb64(parts[1]))
        except ValueError:
            return None
        if claims.get("iss") != self.ISSUER:
            return None
        ns = claims.get("kubernetes.io/serviceaccount/namespace", "")
        name = claims.get("kubernetes.io/serviceaccount/service-account.name", "")
        if not ns or not name:
            return None
        return UserInfo(
            f"system:serviceaccount:{ns}:{name}",
            groups=[SERVICE_ACCOUNTS_GROUP, SERVICE_ACCOUNTS_GROUP + ":" + ns],
            uid=claims.get("kubernetes.io/serviceaccount/service-account.uid", ""))


class CertAuthenticator:
    """Client-'certificate' authenticator (x509 stand-in,
    apiserver/pkg/authentication/request/x509): the identity record carries
    CN (user) + O (groups) and an HMAC signature by the cluster CA key."""

    def __init__(self, ca_key: bytes):
        self._key = ca_key

    def sign(self, cn: str, orgs: List[str]) -> dict:
        payload = json.dumps({"cn": cn, "orgs": sorted(orgs)}, sort_keys=True)
        sig = hmac.new(self._key, payload.encode(), hashlib.sha256).hexdigest()
        return {"cn": cn, "orgs": sorted(orgs), "sig": sig}

    def authenticate(self, cred: Credential) -> Optional[UserInfo]:
        cert = cred.cert
        if not cert:
            return None
        payload = json.dumps({"cn": cert.get("cn", ""),
                              "orgs": sorted(cert.get("orgs", []))},
                             sort_keys=True)
        want = hmac.new(self._key, payload.encode(), hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, cert.get("sig", "")):
            return None
        return UserInfo(cert["cn"], groups=list(cert.get("orgs", [])))


class UnionAuthenticator:
    """Try each in order; first success wins; everyone authenticated gains
    system:authenticated (union.New + group adder in the reference)."""

    def __init__(self, authenticators: List):
        self.authenticators = list(authenticators)

    def authenticate(self, cred: Credential) -> UserInfo:
        for a in self.authenticators:
            user = a.authenticate(cred)
            if user is not None:
                if SYSTEM_AUTHENTICATED not in user.groups:
                    user.groups.append(SYSTEM_AUTHENTICATED)
                return user
        raise Unauthenticated("no authenticator recognized the credential")
