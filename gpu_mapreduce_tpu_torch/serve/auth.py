"""Per-tenant bearer-token auth for the serve/ ``/v1/`` plane.

``MRTPU_SERVE_TOKENS`` arms it, two grammars:

* **inline spec** — ``tenant=token[,tenant2=token2,...]`` (commas or
  whitespace separate pairs);
* **file path** — when the value names an existing file, one
  ``tenant=token`` pair per line (``#`` comments, blank lines ok).
  A file is the production shape: the secret never sits in ``ps``
  output, and every fleet replica plus the router read the SAME file,
  so the fleet shares one token set by construction.

``*=token`` declares an **admin** token: any tenant, plus the
operator verbs (drain / shutdown).  With auth armed, every ``/v1/``
request needs ``Authorization: Bearer <token>`` — a missing/unknown
token is **401**, a valid token acting outside its tenant is **403**
— and both are decided BEFORE any journal write or queue mutation
(doc/serve.md#tenant-auth).  The telemetry plane (``/metrics``,
``/healthz``) stays open: it is a loopback operator surface and the
fleet router's readiness probe must never need a secret.

Unset/empty = disarmed (every request passes, tenant comes from the
body).  The JAX package's ``serve/auth.py`` is the reference: the same
grammar and the same decisions.
"""

from __future__ import annotations

import os
import sys
import threading
from typing import Dict, Optional, Tuple

from ..utils.env import env_str

ADMIN = "*"


def _parse_pairs(text: str, source: str) -> Dict[str, str]:
    """``tenant=token`` pairs → {token: tenant}.  Malformed pairs warn
    and are skipped — a typo must not silently disarm auth for the
    well-formed tenants (and must never ADMIT anyone: an unparsed pair
    grants nothing)."""
    out: Dict[str, str] = {}
    for raw in text.replace(",", "\n").splitlines():
        pair = raw.split("#", 1)[0].strip()
        if not pair:
            continue
        if "=" not in pair:
            print(f"MRTPU_SERVE_TOKENS: bad pair {pair!r} in {source} "
                  f"(need tenant=token); skipped", file=sys.stderr)
            continue
        tenant, token = (s.strip() for s in pair.split("=", 1))
        if not tenant or not token:
            print(f"MRTPU_SERVE_TOKENS: empty tenant or token in "
                  f"{pair!r} ({source}); skipped", file=sys.stderr)
            continue
        out[token] = tenant
    return out


class TokenAuth:
    """The token set + the authorization decisions.

    ``spec`` defaults to ``MRTPU_SERVE_TOKENS``.  Thread-safe and
    cheap: the set is parsed once (a file re-reads when its mtime
    changes, so token rotation needs no daemon restart)."""

    def __init__(self, spec: Optional[str] = None):
        self.spec = spec if spec is not None \
            else (env_str("MRTPU_SERVE_TOKENS", "") or "")
        self._lock = threading.Lock()
        self._tokens: Dict[str, str] = {}
        self._file: Optional[str] = None
        self._mtime: float = -1.0
        if self.spec:
            if os.path.isfile(self.spec):
                self._file = self.spec
            else:
                self._tokens = _parse_pairs(self.spec, "inline spec")

    @property
    def armed(self) -> bool:
        return bool(self.spec)

    def _table(self) -> Dict[str, str]:
        if self._file is None:
            return self._tokens
        with self._lock:
            try:
                mtime = os.path.getmtime(self._file)
                if mtime != self._mtime:
                    with open(self._file) as f:
                        self._tokens = _parse_pairs(f.read(), self._file)
                    self._mtime = mtime
            except OSError as e:
                # unreadable file: keep the last good set (rotation
                # safety) but say so — an EMPTY last-good set means
                # nobody authenticates, which is fail-closed
                print(f"MRTPU_SERVE_TOKENS file unreadable: {e!r}; "
                      f"keeping previous token set", file=sys.stderr)
            return self._tokens

    # -- decisions ---------------------------------------------------------
    @staticmethod
    def bearer(headers: dict) -> Optional[str]:
        """The presented token (``Authorization: Bearer x``), else
        None.  Header lookup is case-insensitive like HTTP."""
        for k, v in (headers or {}).items():
            if str(k).lower() == "authorization":
                parts = str(v).split(None, 1)
                if len(parts) == 2 and parts[0].lower() == "bearer":
                    return parts[1].strip()
                return None
        return None

    def identify(self, headers: dict) -> Optional[str]:
        """The tenant a request's token proves — ``"*"`` for an admin
        token, None for a missing or unknown token."""
        tok = self.bearer(headers)
        if tok is None:
            return None
        return self._table().get(tok)

    def gate_ident(self, ident: Optional[str],
                   tenant: Optional[str] = None,
                   admin: bool = False) -> Tuple[int, Optional[dict]]:
        """The auth decision given an already-resolved identity (one
        token lookup per request — the handler resolves once and scopes
        per route): ``(0, None)`` = allowed, else ``(401|403, body)``.
        ``tenant`` scopes the action to a tenant (submit/cancel/read of
        a session); ``admin`` marks operator verbs.  Disarmed auth
        allows everything."""
        if not self.armed:
            return 0, None
        if ident is None:
            return 401, {"error": "missing or invalid bearer token"}
        if ident == ADMIN:
            return 0, None
        if admin:
            return 403, {"error": f"token for tenant {ident!r} cannot "
                                  f"perform operator actions"}
        if tenant is not None and tenant != ident:
            return 403, {"error": f"token for tenant {ident!r} cannot "
                                  f"act on tenant {tenant!r}"}
        return 0, None

    def gate(self, headers: dict,
             tenant: Optional[str] = None,
             admin: bool = False) -> Tuple[int, Optional[dict]]:
        """:meth:`gate_ident` with the lookup included — for callers
        holding only headers (the router's store-fallback paths)."""
        ident = self.identify(headers) if self.armed else None
        return self.gate_ident(ident, tenant=tenant, admin=admin)

    def snapshot(self) -> dict:
        table = self._table() if self.armed else {}
        return {"armed": self.armed,
                "tenants": sorted(set(table.values())),
                "source": "file" if self._file else
                          ("inline" if self.armed else None)}
