"""GitHub social authentication (reference: internal/security goth
GitHub provider; doc/wiki/security.md "Social Authentication").

GitHub is plain OAuth2 (no OIDC id_token): authorize → code → access
token → REST /user/emails for the verified primary address, checked
against the configured allowlist. Flow mirrors api/oidc.py: state
tokens with TTL, email/@domain allowlist, session issued by the caller.

A copy of ``birdnet_go_tpu/api/github_auth.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_logins.py`` holds
it to the original. Its default transport is the port's ``HttpClient``
(``utils/httpclient.py``, over urllib), where JAX's is over httpx.
"""

from __future__ import annotations

import logging
import secrets
import time
import urllib.parse

log = logging.getLogger("birdnet_tpu.github")

AUTHORIZE_URL = "https://github.com/login/oauth/authorize"
TOKEN_URL = "https://github.com/login/oauth/access_token"
API_BASE = "https://api.github.com"
_STATE_TTL = 600.0


class GithubAuthError(Exception):
    pass


class GithubClient:
    def __init__(self, client_id: str, client_secret: str,
                 redirect_uri: str, allowed: list[str] | None = None,
                 http=None, clock=time.time):
        from birdnet_go_tpu_torch.utils.httpclient import HttpClient

        self.client_id = client_id
        self.client_secret = client_secret
        self.redirect_uri = redirect_uri
        # entries: full emails, "@domain.tld", or GitHub "login:<user>"
        self.allowed = [a.lower() for a in (allowed or [])]
        self.http = http or HttpClient(timeout=15.0)
        self.clock = clock
        self._pending: dict[str, float] = {}      # state → expires

    def begin(self) -> tuple[str, str]:
        """(state, authorize URL)."""
        now = self.clock()
        self._pending = {s: exp for s, exp in self._pending.items()
                         if exp > now}
        state = secrets.token_urlsafe(24)
        # bounded (every queue is): an unauthenticated
        # client looping on /login must not grow this without limit
        if len(self._pending) >= 1000:
            oldest = min(self._pending, key=self._pending.get)
            self._pending.pop(oldest, None)
        self._pending[state] = now + _STATE_TTL
        q = urllib.parse.urlencode({
            "client_id": self.client_id,
            "redirect_uri": self.redirect_uri,
            "scope": "user:email",
            "state": state,
        })
        return state, f"{AUTHORIZE_URL}?{q}"

    def complete(self, state: str, code: str) -> dict:
        """Exchange the code, resolve the user, enforce the allowlist.
        Returns {"email", "login"}; raises GithubAuthError otherwise."""
        exp = self._pending.pop(state, None)
        if exp is None or exp < self.clock():
            raise GithubAuthError("unknown or expired state")
        resp = self.http.post(TOKEN_URL, data={
            "client_id": self.client_id,
            "client_secret": self.client_secret,
            "code": code,
            "redirect_uri": self.redirect_uri,
        }, headers={"Accept": "application/json"})
        if resp.status_code != 200:
            raise GithubAuthError(f"token exchange HTTP {resp.status_code}")
        token = resp.json().get("access_token")
        if not token:
            raise GithubAuthError("no access token in response")
        headers = {"Authorization": f"Bearer {token}",
                   "Accept": "application/vnd.github+json"}
        user = self.http.get(f"{API_BASE}/user", headers=headers)
        if user.status_code != 200:
            raise GithubAuthError(f"user lookup HTTP {user.status_code}")
        info = user.json()
        login = str(info.get("login", "")).lower()
        email = str(info.get("email") or "").lower()
        if not email:
            # private email: the dedicated endpoint lists them; take the
            # primary VERIFIED address (goth does the same)
            emails = self.http.get(f"{API_BASE}/user/emails",
                                   headers=headers)
            if emails.status_code == 200:
                for e in emails.json():
                    if e.get("primary") and e.get("verified"):
                        email = str(e.get("email", "")).lower()
                        break
        if not self._allowed(email, login):
            raise GithubAuthError(
                f"user {login!r} ({email or 'no email'}) not in allowlist")
        return {"email": email, "login": login}

    def _allowed(self, email: str, login: str) -> bool:
        if not self.allowed:
            return True
        for entry in self.allowed:
            if entry.startswith("login:"):
                if login == entry[6:]:
                    return True
            elif entry.startswith("@"):
                if email.endswith(entry):
                    return True
            elif email == entry:
                return True
        return False
