"""What the port does not have yet, and where ``ROADMAP.md`` keeps it: the
refusal that names the item. The app raises it for a setting that turns
such a subsystem on (``Application._unported``), and the API answers it
with 501 on a route that needs one (``api/handlers_ext.py``,
``UNPORTED_ROUTES``)."""

LOGINS = ("ROADMAP.md queue 1 item 10 (the terminal, TLS, and the OIDC, "
          "GitHub and Cloudflare logins)")


def refuse(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch port yet: see {item}; turn "
        f"it off in the settings to serve without it")
