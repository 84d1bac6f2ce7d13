"""Quiet-hours scheduling: fixed or sun-relative windows per source.

Reference: internal/audiocore/schedule/quiet_hours.go — windows like
"22:00-06:00" (fixed) or "sunset+30m to sunrise-30m" (sun-relative via
suncalc) suppress capture/analysis per source; the liveness watchdog
treats quiet periods as expected silence.

A copy of ``birdnet_go_tpu/audio/quiet_hours.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_app.py`` holds it
to the original.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import re

from birdnet_go_tpu_torch.utils.suncalc import sun_times


@dataclasses.dataclass(frozen=True)
class QuietWindow:
    """start/end are "HH:MM", "sunrise±offset" or "sunset±offset"
    (offset like +30m / -1h)."""

    start: str
    end: str


_SUN_RE = re.compile(r"^(sunrise|sunset)(?:([+-])(\d+)([mh]))?$")


def parse_windows(spec) -> list[QuietWindow]:
    """Config → windows. Accepts a list whose items are either
    ``{"start": "22:00", "end": "sunrise-30m"}`` dicts or strings —
    ``"22:00-06:00"`` (fixed) / ``"sunset+30m to sunrise-30m"``
    (sun-relative; `` to `` separates because offsets contain ``-``).
    Reference: quiet_hours.go window syntax. Raises ValueError on
    malformed entries so a bad config fails loudly at (re)load."""
    wins: list[QuietWindow] = []
    for item in spec or ():
        if isinstance(item, dict):
            start, end = item.get("start", ""), item.get("end", "")
        else:
            s = str(item)
            if " to " in s:
                start, _, end = s.partition(" to ")
            else:
                start, _, end = s.partition("-")
        start, end = start.strip(), end.strip()
        if not start or not end:
            raise ValueError(f"malformed quiet-hours window: {item!r}")
        for part in (start, end):
            if not _SUN_RE.match(part.lower()):
                hh, _, mm = part.partition(":")
                try:
                    _dt.time(int(hh), int(mm or 0))
                except ValueError as exc:
                    raise ValueError(
                        f"malformed quiet-hours time {part!r}") from exc
        wins.append(QuietWindow(start=start, end=end))
    return wins


def _resolve(spec: str, date: _dt.date, lat: float | None,
             lon: float | None) -> _dt.time | None:
    spec = spec.strip().lower()
    m = _SUN_RE.match(spec)
    if m:
        if lat is None or lon is None:
            return None
        st = sun_times(date, lat, lon)
        base = st.sunrise if m.group(1) == "sunrise" else st.sunset
        if base is None:
            return None                      # polar: no event today
        delta = _dt.timedelta()
        if m.group(2):
            amount = int(m.group(3))
            unit = 60 if m.group(4) == "h" else 1
            delta = _dt.timedelta(minutes=amount * unit)
            if m.group(2) == "-":
                delta = -delta
        return (base + delta).time()
    hh, _, mm = spec.partition(":")
    return _dt.time(int(hh), int(mm or 0))


def in_quiet_window(window: QuietWindow, when: _dt.datetime,
                    lat: float | None = None,
                    lon: float | None = None) -> bool:
    """True when `when` (UTC) falls inside the window (handles windows
    spanning midnight)."""
    if when.tzinfo is None:
        when = when.replace(tzinfo=_dt.timezone.utc)
    start = _resolve(window.start, when.date(), lat, lon)
    end = _resolve(window.end, when.date(), lat, lon)
    if start is None or end is None:
        return False
    t = when.time()
    if start <= end:
        return start <= t < end
    return t >= start or t < end            # spans midnight


class QuietHoursScheduler:
    """Per-source quiet windows; the engine/watchdog query is_quiet()."""

    def __init__(self, lat: float | None = None, lon: float | None = None):
        self.lat, self.lon = lat, lon
        self._windows: dict[str, list[QuietWindow]] = {}

    def set_windows(self, source_id: str,
                    windows: list[QuietWindow]) -> None:
        self._windows[source_id] = windows

    def has_windows(self) -> bool:
        return any(self._windows.values())

    def is_quiet(self, source_id: str,
                 when: _dt.datetime | None = None) -> bool:
        when = when or _dt.datetime.now(_dt.timezone.utc)
        return any(in_quiet_window(w, when, self.lat, self.lon)
                   for w in self._windows.get(source_id, ()))
