"""New/yearly/seasonal first-detection tracking.

Reference: internal/analysis/processor/species (species_tracker.go + 6
files) — tracks the first time each species is ever seen, first this year,
and first this (meteorological) season, synced with the datastore at
startup; drives "new species" notifications and dashboard badges.

A copy of ``birdnet_go_tpu/analysis/species_tracker.py`` for the port,
which imports nothing of the JAX package; ``tests/test_torch_app.py``
holds it to the original.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import threading


def season_of(when: _dt.date) -> str:
    m = when.month
    if m in (12, 1, 2):
        return "winter"
    if m in (3, 4, 5):
        return "spring"
    if m in (6, 7, 8):
        return "summer"
    return "autumn"


@dataclasses.dataclass
class FirstSeen:
    lifetime: _dt.date | None = None
    this_year: _dt.date | None = None
    this_season: _dt.date | None = None


@dataclasses.dataclass
class NoveltyStatus:
    is_new_lifetime: bool = False
    is_new_this_year: bool = False
    is_new_this_season: bool = False


class SpeciesTracker:
    def __init__(self, datastore=None):
        self._first: dict[str, _dt.date] = {}
        self._year: dict[tuple[str, int], _dt.date] = {}
        self._season: dict[tuple[str, int, str], _dt.date] = {}
        self._last_notified: dict[str, float] = {}
        self._lock = threading.Lock()
        if datastore is not None:
            self.sync_from_datastore(datastore)

    def sync_from_datastore(self, datastore,
                            today: _dt.date | None = None) -> int:
        """Load historical first-seen dates (startup sync). Seeds the
        lifetime map AND the this-year/this-season maps — otherwise every
        restart resets period novelty and species detected daily all year
        report is_new_this_year=True again."""
        today = today or _dt.date.today()
        n = 0
        for row in datastore.new_species_first_seen():
            d = _dt.date.fromisoformat(row["first_date"])
            with self._lock:
                sci = row["scientific_name"]
                if sci not in self._first or d < self._first[sci]:
                    self._first[sci] = d
            n += 1
        since = getattr(datastore, "species_first_seen_since", None)
        if since is None:
            return n
        year_start = _dt.date(today.year, 1, 1)
        # the season key splits winter at New Year (observe() keys by the
        # detection's own year), so the season window never reaches back
        # past Jan 1
        season_start = max(year_start,
                           _dt.date(today.year,
                                    {12: 12, 1: 1, 2: 1, 3: 3, 4: 3, 5: 3,
                                     6: 6, 7: 6, 8: 6}.get(today.month, 9),
                                    1))
        for row in since(year_start.isoformat()):
            d = _dt.date.fromisoformat(row["first_date"])
            with self._lock:
                self._year.setdefault((row["scientific_name"], d.year), d)
        for row in since(season_start.isoformat()):
            d = _dt.date.fromisoformat(row["first_date"])
            with self._lock:
                self._season.setdefault(
                    (row["scientific_name"], d.year, season_of(d)), d)
        return n

    def observe(self, scientific: str, when: _dt.date | None = None,
                window_days: int = 0) -> NoveltyStatus:
        """Record a detection; returns what's novel about it.

        With window_days > 0 (SpeciesTrackingSettings
        new_species_window_days, default 7 in the reference), a species
        stays "new" for that many days after its FIRST detection — the
        dashboard indicator, not just the first event."""
        when = when or _dt.date.today()
        yk = (scientific, when.year)
        sk = (scientific, when.year, season_of(when))

        def fresh(first: _dt.date | None) -> bool:
            if first is None:
                return True
            # inclusive <= like the reference (species/status.go:139);
            # window 0 still counts a same-day re-detection as new
            return (when - first).days <= window_days

        with self._lock:
            status = NoveltyStatus(
                is_new_lifetime=fresh(self._first.get(scientific)),
                is_new_this_year=fresh(self._year.get(yk)),
                is_new_this_season=fresh(self._season.get(sk)))
            self._first.setdefault(scientific, when)
            self._year.setdefault(yk, when)
            self._season.setdefault(sk, when)
        return status

    def seed_notified(self, scientific: str, ts: float) -> None:
        """Restore suppression state from persisted notification history
        (the reference reloads history at startup, species/database.go:
        511-533 — without this every restart re-sends 'new species'
        notifications inside the suppression window)."""
        with self._lock:
            prev = self._last_notified.get(scientific, 0.0)
            self._last_notified[scientific] = max(prev, ts)

    def should_notify(self, scientific: str, now: float,
                      suppression_hours: float) -> bool:
        """Duplicate new-species notifications are suppressed for
        suppression_hours (NotificationSuppressionHours, default 168)."""
        with self._lock:
            last = self._last_notified.get(scientific)
            if last is not None and now - last < suppression_hours * 3600.0:
                return False
            self._last_notified[scientific] = now
            return True

    def first_seen(self, scientific: str,
                   when: _dt.date | None = None) -> FirstSeen:
        when = when or _dt.date.today()
        with self._lock:
            return FirstSeen(
                lifetime=self._first.get(scientific),
                this_year=self._year.get((scientific, when.year)),
                this_season=self._season.get(
                    (scientific, when.year, season_of(when))))

    def species_count(self) -> int:
        with self._lock:
            return len(self._first)
