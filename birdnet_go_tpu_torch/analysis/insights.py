"""Insights: derived "what's interesting right now" analytics.

Reference: internal/api/v2/analytics/insights.go — expected-today
(day-of-year history windows across up to 10 past years, with
year-boundary wrap), phantom species (frequent low-confidence),
dawn chorus (per-species average earliest detection in the dawn band),
migration (new arrivals / gone quiet), and dashboard KPIs with the
consecutive-active-day streak. This module holds the pure date/window
math; SQL lives in datastore, HTTP shaping in the API handlers.

A copy of ``birdnet_go_tpu/analysis/insights.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_api.py`` holds it to
the original.
"""

from __future__ import annotations

import datetime

# insights.go constants (lines 29-42)
QUERY_TIMEOUT_S = 30
PHANTOM_PERIOD_DAYS = 30
PHANTOM_MIN_DETECTIONS = 3
PHANTOM_MAX_AVG_CONFIDENCE = 0.6
DAWN_CHORUS_PERIOD_DAYS = 30
DAWN_CHORUS_START_HOUR = 4
DAWN_CHORUS_END_HOUR = 10
DAWN_CHORUS_MIN_DAYS = 3
MIGRATION_RECENT_DAYS = 14
MIGRATION_MIN_TOTAL = 5
EXPECTED_TODAY_WINDOW_DAYS = 3   # ± days around today's day-of-year
EXPECTED_TODAY_MAX_YEARS = 10


def build_year_ranges(today: datetime.date,
                      window_days: int = EXPECTED_TODAY_WINDOW_DAYS,
                      max_years: int = EXPECTED_TODAY_MAX_YEARS
                      ) -> list[tuple[str, str]]:
    """Inclusive (start, end) ISO-date ranges covering today's
    day-of-year ± window_days in each of the previous max_years years
    (insights.go buildYearRanges). A window that spills past a year
    boundary is split: the spill-back segment wraps to that year's
    December, the spill-forward segment lands in the NEXT year (only if
    that year is still historical)."""
    doy = today.timetuple().tm_yday
    ranges: list[tuple[str, str]] = []
    for year in range(today.year - max_years, today.year):
        jan1 = datetime.date(year, 1, 1)
        days_in_year = (datetime.date(year, 12, 31) - jan1).days + 1
        start_doy = doy - window_days
        end_doy = doy + window_days
        if start_doy < 1 and end_doy > days_in_year:
            ranges.append((jan1.isoformat(), f"{year}-12-31"))
            continue
        if start_doy < 1:
            # wraps backwards: tail of the SAME year + head of it
            wrap_start = jan1 + datetime.timedelta(
                days=days_in_year + start_doy - 1)
            ranges.append((wrap_start.isoformat(), f"{year}-12-31"))
            wrap_end = jan1 + datetime.timedelta(days=end_doy - 1)
            ranges.append((jan1.isoformat(), wrap_end.isoformat()))
        elif end_doy > days_in_year:
            # wraps forwards: tail of this year + head of the next
            range_start = jan1 + datetime.timedelta(days=start_doy - 1)
            ranges.append((range_start.isoformat(), f"{year}-12-31"))
            if year + 1 < today.year:
                nxt = datetime.date(year + 1, 1, 1)
                wrap_end = nxt + datetime.timedelta(
                    days=(end_doy - days_in_year) - 1)
                ranges.append((nxt.isoformat(), wrap_end.isoformat()))
        else:
            range_start = jan1 + datetime.timedelta(days=start_doy - 1)
            range_end = jan1 + datetime.timedelta(days=end_doy - 1)
            ranges.append((range_start.isoformat(),
                           range_end.isoformat()))
    return ranges


def calculate_streak(recent_dates: list[str], today: str
                     ) -> tuple[int, str]:
    """Consecutive active days ending today, from a DESC-sorted distinct
    date list (insights.go calculateStreak). Returns (days, start_date);
    (0, "") when today itself has no detections."""
    if not recent_dates or recent_dates[0] != today:
        return 0, ""
    try:
        expected = datetime.date.fromisoformat(today)
    except ValueError:
        return 0, ""
    last_matched = expected
    days = 1
    for d in recent_dates[1:]:
        expected -= datetime.timedelta(days=1)
        if d != expected.isoformat():
            break
        last_matched = expected
        days += 1
    return days, last_matched.isoformat()


def time_to_seconds(hhmmss: str) -> int:
    """'HH:MM:SS' (or 'HH:MM') → seconds since local midnight."""
    parts = hhmmss.split(":")
    try:
        h = int(parts[0])
        m = int(parts[1]) if len(parts) > 1 else 0
        s = int(parts[2]) if len(parts) > 2 else 0
    except (ValueError, IndexError):
        return 0
    return h * 3600 + m * 60 + s


def seconds_to_hhmm(seconds: int) -> str:
    return f"{seconds // 3600:02d}:{seconds % 3600 // 60:02d}"


def aggregate_dawn_chorus(raw_rows: list[dict],
                          min_days: int = DAWN_CHORUS_MIN_DAYS
                          ) -> list[dict]:
    """Group per-(species, date) earliest times into per-species average
    and all-time-earliest HH:MM, dropping species observed on fewer than
    min_days distinct days; sorted by average first detection
    (insights.go getDawnChorusImpl)."""
    by_species: dict[str, dict] = {}
    for row in raw_rows:
        sd = by_species.setdefault(row["scientific_name"], {
            "scientific_name": row["scientific_name"],
            "common_name": row.get("common_name", ""),
            "seconds_sum": 0, "earliest": 24 * 3600, "days": 0})
        secs = time_to_seconds(row["earliest_time"])
        sd["seconds_sum"] += secs
        sd["days"] += 1
        if secs < sd["earliest"]:
            sd["earliest"] = secs
    items = []
    for sd in by_species.values():
        if sd["days"] < min_days:
            continue
        avg = sd["seconds_sum"] // sd["days"]
        items.append({
            "scientific_name": sd["scientific_name"],
            "common_name": sd["common_name"],
            "avg_first_detection": seconds_to_hhmm(avg),
            "earliest_detection": seconds_to_hhmm(sd["earliest"]),
            "days_observed": sd["days"],
        })
    items.sort(key=lambda it: it["avg_first_detection"])
    return items
