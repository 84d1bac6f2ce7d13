"""Sunrise/sunset and civil dawn/dusk (no external deps).

Reference: internal/suncalc (astral lib) — feeds the daylight detection
filter and quiet-hours scheduling; polar day/night fall back to
"always day"/"always night" rather than erroring.

Implementation: NOAA solar position algorithm (accurate to ~1 minute,
ample for gating detections by daylight).

A copy of ``birdnet_go_tpu/utils/suncalc.py`` for the port, which imports
nothing of the JAX package; ``tests/test_torch_detection.py`` holds it to
the original.
"""

from __future__ import annotations

import dataclasses
import datetime as _dt
import math

_ZENITH_OFFICIAL = 90.833          # sunrise/sunset (refraction + radius)
_ZENITH_CIVIL = 96.0               # civil dawn/dusk


@dataclasses.dataclass(frozen=True)
class SunTimes:
    sunrise: _dt.datetime | None
    sunset: _dt.datetime | None
    civil_dawn: _dt.datetime | None
    civil_dusk: _dt.datetime | None
    polar: str | None = None       # "day" | "night" | None


def _solar_event(date: _dt.date, lat: float, lon: float, zenith: float,
                 rising: bool) -> _dt.datetime | None:
    """NOAA/almanac method; returns UTC time or None (polar)."""
    n = date.timetuple().tm_yday
    lng_hour = lon / 15.0
    t = n + ((6.0 if rising else 18.0) - lng_hour) / 24.0
    m = (0.9856 * t) - 3.289
    l = m + (1.916 * math.sin(math.radians(m))) \
        + (0.020 * math.sin(math.radians(2 * m))) + 282.634
    l %= 360.0
    ra = math.degrees(math.atan(0.91764 * math.tan(math.radians(l)))) % 360.0
    # quadrant alignment
    ra += (math.floor(l / 90.0) * 90.0) - (math.floor(ra / 90.0) * 90.0)
    ra /= 15.0
    sin_dec = 0.39782 * math.sin(math.radians(l))
    cos_dec = math.cos(math.asin(sin_dec))
    cos_h = ((math.cos(math.radians(zenith))
              - (sin_dec * math.sin(math.radians(lat))))
             / (cos_dec * math.cos(math.radians(lat))))
    if cos_h > 1.0 or cos_h < -1.0:
        return None                     # polar day/night for this zenith
    h = (360.0 - math.degrees(math.acos(cos_h))) if rising \
        else math.degrees(math.acos(cos_h))
    h /= 15.0
    t_local = h + ra - (0.06571 * t) - 6.622
    ut = (t_local - lng_hour) % 24.0
    hours = int(ut)
    minutes = int((ut - hours) * 60)
    seconds = int((((ut - hours) * 60) - minutes) * 60)
    return _dt.datetime(date.year, date.month, date.day, hours, minutes,
                        seconds, tzinfo=_dt.timezone.utc)


def sun_times(date: _dt.date, lat: float, lon: float) -> SunTimes:
    sr = _solar_event(date, lat, lon, _ZENITH_OFFICIAL, rising=True)
    ss = _solar_event(date, lat, lon, _ZENITH_OFFICIAL, rising=False)
    cd = _solar_event(date, lat, lon, _ZENITH_CIVIL, rising=True)
    ck = _solar_event(date, lat, lon, _ZENITH_CIVIL, rising=False)
    polar = None
    if sr is None and ss is None:
        # distinguish polar day vs night by solar declination vs latitude
        n = date.timetuple().tm_yday
        decl = -23.44 * math.cos(math.radians(360.0 / 365.0 * (n + 10)))
        polar = "day" if (lat >= 0) == (decl > 0) else "night"
    return SunTimes(sunrise=sr, sunset=ss, civil_dawn=cd, civil_dusk=ck,
                    polar=polar)


def in_daylight_window(when: _dt.datetime, lat: float, lon: float,
                       offset_hours: float = 0.0) -> bool:
    """Membership in [civil dawn + offset, civil dusk − offset).

    The daylight filter's window test (daylight_filter.go isDaylight):
    a positive offset SHRINKS the window, a negative one EXPANDS it; an
    offset large enough to invert the window means no time is daylight.
    Polar day → always daylight; polar night → never.
    """
    if when.tzinfo is None:
        when = when.replace(tzinfo=_dt.timezone.utc)
    st = sun_times(when.date(), lat, lon)
    if st.polar == "day":
        return True
    if st.polar == "night":
        return False
    start, end = st.civil_dawn, st.civil_dusk
    if start is None or end is None:
        return st.polar != "night"
    off = _dt.timedelta(hours=offset_hours)
    start, end = start + off, end - off
    if start >= end:                     # inverted window guard
        return False
    return start <= when < end


def is_daytime(when: _dt.datetime, lat: float, lon: float,
               civil: bool = True) -> bool:
    """True when `when` (UTC) falls between dawn and dusk.

    Polar day → always True; polar night → always False (reference's
    polar fallback).
    """
    if when.tzinfo is None:
        when = when.replace(tzinfo=_dt.timezone.utc)
    st = sun_times(when.date(), lat, lon)
    if st.polar == "day":
        return True
    if st.polar == "night" and st.civil_dawn is None:
        return False
    start = st.civil_dawn if civil else st.sunrise
    end = st.civil_dusk if civil else st.sunset
    if start is None or end is None:
        return st.polar != "night"
    if end < start:                      # dusk past midnight UTC
        return when >= start or when <= end
    return start <= when <= end


def moon_phase(date: _dt.date) -> dict:
    """Moon phase for a date (reference: GET /weather/moon/:date).

    Conway-style synodic approximation anchored at the 2000-01-06 18:14 UT
    new moon; accuracy ~1 day, ample for a UI phase icon."""
    anchor = _dt.datetime(2000, 1, 6, 18, 14, tzinfo=_dt.timezone.utc)
    when = _dt.datetime(date.year, date.month, date.day, 12,
                        tzinfo=_dt.timezone.utc)
    synodic = 29.53058867
    age = ((when - anchor).total_seconds() / 86400.0) % synodic
    fraction = age / synodic
    names = ["new_moon", "waxing_crescent", "first_quarter",
             "waxing_gibbous", "full_moon", "waning_gibbous",
             "last_quarter", "waning_crescent"]
    idx = int((fraction * 8 + 0.5)) % 8
    import math

    illum = (1 - math.cos(2 * math.pi * fraction)) / 2
    return {"age_days": round(age, 1), "phase": names[idx],
            "illumination": round(illum, 3), "fraction": round(fraction, 3)}
