"""Weather providers → hourly datastore rows.

Reference: internal/weather — Yr.no (met.no locationforecast) and
OpenWeather providers polled hourly into HourlyWeather rows for the
dashboard/analytics correlation views.

A copy of ``birdnet_go_tpu/integrations/weather.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_integrations.py``
holds it to the original. Its default session is the shared client on
the port's transport (``utils/httpclient.py``).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time

log = logging.getLogger("birdnet_tpu.weather")


@dataclasses.dataclass
class WeatherObservation:
    time_unix: float
    temperature: float | None = None        # °C
    humidity: float | None = None           # %
    pressure: float | None = None           # hPa
    wind_speed: float | None = None         # m/s
    wind_deg: float | None = None
    clouds: float | None = None             # %
    description: str = ""
    icon: str = ""                          # standardized code (below)


# -- standardized icon codes (icon_codes.go) ---------------------------------
#
# Provider-specific symbol vocabularies collapse into one OpenWeather-style
# two-digit icon code so the SPA renders a consistent glyph regardless of
# the configured provider. Day/night/polartwilight variants of a symbol
# share one code (OpenWeatherToIcon day/night parity).

ICON_CLEAR = "01"
ICON_FAIR = "02"
ICON_PARTLY_CLOUDY = "03"
ICON_CLOUDY = "04"
ICON_RAIN_SHOWERS = "09"
ICON_RAIN = "10"
ICON_THUNDERSTORM = "11"
ICON_SLEET = "12"
ICON_SNOW = "13"
ICON_FOG = "50"
ICON_UNKNOWN = "unknown"

ICON_DESCRIPTION = {
    ICON_CLEAR: "Clear Sky", ICON_FAIR: "Fair",
    ICON_PARTLY_CLOUDY: "Partly Cloudy", ICON_CLOUDY: "Cloudy",
    ICON_RAIN_SHOWERS: "Rain Showers", ICON_RAIN: "Rain",
    ICON_THUNDERSTORM: "Thunderstorm", ICON_SLEET: "Sleet",
    ICON_SNOW: "Snow", ICON_FOG: "Fog", ICON_UNKNOWN: "Unknown",
}

_YRNO_FIXED = {
    "clearsky": ICON_CLEAR, "fair": ICON_FAIR,
    "partlycloudy": ICON_PARTLY_CLOUDY, "cloudy": ICON_CLOUDY,
    "fog": ICON_FOG,
}


def yrno_symbol_icon(symbol: str) -> str:
    """Yr.no symbol code → standardized icon (YrNoSymbolToIcon).

    Derived by category rather than a 70-row table — reproduces the
    reference mapping exactly, including yr.no's own typo'd symbols
    ("lightssleetshowersandthunder_*"): any *thunder* symbol is a
    thunderstorm regardless of precipitation type; sleet beats snow;
    *rainshowers* differs from steady *rain*."""
    base = symbol.strip().lower()
    for suffix in ("_day", "_night", "_polartwilight"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    if not base:
        return ICON_UNKNOWN
    if "thunder" in base:
        return ICON_THUNDERSTORM
    if "sleet" in base:
        return ICON_SLEET
    if "snow" in base:
        return ICON_SNOW
    if "rainshowers" in base:
        return ICON_RAIN_SHOWERS
    if base in ("lightrain", "rain", "heavyrain"):
        return ICON_RAIN
    return _YRNO_FIXED.get(base, ICON_UNKNOWN)


def openweather_icon(code: str) -> str:
    """OpenWeather icon code ("04d"/"04n") → standardized icon
    (OpenWeatherToIcon): the numeric part IS the standard code."""
    num = code.strip().lower().rstrip("dn")
    return num if num in ICON_DESCRIPTION else ICON_UNKNOWN


def infer_wunderground_icon(temp_c: float | None, precip_mm: float | None,
                            humidity: float | None,
                            solar_radiation: float | None,
                            wind_gust_ms: float | None) -> str:
    """PWS stations report measurements, not symbols; derive the icon
    (InferWundergroundIcon, provider_wunderground.go:90-114):
    heavy rain + strong gusts → thunderstorm; any precipitation splits
    rain/snow at 0 °C; near-saturation cold air → fog; otherwise cloud
    cover is inferred from solar radiation by day and humidity by
    night (SR ≤ 5 W/m²)."""
    t = temp_c if temp_c is not None else 15.0
    p = precip_mm or 0.0
    h = humidity if humidity is not None else 50.0
    sr = solar_radiation if solar_radiation is not None else 0.0
    gust = wind_gust_ms or 0.0
    if p > 10.0 and gust > 15.0:
        return ICON_THUNDERSTORM
    if p > 0:
        return ICON_SNOW if t < 0.0 else ICON_RAIN
    if h > 90.0 and t < 5.0:
        return ICON_FOG
    if sr <= 5.0:                         # night: clouds from humidity
        if h >= 85.0:
            return ICON_CLOUDY
        if h >= 60.0:
            return ICON_PARTLY_CLOUDY
        return ICON_CLEAR
    if sr > 600.0:                        # day: clouds from solar input
        return ICON_CLEAR
    if sr >= 200.0:
        return ICON_PARTLY_CLOUDY
    return ICON_CLOUDY


class YrNoProvider:
    """met.no locationforecast 2.0 (the reference's default provider)."""

    BASE = "https://api.met.no/weatherapi/locationforecast/2.0/compact"

    def __init__(self, lat: float, lon: float, session=None,
                 user_agent: str = "birdnet-tpu/0.1 bioacoustics-station"):
        from birdnet_go_tpu_torch.utils.httpclient import shared_client

        self.lat, self.lon = lat, lon
        self.session = session or shared_client()
        self.user_agent = user_agent

    def fetch(self) -> list[WeatherObservation]:
        r = self.session.get(
            self.BASE, params={"lat": self.lat, "lon": self.lon},
            headers={"User-Agent": self.user_agent})
        r.raise_for_status()
        data = r.json()
        out = []
        for entry in data.get("properties", {}).get("timeseries", [])[:24]:
            import datetime as dt

            ts = dt.datetime.fromisoformat(
                entry["time"].replace("Z", "+00:00")).timestamp()
            inst = entry.get("data", {}).get("instant", {}).get("details", {})
            next1 = entry.get("data", {}).get("next_1_hours", {})
            out.append(WeatherObservation(
                time_unix=ts,
                temperature=inst.get("air_temperature"),
                humidity=inst.get("relative_humidity"),
                pressure=inst.get("air_pressure_at_sea_level"),
                wind_speed=inst.get("wind_speed"),
                wind_deg=inst.get("wind_from_direction"),
                clouds=inst.get("cloud_area_fraction"),
                description=next1.get("summary", {}).get("symbol_code", ""),
                icon=yrno_symbol_icon(
                    next1.get("summary", {}).get("symbol_code", ""))))
        return out


class OpenWeatherProvider:
    BASE = "https://api.openweathermap.org/data/2.5/weather"

    def __init__(self, lat: float, lon: float, api_key: str, session=None):
        from birdnet_go_tpu_torch.utils.httpclient import shared_client

        self.lat, self.lon = lat, lon
        self.api_key = api_key
        self.session = session or shared_client()

    def fetch(self) -> list[WeatherObservation]:
        r = self.session.get(self.BASE, params={
            "lat": self.lat, "lon": self.lon, "appid": self.api_key,
            "units": "metric"})
        r.raise_for_status()
        d = r.json()
        return [WeatherObservation(
            time_unix=float(d.get("dt", time.time())),
            temperature=d.get("main", {}).get("temp"),
            humidity=d.get("main", {}).get("humidity"),
            pressure=d.get("main", {}).get("pressure"),
            wind_speed=d.get("wind", {}).get("speed"),
            wind_deg=d.get("wind", {}).get("deg"),
            clouds=d.get("clouds", {}).get("all"),
            description=(d.get("weather") or [{}])[0].get("description", ""),
            icon=openweather_icon(
                (d.get("weather") or [{}])[0].get("icon", "")))]


class WundergroundProvider:
    """Weather Underground PWS observations (provider_wunderground.go) —
    reads a personal weather station's current conditions."""

    BASE = "https://api.weather.com/v2/pws/observations/current"

    def __init__(self, station_id: str, api_key: str, session=None):
        from birdnet_go_tpu_torch.utils.httpclient import shared_client

        self.station_id = station_id
        self.api_key = api_key
        self.session = session or shared_client()

    def fetch(self) -> list[WeatherObservation]:
        r = self.session.get(self.BASE, params={
            "stationId": self.station_id, "apiKey": self.api_key,
            "units": "m", "format": "json", "numericPrecision": "decimal"})
        r.raise_for_status()
        obs = (r.json().get("observations") or [{}])[0]
        metric = obs.get("metric", {})
        icon = infer_wunderground_icon(
            metric.get("temp"), metric.get("precipRate"),
            obs.get("humidity"), obs.get("solarRadiation"),
            (metric.get("windGust") / 3.6
             if metric.get("windGust") is not None else None))
        return [WeatherObservation(
            time_unix=float(obs.get("epoch", time.time())),
            temperature=metric.get("temp"),
            humidity=obs.get("humidity"),
            pressure=metric.get("pressure"),
            wind_speed=(metric.get("windSpeed") / 3.6
                        if metric.get("windSpeed") is not None else None),
            wind_deg=obs.get("winddir"),
            clouds=None,
            description=f"PWS {self.station_id}",
            icon=icon)]


class WeatherPoller:
    """Hourly polling loop writing observations into the datastore."""

    def __init__(self, provider, datastore, interval_seconds: float = 3600.0):
        self.provider = provider
        self.datastore = datastore
        self.interval = interval_seconds
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.polls = 0
        self.errors = 0

    def poll_once(self) -> int:
        obs = self.provider.fetch()
        for o in obs:
            self.datastore.save_hourly_weather(
                o.time_unix, temperature=o.temperature, humidity=o.humidity,
                pressure=o.pressure, wind_speed=o.wind_speed,
                wind_deg=o.wind_deg, clouds=o.clouds,
                description=o.description, icon=o.icon)
        self.polls += 1
        return len(obs)

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, name="weather",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as e:
                self.errors += 1
                log.warning("weather poll failed: %s", e)
            self._stop.wait(self.interval)
