"""Settings tree: YAML + env overrides + validation.

Mirrors the reference's conf.Settings (internal/conf/config.go:1787-1855)
at reduced surface, keeping its defaults (internal/conf/defaults.go):
sensitivity 1.0, threshold 0.8, range-filter threshold 0.01, capture ring
120 s, clip export 15 s / pre-capture 3 s, privacy filter on at 0.05,
dog-bark filter off, dynamic thresholds trigger 0.90 / floor 0.20.

Env overrides use BIRDNET_TPU_<SECTION>__<FIELD>=value (double underscore
per nesting level), the analogue of the reference's viper env binding.

A copy of ``birdnet_go_tpu/config/settings.py`` for the port, which
imports nothing of the JAX package; ``tests/test_torch_soak.py`` holds it
to the original.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from pathlib import Path
from typing import Any


@dataclasses.dataclass
class ModelSettings:
    model_id: str = "BirdNET_V2.4"
    enabled: bool = True
    checkpoint: str | None = None
    sensitivity: float = 1.0          # defaults.go:76, range [0, 1.5]
    threshold: float = 0.8            # defaults.go:77 (Perch/V3/Bat use 0.5)
    overlap: float = 0.0              # seconds on 3 s base, [0, 2.9]
    locale: str = "en_us"


@dataclasses.dataclass
class RangeFilterSettings:
    enabled: bool = True
    model: str = "latest"             # "latest" (geomodel v3) | "legacy"
    threshold: float = 0.01           # defaults.go:91
    rebuild_hour: int = 0             # daily rebuild (UpdateRangeFilterAction)


@dataclasses.dataclass
class PrivacyFilterSettings:
    enabled: bool = True              # defaults.go:298
    confidence: float = 0.05          # human-vocal confidence (defaults.go:300)


@dataclasses.dataclass
class DogBarkFilterSettings:
    enabled: bool = False             # defaults.go:303
    confidence: float = 0.1
    remember_minutes: float = 5.0     # defaults.go:305


@dataclasses.dataclass
class DaylightFilterSettings:
    """Discard DAYTIME detections of the listed (nocturnal) species —
    an owl reported at noon is more likely a misidentification
    (daylight_filter.go checkDaylightFilter: species in the filter set
    AND detection inside [civil dawn + offset, civil dusk − offset) →
    discard). Empty species list filters NOTHING (exclusionary filter);
    positive offset_hours shrinks the window, negative expands it; an
    offset that inverts the window means no time counts as daylight."""

    enabled: bool = False
    species: list[str] = dataclasses.field(default_factory=list)
    offset_hours: float = 0.0


@dataclasses.dataclass
class UltrasonicFilterSettings:
    """Bat-detection CV validation (processor.go:881-893
    applyUltrasonicFilter; defaults.go:106-108): a window whose
    ultrasonic-band energy is too steady (low CV) is broadband noise,
    not bat calls — its detections are discarded."""

    enabled: bool = True
    cv_threshold: float = 0.15


@dataclasses.dataclass
class DynamicThresholdSettings:
    enabled: bool = False
    trigger: float = 0.90             # defaults.go:205
    min: float = 0.20                 # floor (defaults.go:207)
    valid_hours: float = 24.0


@dataclasses.dataclass
class DeepDetectionSettings:
    # false_positive_filter.go:18-60: level → min overlap + % confirmations
    level: int = 0                    # 0 = off, 1-5
    bat_level: int = 2                # defaults.go:106-108 (bat default 2)


@dataclasses.dataclass
class ExportSettings:
    enabled: bool = True
    clip_length_seconds: float = 15.0   # defaults.go:137
    pre_capture_seconds: float = 3.0    # defaults.go:138
    path: str = "data/clips"
    format: str = "wav"                  # wav|flac
    # static export gain in dB, and EBU R128 loudness normalization
    # (reference: conf/config.go:50-69 Export.Gain + NormalizationSettings;
    # when normalization is enabled the measured gain REPLACES gain_db —
    # actions_database.go:854-880 resolves one gain for every format)
    gain_db: float = 0.0
    normalization: dict[str, Any] = dataclasses.field(
        default_factory=lambda: {"enabled": False, "target_lufs": -23.0,
                                 "true_peak_db": -2.0})


@dataclasses.dataclass
class ExtendedCaptureSettings:
    """Single long clip for continuous calling sessions (reference:
    ExtendedCaptureSettings, conf/config.go:792-799 + extended_capture.go;
    defaults consts.go: max 120 s, capture ring 120 s baseline)."""

    enabled: bool = False
    max_duration_seconds: int = 120     # DefaultExtendedCaptureMaxDuration
    capture_buffer_seconds: int = 0     # 0 = derive from max duration
    species: list[str] = dataclasses.field(default_factory=list)  # [] = all

    MAX_DURATION_CAP = 1200            # consts.go extended capture max

    def effective_capture_buffer_seconds(self, default: float,
                                         clip_length: float,
                                         pre_capture: float) -> float:
        """EffectiveCaptureBufferSeconds analogue: the ring must hold the
        longest possible extended clip. A user buffer smaller than
        max_duration + pre_capture + 30 is ignored in favor of the
        derived size (conf/config.go:825-869 rejects such configs)."""
        if not self.enabled:
            return default
        max_dur = min(self.max_duration_seconds, self.MAX_DURATION_CAP)
        derived = max_dur + clip_length + pre_capture
        if self.capture_buffer_seconds > 0:
            required = max_dur + pre_capture + 30.0
            if self.capture_buffer_seconds >= required:
                return max(default, float(self.capture_buffer_seconds))
        return max(default, derived)


@dataclasses.dataclass
class SpeciesSettings:
    include: list[str] = dataclasses.field(default_factory=list)
    exclude: list[str] = dataclasses.field(default_factory=list)
    # per-species config: {"Sci name": {"threshold": 0.x, "interval": s}}
    config: dict[str, dict[str, Any]] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RealtimeSettings:
    interval_seconds: float = 15.0    # repeated-species log interval
    capture_buffer_seconds: float = 120.0
    sources: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    # global quiet-hours windows applied to every source; entries are
    # {"start","end"} dicts or "22:00-06:00" / "sunset+30m to sunrise-30m"
    # strings (quiet_hours.go). A source dict's own "quiet_hours" key adds
    # per-source windows on top.
    quiet_hours: list[Any] = dataclasses.field(default_factory=list)
    # scheduler
    tick_ms: int = 100                # buffer monitor poll (buffer_manager.go:392)
    # adaptive cadence floor: the loop ticks this fast when the host is
    # idle (end-to-end latency quantizes to the tick period); stretches
    # back to tick_ms as tick busy time grows. 0/None = fixed tick.
    min_tick_ms: int = 15
    max_batch: int = 256              # device megabatch size per model
    # store inter-block CNN activations as int8 in HBM: measured +2.8%
    # step throughput on v5e (BENCH_r05 act8_boundaries), parity-gated
    # (<0.02 post-sigmoid drift, top-5 stable — tests/test_quantized.py).
    # Default off: the north star is detection-table parity with the
    # TFLite reference, and the cast is lossy. Applies to native mel-CNN
    # families; imported (.tflite/.onnx) graphs ignore it.
    act_int8: bool = False
    # device batches a model may dispatch per tick (the steady-state
    # ceiling is max_batch × max_dispatches_per_tick per tick); >1 removes
    # the round-2 one-batch-per-tick cap (VERDICT r2 #1). 11 puts the
    # configured ceiling (42.2k streams) above the measured single-model
    # kernel capacity (40.8k, BENCH r3) so the shipped config never caps
    # the chip; ~79 ms device time per 100 ms tick at p50 7.2 ms/batch.
    max_dispatches_per_tick: int = 11
    pipeline_depth: int = 2           # in-flight device batches per model


@dataclasses.dataclass
class SpeciesTrackingSettings:
    """New/yearly/seasonal species tracking (reference:
    SpeciesTrackingSettings, conf/config.go:929-936): a species shows as
    "new" for window_days after first detection; duplicate new-species
    notifications are suppressed for suppression hours (default 168)."""

    enabled: bool = True
    new_species_window_days: int = 7
    notification_suppression_hours: float = 168.0


@dataclasses.dataclass
class EBirdSettings:
    """eBird API v2 client (internal/ebird)."""

    enabled: bool = False
    api_token: str = ""


@dataclasses.dataclass
class TelemetrySettings:
    """Opt-in scrubbed error reporting (internal/telemetry); OFF by
    default — a DSN must be set AND enabled flipped on."""

    enabled: bool = False
    dsn: str = ""


@dataclasses.dataclass
class ImageProviderSettings:
    """Species images for the dashboard (internal/imageprovider)."""

    enabled: bool = True
    providers: list[str] = dataclasses.field(
        default_factory=lambda: ["avicommons", "wikimedia"])
    avicommons_dataset: str | None = None   # path to latest.json when present


@dataclasses.dataclass
class SoundLevelSettings:
    """1/3-octave sound-level publication (sound_level*.go)."""

    enabled: bool = True
    interval_seconds: float = 10.0


@dataclasses.dataclass
class MqttSettings:
    enabled: bool = False
    host: str = "127.0.0.1"
    port: int = 1883
    username: str | None = None
    password: str | None = None
    topic: str = "birdnet"
    retain: bool = False
    tls: bool = False
    ha_discovery: bool = True


@dataclasses.dataclass
class BirdWeatherSettings:
    enabled: bool = False
    station_token: str = ""


@dataclasses.dataclass
class WeatherSettings:
    provider: str = "none"             # none|yrno|openweather|wunderground
    openweather_api_key: str = ""
    wunderground_station_id: str = ""
    wunderground_api_key: str = ""
    poll_interval_hours: float = 1.0


@dataclasses.dataclass
class NotificationSettings:
    # targets: [{"name","kind","url","body_template","min_interval_seconds"}]
    targets: list[dict[str, Any]] = dataclasses.field(default_factory=list)
    notify_new_species: bool = True


@dataclasses.dataclass
class AlertingSettings:
    # rules: list of AlertRule field dicts (analysis/alerting.py)
    rules: list[dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class MonitoringSettings:
    """System resource monitor (internal/monitor README): a pure metric
    collector feeding cpu/memory/per-mount-disk samples into the
    alerting engine. Thresholds live in metric ALERT RULES, not here."""

    enabled: bool = True
    check_interval_seconds: float = 60.0
    cpu: bool = True
    memory: bool = True
    disk: bool = True
    # extra disk paths; database/clips/config mounts are auto-detected
    disk_paths: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RetentionSettings:
    mode: str = "none"                 # none|age|usage
    max_age_days: float = 30.0
    max_usage_percent: float = 80.0
    check_interval_hours: float = 1.0


@dataclasses.dataclass
class WebServerSettings:
    enabled: bool = True
    host: str = "0.0.0.0"
    port: int = 8080
    auth_token: str | None = None       # static bearer token (optional)
    allow_local_bypass: bool = True     # local subnets skip auth
    # CIDR allowlist narrowing the default RFC1918 bypass set
    # (doc/wiki/security.md: "keep the subnet narrow"); [] = defaults
    bypass_subnets: list[str] = dataclasses.field(default_factory=list)
    # Basic-auth + OAuth2 flow (internal/security): setting a password
    # enables the login page, session cookies with CSRF, and the
    # authorization-code/client-credentials token endpoints.
    password: str | None = None
    session_hours: float = 24.0 * 7
    oauth_client_id: str = "birdnet-client"
    oauth_client_secret: str | None = None
    # authorization-code redirect targets; a redirect_uri not in this
    # allowlist is refused (open-redirect / code-exfiltration guard)
    oauth_redirect_uris: list[str] = dataclasses.field(default_factory=list)
    token_file: str = "data/tokens.json"
    gzip: bool = True
    secure_headers: bool = True
    # HTTPS (internal/tls): when enabled and no certificate is installed
    # under tls_dir, a self-signed EC P-256 pair is generated at startup
    # with SANs from host/base_url/interfaces (sans.go CollectSANs).
    tls_enabled: bool = False
    tls_dir: str = "data/tls"
    # "self-signed" (default) or "acme" (Let's Encrypt AutoTLS —
    # reference server.go:601-633; needs acme_domain + port-80 reach)
    tls_mode: str = "self-signed"
    acme_domain: str = ""
    acme_directory: str = ""          # empty → Let's Encrypt production
    acme_contact: str = ""            # optional mailto contact
    base_url: str = ""                  # public URL, feeds certificate SANs
    # OIDC / SSO login (reference: social + OIDC providers): point at any
    # OpenID Connect issuer; allowed = emails or "@domain" entries
    oidc_issuer: str = ""
    oidc_client_id: str = ""
    oidc_client_secret: str | None = None
    oidc_allowed: list[str] = dataclasses.field(default_factory=list)
    # GitHub social login (reference: goth GitHub provider)
    github_client_id: str = ""
    github_client_secret: str | None = None
    github_allowed: list[str] = dataclasses.field(default_factory=list)
    # Cloudflare Access bypass (doc/wiki/security.md): trust requests
    # whose Cf-Access-Jwt-Assertion validates against the team's JWKS
    cloudflare_bypass_enabled: bool = False
    cloudflare_team_domain: str = ""
    cloudflare_audience: str = ""


@dataclasses.dataclass
class BackupSettings:
    enabled: bool = False
    target_dir: str = "data/backups"
    keep: int = 7
    interval_hours: float = 24.0
    passphrase: str = ""        # non-empty → AES-256-GCM encrypted archives
    # target type: local | ftp | s3 | sftp | rsync (utils.backup targets;
    # reference internal/backup target registry). `remote` carries the
    # target's constructor kwargs (host/user/bucket/dest/...).
    target: str = "local"
    remote: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class AudioFilterSettings:
    """Per-stream equalizer applied ahead of every consumer
    (audiocore/equalizer builder.go; RBJ biquad chains)."""

    enabled: bool = False
    # [{"type": "highpass", "frequency": 300, "q": 0.7071, "gain": 0.0}]
    filters: list[dict[str, Any]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class LogSettings:
    """Structured logging (internal/logger: buffered rotating file writers,
    per-module levels, WARN+ teed into the health error ring)."""

    level: str = "info"                 # debug|info|warning|error
    path: str = ""                      # "" = stderr only
    max_size_mb: float = 10.0           # rotate when the file exceeds this
    keep: int = 3                       # rotated generations retained
    module_levels: dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LivenessSettings:
    enabled: bool = True
    silence_timeout_seconds: float = 60.0
    recovery_timeout_seconds: float = 30.0
    max_recovery_attempts: int = 3
    check_interval_seconds: float = 10.0


@dataclasses.dataclass
class DatabaseSettings:
    type: str = "sqlite"               # sqlite | mysql
    path: str = "data/birdnet.db"
    # MySQL (wire-level driver, datastore/mysql.py)
    host: str = "127.0.0.1"
    port: int = 3306
    user: str = "birdnet"
    password: str = ""
    name: str = "birdnet"


@dataclasses.dataclass
class LocationSettings:
    latitude: float | None = None
    longitude: float | None = None


@dataclasses.dataclass
class Settings:
    models: list[ModelSettings] = dataclasses.field(
        default_factory=lambda: [ModelSettings()])
    location: LocationSettings = dataclasses.field(default_factory=LocationSettings)
    range_filter: RangeFilterSettings = dataclasses.field(
        default_factory=RangeFilterSettings)
    privacy_filter: PrivacyFilterSettings = dataclasses.field(
        default_factory=PrivacyFilterSettings)
    dog_bark_filter: DogBarkFilterSettings = dataclasses.field(
        default_factory=DogBarkFilterSettings)
    daylight_filter: DaylightFilterSettings = dataclasses.field(
        default_factory=DaylightFilterSettings)
    ultrasonic_filter: UltrasonicFilterSettings = dataclasses.field(
        default_factory=UltrasonicFilterSettings)
    soundlevel: SoundLevelSettings = dataclasses.field(
        default_factory=SoundLevelSettings)
    imageprovider: ImageProviderSettings = dataclasses.field(
        default_factory=ImageProviderSettings)
    ebird: EBirdSettings = dataclasses.field(default_factory=EBirdSettings)
    telemetry: TelemetrySettings = dataclasses.field(
        default_factory=TelemetrySettings)
    dynamic_threshold: DynamicThresholdSettings = dataclasses.field(
        default_factory=DynamicThresholdSettings)
    deep_detection: DeepDetectionSettings = dataclasses.field(
        default_factory=DeepDetectionSettings)
    export: ExportSettings = dataclasses.field(default_factory=ExportSettings)
    extended_capture: ExtendedCaptureSettings = dataclasses.field(
        default_factory=ExtendedCaptureSettings)
    species_tracking: SpeciesTrackingSettings = dataclasses.field(
        default_factory=SpeciesTrackingSettings)
    species: SpeciesSettings = dataclasses.field(default_factory=SpeciesSettings)
    realtime: RealtimeSettings = dataclasses.field(default_factory=RealtimeSettings)
    webserver: WebServerSettings = dataclasses.field(default_factory=WebServerSettings)
    database: DatabaseSettings = dataclasses.field(default_factory=DatabaseSettings)
    mqtt: MqttSettings = dataclasses.field(default_factory=MqttSettings)
    birdweather: BirdWeatherSettings = dataclasses.field(
        default_factory=BirdWeatherSettings)
    weather: WeatherSettings = dataclasses.field(default_factory=WeatherSettings)
    notification: NotificationSettings = dataclasses.field(
        default_factory=NotificationSettings)
    retention: RetentionSettings = dataclasses.field(
        default_factory=RetentionSettings)
    alerting: AlertingSettings = dataclasses.field(
        default_factory=AlertingSettings)
    monitoring: MonitoringSettings = dataclasses.field(
        default_factory=MonitoringSettings)
    backup: BackupSettings = dataclasses.field(default_factory=BackupSettings)
    liveness: LivenessSettings = dataclasses.field(
        default_factory=LivenessSettings)
    log: LogSettings = dataclasses.field(default_factory=LogSettings)
    audio_filters: AudioFilterSettings = dataclasses.field(
        default_factory=AudioFilterSettings)
    data_dir: str | None = None

    def validate(self) -> list[str]:
        """Returns human-readable warnings (reference surfaces config
        validation as notifications — main.go:212-227)."""
        warnings = []
        for m in self.models:
            if not (0.0 <= m.sensitivity <= 1.5):
                warnings.append(
                    f"{m.model_id}: sensitivity {m.sensitivity} outside "
                    f"[0, 1.5], clamping")
                m.sensitivity = min(max(m.sensitivity, 0.0), 1.5)
            if not (0.0 <= m.threshold <= 1.0):
                warnings.append(
                    f"{m.model_id}: threshold {m.threshold} outside [0, 1]")
                m.threshold = min(max(m.threshold, 0.0), 1.0)
            if not (0.0 <= m.overlap <= 2.9):
                warnings.append(
                    f"{m.model_id}: overlap {m.overlap} outside [0, 2.9]")
                m.overlap = min(max(m.overlap, 0.0), 2.9)
        lat, lon = self.location.latitude, self.location.longitude
        if (lat is None) != (lon is None):
            warnings.append("latitude/longitude must both be set; range "
                            "filter disabled")
            self.location.latitude = self.location.longitude = None
        if lat is not None and not (-90 <= lat <= 90):
            warnings.append(f"latitude {lat} invalid; location cleared")
            self.location.latitude = self.location.longitude = None
        if lon is not None and not (-180 <= lon <= 180):
            warnings.append(f"longitude {lon} invalid; location cleared")
            self.location.latitude = self.location.longitude = None
        if not (0 <= self.deep_detection.level <= 5):
            warnings.append("deep_detection.level must be 0-5; reset to 0")
            self.deep_detection.level = 0
        ec = self.extended_capture
        if ec.enabled:
            if ec.max_duration_seconds > ec.MAX_DURATION_CAP:
                warnings.append(
                    f"extended_capture.max_duration_seconds "
                    f"{ec.max_duration_seconds} exceeds the "
                    f"{ec.MAX_DURATION_CAP}s cap; clamping")
                ec.max_duration_seconds = ec.MAX_DURATION_CAP
            required = (ec.max_duration_seconds
                        + self.export.pre_capture_seconds + 30.0)
            if 0 < ec.capture_buffer_seconds < required:
                warnings.append(
                    f"extended_capture.capture_buffer_seconds "
                    f"{ec.capture_buffer_seconds} is smaller than "
                    f"max_duration + pre_capture + 30 "
                    f"({required:.0f}s); using the derived ring size")
        return warnings


def _from_dict(cls, data: dict[str, Any]):
    """Recursively build a dataclass from a dict, ignoring unknown keys."""
    if not dataclasses.is_dataclass(cls):
        return data
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, val in (data or {}).items():
        f = fields.get(key)
        if f is None:
            continue
        ftype = f.type if not isinstance(f.type, str) else None
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default  # noqa: E501
        if dataclasses.is_dataclass(default) and isinstance(val, dict):
            kwargs[key] = _merge_dataclass(default, val)
        elif isinstance(default, list) and val and isinstance(val[0], dict) \
                and key == "models":
            kwargs[key] = [_merge_dataclass(ModelSettings(), v) for v in val]
        else:
            kwargs[key] = val
        del ftype
    return cls(**kwargs)


class CoerceError(ValueError):
    """A PATCH value that cannot become the field's annotated type.
    Carries the offending field name so the API can return a structured
    {"error", "field"} 400 and the SPA can anchor the message to the
    input (reference: per-field validation feedback, Settings.svelte)."""

    def __init__(self, key: str, msg: str):
        super().__init__(msg)
        self.key = key


def _coerce_scalar(annot: str, val: Any, key: str) -> Any:
    """Coerce an incoming PATCH value to the field's annotated scalar
    type, or raise CoerceError.  An API client sending "13.4" where a
    float is declared must get a 400, not corrupt the live settings
    tree and 500 later in validate() (found by the SPA runtime gate:
    a schema-less null field serialized numbers as strings)."""
    if val is None:
        return None
    # Anchor on the first non-None union member: "float | None" → float
    # branch, but "list[float]" / "dict[str, float]" must NOT — substring
    # matching would coerce a scalar into a container-typed field, and
    # unions outside the heuristics fell through silently (advisor r4).
    members = [m.strip() for m in annot.split("|")] if annot else []
    annot = next((m for m in members if m != "None"), "")
    if annot == "float":
        if isinstance(val, bool):
            raise CoerceError(key, f"{key}: expected number, got boolean")
        if isinstance(val, (int, float)):
            return float(val)
        if isinstance(val, str):
            try:
                return float(val)
            except ValueError:
                raise CoerceError(key, f"{key}: expected number, got {val!r}")
        raise CoerceError(key, f"{key}: expected number, got "
                         f"{type(val).__name__}")
    if annot == "int":
        if isinstance(val, bool):
            raise CoerceError(key, f"{key}: expected integer, got boolean")
        if isinstance(val, int):
            return val
        if isinstance(val, float) and val.is_integer():
            return int(val)
        if isinstance(val, str):
            try:
                return int(val)
            except ValueError:
                raise CoerceError(key, f"{key}: expected integer, got {val!r}")
        raise CoerceError(key, f"{key}: expected integer, got "
                         f"{type(val).__name__}")
    if annot == "bool":
        if isinstance(val, bool):
            return val
        raise CoerceError(key, f"{key}: expected boolean, got "
                         f"{type(val).__name__}")
    if annot == "str":
        if isinstance(val, str):
            return val
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            return str(val)
        raise CoerceError(key, f"{key}: expected string, got "
                         f"{type(val).__name__}")
    return val


def _merge_dataclass(instance, data: dict[str, Any]):
    types = ({f.name: str(f.type) for f in dataclasses.fields(instance)}
             if dataclasses.is_dataclass(instance) else {})
    for key, val in (data or {}).items():
        if not hasattr(instance, key):
            continue
        cur = getattr(instance, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            _merge_dataclass(cur, val)
        else:
            annot = types.get(key, "")
            if annot and not isinstance(val, (dict, list)):
                val = _coerce_scalar(annot, val, key)
            setattr(instance, key, val)
    return instance


def restore_settings_in_place(instance, snapshot) -> None:
    """Roll a Settings tree back to a deepcopy snapshot WITHOUT
    replacing the dataclass objects — long-lived components hold
    references to the live section instances."""
    import copy

    for f in dataclasses.fields(instance):
        cur = getattr(instance, f.name)
        snap = getattr(snapshot, f.name)
        if dataclasses.is_dataclass(cur) and dataclasses.is_dataclass(snap) \
                and type(cur) is type(snap):
            restore_settings_in_place(cur, snap)
        else:
            setattr(instance, f.name, copy.deepcopy(snap))


def default_settings() -> Settings:
    return Settings()


def load_settings(path: str | Path | None = None,
                  env: dict[str, str] | None = None) -> Settings:
    """YAML file → Settings, then env overrides, then validation.

    yaml is loaded here, where a file is read, so that the module imports
    where yaml is missing (a card's machine may lack it). There a file
    that parses as JSON is read with ``json``: ``yaml.safe_load`` reads a
    JSON document as the same mapping. Any other file then raises
    ``ImportError`` naming yaml."""
    s = Settings()
    if path:
        s = _from_dict(Settings, _read_config(Path(path).read_text()) or {})
    _apply_env_overrides(s, env if env is not None else dict(os.environ))
    return s


def _read_config(text: str) -> Any:
    """A config file's document: yaml's reading, else, where yaml is
    missing, JSON's."""
    try:
        yaml = importlib.import_module("yaml")
    except ImportError as e:
        if not text.strip():
            return None                      # an empty document, as yaml's
        try:
            return json.loads(text)
        except ValueError:
            raise ImportError(
                f"reading a YAML config needs the yaml package ({e}); "
                f"without it the config must be JSON") from e
    return yaml.safe_load(text)


def _apply_env_overrides(s: Settings, env: dict[str, str]) -> None:
    prefix = "BIRDNET_TPU_"
    for key, val in env.items():
        if not key.startswith(prefix) or key in ("BIRDNET_TPU_DATA",
                                                 "BIRDNET_TPU_MODELS"):
            continue
        parts = key[len(prefix):].lower().split("__")
        target: Any = s
        ok = True
        for p in parts[:-1]:
            if not hasattr(target, p):
                ok = False
                break
            target = getattr(target, p)
        if not ok or not hasattr(target, parts[-1]):
            continue
        cur = getattr(target, parts[-1])
        try:
            if isinstance(cur, bool):
                parsed: Any = val.lower() in ("1", "true", "yes", "on")
            elif isinstance(cur, int) and not isinstance(cur, bool):
                parsed = int(val)
            elif isinstance(cur, float):
                parsed = float(val) if val.replace(
                    ".", "", 1).lstrip("-").isdigit() else val
            elif cur is None:
                # a None default says nothing about the type — consult the
                # field annotation: float|None (latitude) coerces, but
                # str|None (password, auth_token, secrets) must STAY a
                # string even when numeric-looking, or auth breaks
                # (configured.encode() on a float)
                ann = ""
                if dataclasses.is_dataclass(target):
                    ann = str({f.name: f.type for f in
                               dataclasses.fields(target)}.get(
                                   parts[-1], ""))
                if ("float" in ann or "int" in ann) and val.replace(
                        ".", "", 1).lstrip("-").isdigit():
                    parsed = float(val) if "float" in ann else int(val)
                else:
                    parsed = val
            else:
                parsed = val
        except ValueError:
            continue
        setattr(target, parts[-1], parsed)
