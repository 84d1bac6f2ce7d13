"""The port's MySQL datastore (``datastore/mysql_wire.py``,
``datastore/mysql.py``) and its test server (``diag/mysql_server.py``)
against the JAX package's, on the CPU.

The wire client of each package connects to each server (JAX's test
server, ``tests/test_mysql.py::FakeMySQLServer``, and the port's copy) in
every auth mode, with the right and a wrong password: the outcomes are
equal. Escaping, typed values and ``translate_sql`` are held to JAX's.
Every public ``Datastore`` method runs through both packages'
``MySQLDatastore``, each on a port server of its own, on the same seeded
rows: its result and every table afterwards are equal, and the port's
equal its own SQLite ``Datastore``'s. Where the port differs, by a
statement MySQL refuses (``DIALECT_REPAIRS``) or a method that JAX's
fails on MySQL (``wal_checkpoint``), a test of its own says so, and every
statement the port sends is checked against the constructs MySQL does
not take (``_mysql_lint``).
"""

from __future__ import annotations

import dataclasses
import datetime
import importlib
import re
import time
from types import SimpleNamespace

import pytest

from birdnet_go_tpu_torch.diag.mysql_server import MySQLServer
from tests.test_mysql import FakeMySQLServer


def _pkg(name: str) -> SimpleNamespace:
    return SimpleNamespace(**{k: importlib.import_module(f"{name}.{path}")
                              for k, path in (
        ("mysql", "datastore.mysql"), ("wire", "datastore.mysql_wire"),
        ("sqlite", "datastore.sqlite"), ("results", "analysis.results"),
        ("labels", "taxonomy.labels"), ("processor", "analysis.processor"),
        ("dynamic", "analysis.dynamic_threshold"))})


J, T = _pkg("birdnet_go_tpu"), _pkg("birdnet_go_tpu_torch")
PASSWORD = "sekret"

AUTH_MODES = {
    "native": {},
    "native-switch": {"auth_switch": True},
    "sha2-fast": {"plugin": "caching_sha2_password"},
    "sha2-full-rsa": {"plugin": "caching_sha2_password",
                      "sha2_full_auth": True},
    "sha2-switch": {"plugin": "caching_sha2_password", "auth_switch": True},
}


def _server(kind: str, **kw):
    if kind == "jax":
        s = FakeMySQLServer(password=PASSWORD, **kw)
    else:
        s = MySQLServer(password=PASSWORD, full_auth_first_only=False, **kw)
    s.start()
    return s


def _outcome(P, port: int, password: str):
    try:
        c = P.wire.MySQLConnection(port=port, user="bird", password=password)
    except P.wire.MySQLError as e:
        return ("refused", e.code)
    try:
        return ("ok", c.server_version, c.ping())
    finally:
        c.close()


@pytest.mark.parametrize("server", ["jax", "port"])
@pytest.mark.parametrize("mode", sorted(AUTH_MODES))
def test_handshake_as_jax(mode, server):
    """Each package's client against each server, in each auth mode:
    connected and pinged with the password, refused (1045) without."""
    out = {}
    for P in (J, T):
        s = _server(server, **AUTH_MODES[mode])
        try:
            out[id(P)] = [_outcome(P, s.port, PASSWORD),
                          _outcome(P, s.port, "wrong")]
        finally:
            s.stop()
    assert out[id(T)] == out[id(J)] == [("ok", "8.0.fake", True),
                                        ("refused", 1045)]


def test_full_auth_on_the_first_connection_only():
    """The port's server asks for RSA full auth on a user's first
    connection and takes the fast path after it, as MySQL 8's cache does:
    both clients pass both."""
    for P in (J, T):
        s = MySQLServer(password=PASSWORD, plugin="caching_sha2_password",
                        sha2_full_auth=True)
        s.start()
        try:
            assert [_outcome(P, s.port, PASSWORD) for _ in range(3)] == \
                [("ok", "8.0.fake", True)] * 3
            assert s.full_auths == 1
        finally:
            s.stop()


def test_auth_tokens_and_rsa_blob_as_jax():
    """The scrambles are JAX's bytes; the RSA blob decrypts to the same
    XORed password (OAEP is randomised, so the blobs differ)."""
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import padding, rsa

    scramble = bytes(range(7, 27))
    for pw in ("", "sekret", "pässwörd"):
        assert T.wire.native_password_token(pw, scramble) == \
            J.wire.native_password_token(pw, scramble)
        assert T.wire.caching_sha2_token(pw, scramble) == \
            J.wire.caching_sha2_token(pw, scramble)
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    pem = key.public_key().public_bytes(
        serialization.Encoding.PEM,
        serialization.PublicFormat.SubjectPublicKeyInfo)
    pad = padding.OAEP(mgf=padding.MGF1(hashes.SHA1()),
                       algorithm=hashes.SHA1(), label=None)
    plain = [key.decrypt(P.wire.sha2_rsa_encrypt("sekret", scramble, pem),
                         pad) for P in (J, T)]
    assert plain[0] == plain[1]


ESCAPED = [None, True, False, 0, -7, 3.25, 1e-5, "plain", "it's", "a\\b",
           "x\ny", "tab\tbed", "nul\x00", "ünïcødé", b"\x00\x01\xff", "",
           "'; DROP TABLE detections; --"]


def test_escape_as_jax():
    assert [T.wire.escape(v) for v in ESCAPED] == \
        [J.wire.escape(v) for v in ESCAPED]


@pytest.mark.parametrize("server", ["jax", "port"])
def test_query_roundtrip_and_typed_values_as_jax(server):
    """Every escaped value stored and read back, typed by the column
    definitions, through each client on each server; and an error."""
    out = {}
    for P in (J, T):
        s = _server(server)
        try:
            c = P.wire.MySQLConnection(port=s.port, password=PASSWORD)
            c.execute("CREATE TABLE v (id INTEGER PRIMARY KEY AUTOINCREMENT,"
                      " t TEXT, i INTEGER, r REAL)")
            rec = []
            # (a NUL the test servers cannot pass on: SQLite refuses it
            # in a statement's text)
            for k, v in enumerate(x for x in ESCAPED
                                  if isinstance(x, str) and "\x00" not in x):
                rec.append(c.execute("INSERT INTO v (t, i, r) VALUES"
                                     " (?, ?, ?)", (v, k, k / 4)))
            rec.append(c.query("SELECT id, t, i, r FROM v ORDER BY id"))
            rec.append(c.query("SELECT t FROM v WHERE t = ?", ("0123",)))
            c.execute("INSERT INTO v (t) VALUES (?)", ("0123",))
            rec.append(c.query("SELECT t, i FROM v WHERE t = ?", ("0123",)))
            with pytest.raises(P.wire.MySQLError) as e:
                c.query("SELECT broken syntax FROM")
            rec.append(e.value.code)
            with pytest.raises(ValueError):
                c.execute("INSERT INTO v (t) VALUES (?)", ("a", "b"))
            c.close()
            out[id(P)] = rec
        finally:
            s.stop()
    assert out[id(T)] == out[id(J)]
    assert out[id(T)][-2] == (["t", "i"], [("0123", None)])  # TEXT stays str


def test_servers_answer_alike():
    """The port's server answers what JAX's test server answers, statement
    for statement, through one client; but it lists no table of SQLite's
    own (``sqlite_sequence``), and its ``SHOW TABLE STATUS`` gives MySQL's
    first columns where JAX's gives the name only."""
    script = ["CREATE TABLE a (id INTEGER PRIMARY KEY AUTO_INCREMENT,"
              " n VARCHAR(191), x REAL)",
              "INSERT INTO a (n, x) VALUES ('p', 1.5)",
              "INSERT INTO a (n, x) VALUES ('q', NULL)",
              "SELECT * FROM a ORDER BY id", "SHOW COLUMNS FROM a",
              "SHOW TABLES", "OPTIMIZE TABLE a",
              "SELECT CAST('12' AS SIGNED) AS k",
              "UPDATE a SET x = 2 WHERE n = 'p'", "DELETE FROM a WHERE id = 9"]
    out = {}
    for kind in ("jax", "port"):
        s = _server(kind)
        try:
            c = T.wire.MySQLConnection(port=s.port, password=PASSWORD)
            out[kind] = [c.query(q) if q.startswith(("SELECT", "SHOW",
                                                     "OPTIMIZE"))
                         else c.execute(q) for q in script]
            cols, names = out[kind][5]
            out[kind][5] = (cols, [n for n in names
                                   if n != ("sqlite_sequence",)])
            status = c.query("SHOW TABLE STATUS")
            out[kind].append([r[0] for r in status[1]
                              if r[0] != "sqlite_sequence"])
            c.close()
        finally:
            s.stop()
    assert out["port"] == out["jax"]


# -- translate_sql ---------------------------------------------------------------------

def test_translate_sql_as_jax_on_jax_cases():
    cases = ["id INTEGER AUTOINCREMENT", "CAST(x AS INTEGER)",
             "INSERT INTO t (a) VALUES (?) ON CONFLICT(a) DO UPDATE SET"
             " b=excluded.b",
             "INSERT OR REPLACE INTO hourly_weather (time) VALUES (?)",
             J.sqlite._SCHEMA]
    for sql in cases[:-1]:
        assert T.mysql.translate_sql(sql) == J.mysql.translate_sql(sql)
    for stmt in J.sqlite._SCHEMA.split(";"):
        assert T.mysql.translate_sql(stmt) == J.mysql.translate_sql(stmt)


# what the port's translate_sql adds to JAX's, each a statement of the
# port's Datastore that MySQL refuses as JAX sends it
DIALECT_REPAIRS = {
    "SELECT COUNT(*) FROM (SELECT 1 FROM detections WHERE date = ?"
    " AND scientific_name = ? LIMIT 2)":
    "SELECT COUNT(*) FROM (SELECT 1 FROM detections WHERE date = ?"
    " AND scientific_name = ? LIMIT 2) AS _d0",
    "SELECT x FROM (SELECT a FROM (SELECT b AS a FROM t)) WHERE x > 0":
    "SELECT x FROM (SELECT a FROM (SELECT b AS a FROM t) AS _d0) AS _d1"
    " WHERE x > 0",
    "SELECT x FROM (SELECT a FROM t) s": "SELECT x FROM (SELECT a FROM t) s",
    "UPDATE d SET f = MIN(f, excluded.f), l = MAX(l, excluded.l)":
    "UPDATE d SET f = LEAST(f, VALUES(f)), l = GREATEST(l, VALUES(l))",
    "SELECT MIN(time), MAX(date) FROM detections":
    "SELECT MIN(time), MAX(date) FROM detections",
}


@pytest.mark.parametrize("sql", sorted(DIALECT_REPAIRS))
def test_translate_sql_repairs(sql):
    assert T.mysql.translate_sql(sql) == DIALECT_REPAIRS[sql]


_LINT = {
    "a SQLite upsert": re.compile(r"ON CONFLICT|excluded\.|INSERT OR",
                                  re.I),
    "AUTOINCREMENT": re.compile(r"AUTOINCREMENT", re.I),
    "CAST AS INTEGER": re.compile(r"AS INTEGER\)", re.I),
    "CREATE INDEX IF NOT EXISTS": re.compile(
        r"CREATE INDEX IF NOT EXISTS", re.I),
    "a PRAGMA": re.compile(r"^\s*PRAGMA", re.I),
    "sqlite_master": re.compile(r"sqlite_master", re.I),
    "TEXT in a key": re.compile(r"TEXT (PRIMARY KEY|UNIQUE)", re.I),
    "a TEXT default": re.compile(r"TEXT NOT NULL DEFAULT", re.I),
}


def _mysql_lint(sql: str) -> list[str]:
    """The constructs of `sql` that MySQL does not take (a statement the
    server received), each by name."""
    bad = [name for name, pat in _LINT.items() if pat.search(sql)]

    def closing(k: int) -> int:               # the ")" of the "(" at k
        depth = 0
        for k in range(k, len(sql)):
            depth += {"(": 1, ")": -1}.get(sql[k], 0)
            if depth == 0:
                return k
        return len(sql)

    for m in re.finditer(r"\bFROM\s*\(\s*SELECT\b", sql, re.I):
        k = closing(sql.index("(", m.start()))
        if not re.match(r"\s*(AS\s+)?\w", sql[k + 1:]) or re.match(
                r"\s*(WHERE|GROUP|ORDER|LIMIT)\b", sql[k + 1:], re.I):
            bad.append("a derived table without an alias")
    for m in re.finditer(r"\b(MIN|MAX)\(", sql, re.I):
        k = closing(m.end() - 1)
        depth = 0
        for ch in sql[m.end():k]:
            depth += {"(": 1, ")": -1}.get(ch, 0)
            if ch == "," and depth == 0:
                bad.append("a scalar two-argument MIN/MAX")
                break
    return bad


# -- every Datastore method ------------------------------------------------------------

NOW = time.time()
DAY0 = datetime.date.fromtimestamp(NOW)
SPECIES = [("Turdus merula", "Eurasian Blackbird", "eurbla"),
           ("Parus major", "Great Tit", "gretit1"),
           ("Strix aluco", "Tawny Owl", "tawowl1"),
           ("Erithacus rubecula", "European Robin", "eurrob1")]


def _detection(P, k: int):
    sci, common, code = SPECIES[k % len(SPECIES)]
    ts = NOW - 3600.0 * (k * 5 + 1) - 86400.0 * (k % 3)
    return P.results.Detection(
        species=P.labels.Species(sci, common),
        confidence=0.5 + 0.04 * k, begin_seconds=ts, end_seconds=ts + 3,
        model_id="BirdNET_V2.4" if k % 4 else "Perch_V2",
        source_id=f"s{k % 2}", timestamp=datetime.datetime.fromtimestamp(ts),
        species_code=code)


def _seed(P, ds) -> None:
    """The same rows through either package: 12 detections over 3 days
    (contributions, top-3 results, clips), reviews, comments, a lock,
    thresholds and their events, notifications, weather and images."""
    mc = P.processor.ModelContribution
    for k in range(12):
        ds.insert_detection(
            _detection(P, k), clip_name=f"2026/01/c{k}.flac" if k % 3 else "",
            contributions={"BirdNET_V2.4": mc("BirdNET_V2.4", k + 1,
                                              0.5 + 0.01 * k)},
            results=[(s, c, 0.9 - 0.1 * r) for r, (s, c, _) in
                     enumerate(SPECIES[:3])])
    ds.review_detection(2, "correct", "sure")
    ds.review_detection(3, "false_positive")
    ds.review_detection(3, "correct", "changed mind")
    ds.review_detection(5, "false_positive")
    ds.add_comment(1, "first comment")
    ds.add_comment(1, "it's a 'quoted' one\\")
    ds.lock_detection(4, True)
    ds.save_dynamic_thresholds({
        ("BirdNET_V2.4", "Parus major"): P.dynamic.ThresholdState(
            level=2, high_conf_count=3, expires_at=NOW + 60,
            last_learned_at=NOW - 5)})
    ds.save_threshold_event(P.dynamic.ThresholdEvent(
        "BirdNET_V2.4", "Parus major", 0, 1, 0.8, 0.7, "high_confidence",
        0.95, NOW - 100))
    for k in range(3):
        ds.save_notification(f"n{k}", "msg", "high", NOW - 1000 * k,
                             '{"k": %d}' % k)
    for h in range(3):
        ds.save_hourly_weather(NOW - 3600.0 * h, temperature=10.5 + h,
                               humidity=70.0, pressure=1013.0,
                               wind_speed=3.2, wind_deg=180.0, clouds=50.0,
                               description="cloudy", icon="04")
    ds.save_image_cache("parus major", url="http://img/1.jpg",
                        thumbnail_url="t", author="a", license="l",
                        provider="p", cached_at=5.0)


D = DAY0.isoformat()
D_FROM = (DAY0 - datetime.timedelta(days=5)).isoformat()
METHODS = {
    "add_comment": lambda ds: ds.add_comment(2, "wire comment"),
    "clear_clip_names": lambda ds: ds.clear_clip_names(
        ["2026/01/c1.flac", "2026/01/c2.flac", "missing"]),
    "confidence_histogram": lambda ds: ds.confidence_histogram(5),
    "count_detections": lambda ds: (ds.count_detections(),
                                    ds.count_detections(D)),
    "count_duplicate_detections": lambda ds: ds.count_duplicate_detections(),
    "count_species": lambda ds: (ds.count_species(), ds.count_species(D)),
    "daily_counts": lambda ds: ds.daily_counts(D_FROM, D),
    "daily_species_summary": lambda ds: ds.daily_species_summary(D, 0.55),
    "database_details": lambda ds: ds.database_details(),
    "delete_comment": lambda ds: (ds.delete_comment(1), ds.delete_comment(9)),
    "delete_detection": lambda ds: (ds.delete_detection(1),
                                    ds.delete_detection(99)),
    "delete_expired_notifications":
        lambda ds: ds.delete_expired_notifications(NOW - 500),
    "delete_notification": lambda ds: (ds.delete_notification(1),
                                       ds.delete_notification(99)),
    "detection_heatmap": lambda ds: ds.detection_heatmap(D_FROM, D),
    "detection_trends": lambda ds: ds.detection_trends(7),
    "detections_since": lambda ds: ds.detections_since(NOW - 86400, 5),
    "diversity": lambda ds: ds.diversity(D_FROM, D),
    "doctor": lambda ds: (ds.doctor(), ds.doctor(fix=True)),
    "first_detection_per_day": lambda ds: (
        ds.first_detection_per_day(), ds.first_detection_per_day(
            "Parus major", D_FROM, D)),
    "get_clip_references": lambda ds: (ds.get_clip_references(),
                                       ds.get_clip_references(5, 3)),
    "get_daily_events": lambda ds: (ds.get_daily_events(D),
                                    ds.get_daily_events("1999-01-01")),
    "get_detection": lambda ds: (ds.get_detection(3), ds.get_detection(99)),
    "get_hourly_weather": lambda ds: ds.get_hourly_weather(D),
    "get_image_cache": lambda ds: (ds.get_image_cache("parus major"),
                                   ds.get_image_cache("nope")),
    "get_image_cache_batch": lambda ds: ds.get_image_cache_batch(
        ["parus major", "nope"]),
    "get_results": lambda ds: ds.get_results(2),
    "get_reviews": lambda ds: ds.get_reviews(3),
    "hourly_distribution": lambda ds: (ds.hourly_distribution(),
                                       ds.hourly_distribution(
                                           D, "Parus major")),
    "insert_detection": lambda ds: ds.insert_detection(
        _detection(T if "torch" in type(ds).__module__ else J, 20),
        clip_name="new.flac"),
    "insights_dashboard_kpis": lambda ds: ds.insights_dashboard_kpis(D),
    "insights_dawn_chorus_raw": lambda ds: ds.insights_dawn_chorus_raw(
        NOW - 7 * 86400, 0, 24),
    "insights_expected_species": lambda ds: ds.insights_expected_species(
        [(D_FROM, D)]),
    "insights_gone_quiet": lambda ds: ds.insights_gone_quiet(D, 1),
    "insights_new_arrivals": lambda ds: ds.insights_new_arrivals(D_FROM),
    "insights_phantom_species": lambda ds: ds.insights_phantom_species(
        NOW - 7 * 86400, 1, 0.7),
    "integrity_check": lambda ds: ds.integrity_check(),
    "latest_hourly_weather": lambda ds: ds.latest_hourly_weather(),
    "list_comments": lambda ds: ds.list_comments(1),
    "list_threshold_events": lambda ds: (
        ds.list_threshold_events(), ds.list_threshold_events(
            5, "Parus major")),
    "load_dynamic_thresholds": lambda ds: ds.load_dynamic_thresholds(),
    "load_notifications": lambda ds: ds.load_notifications(2),
    "lock_detection": lambda ds: (ds.lock_detection(2), ds.lock_detection(
        4, False), ds.lock_detection(99)),
    "locked_clip_names": lambda ds: ds.locked_clip_names(),
    "new_species_first_seen": lambda ds: ds.new_species_first_seen(),
    "optimize": lambda ds: ds.optimize(),
    "phenology": lambda ds: ds.phenology("Parus major", DAY0.year),
    "recent_detections": lambda ds: ds.recent_detections(4),
    "review_detection": lambda ds: ds.review_detection(6, "correct", "ok"),
    "save_daily_events": lambda ds: ds.save_daily_events(D),
    "save_dynamic_thresholds": lambda ds: ds.save_dynamic_thresholds({}),
    "save_hourly_weather": lambda ds: ds.save_hourly_weather(
        NOW - 7200.0, temperature=-1.5, description="snow", icon="13"),
    "save_image_cache": lambda ds: ds.save_image_cache(
        "parus major", url="http://img/2.jpg", thumbnail_url="t",
        author="a", license="l", provider="p", cached_at=6.0),
    "save_notification": lambda ds: ds.save_notification(
        "t", "m", "low", NOW, "{}"),
    "save_threshold_event": lambda ds: ds.save_threshold_event(
        (T if "torch" in type(ds).__module__ else J).dynamic.ThresholdEvent(
            "Perch_V2", "Strix aluco", 1, 0, 0.7, 0.8, "expiry", 0.0, NOW)),
    "search_detections": lambda ds: (
        ds.search_detections(), ds.search_detections(
            species="tit", min_confidence=0.55, limit=3, with_total=True),
        ds.search_detections(verified="unreviewed", order="asc"),
        ds.search_detections(verified="correct", locked=False,
                             hour_from=20, hour_to=6),
        ds.search_detections(species_scientific=["Strix aluco"],
                             sort_by="confidence", date_from=D_FROM)),
    "set_clip_name": lambda ds: (ds.set_clip_name(2, "x.flac"),
                                 ds.set_clip_name(99, "y")),
    "set_notification_read": lambda ds: (ds.set_notification_read(1),
                                         ds.set_notification_read()),
    "species_accumulation": lambda ds: ds.species_accumulation(D_FROM, D),
    "species_daily_trend": lambda ds: ds.species_daily_trend(D_FROM, D, 2),
    "species_first_seen_since": lambda ds: ds.species_first_seen_since(
        D_FROM),
    "species_summary": lambda ds: (ds.species_summary(),
                                   ds.species_summary(D_FROM, D)),
    "succession": lambda ds: ds.succession(D_FROM, D, 3),
    "time_of_day_species": lambda ds: ds.time_of_day_species(D_FROM, D),
    "update_comment": lambda ds: (ds.update_comment(1, "edited"),
                                  ds.update_comment(9, "no")),
    "wal_checkpoint": lambda ds: ds.wal_checkpoint(),
    "year_over_year": lambda ds: ds.year_over_year("Parus major"),
}
# methods whose answer names the engine: compared across the packages
# only (the path names each server's port), not with SQLite's
ENGINE_METHODS = {"database_details", "doctor", "integrity_check",
                  "optimize", "wal_checkpoint"}


def test_every_public_method_is_covered():
    public = {n for n in dir(T.sqlite.Datastore)
              if not n.startswith("_") and callable(
                  getattr(T.sqlite.Datastore, n))} - {"close"}
    assert public == set(METHODS)


def _plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, _plain(dataclasses.asdict(x)))
    if isinstance(x, dict):
        return sorted((repr(k), _plain(v)) for k, v in x.items()
                      if k != "path")
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _tables(server: MySQLServer) -> dict:
    with server._lock:
        names = [r[0] for r in server.db.execute(
            "SELECT name FROM sqlite_master WHERE type='table'"
            " AND name NOT LIKE 'sqlite_%' ORDER BY name")]
        return {n: [tuple(r) for r in server.db.execute(
            f'SELECT * FROM "{n}" ORDER BY 1, 2')] for n in names}


def _run_mysql(P, method: str):
    """`method` on P's MySQLDatastore over a port server of its own, after
    the seed, with the wall clock held at NOW: (its result or its
    exception's type, the tables after, the statements the server
    received)."""
    s = MySQLServer(password=PASSWORD, plugin="caching_sha2_password",
                    sha2_full_auth=True)
    s.start()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: NOW)
        return _on_server(P, method, s)


def _on_server(P, method: str, s: MySQLServer):
    try:
        ds = P.mysql.MySQLDatastore(port=s.port, user="bird",
                                    password=PASSWORD, database="")
        _seed(P, ds)
        try:
            out = _plain(METHODS[method](ds))
        except Exception as e:  # noqa: BLE001 — JAX's may fail on MySQL
            out = ("raised", type(e).__name__)
        tables = _tables(s)
        ds.close()
        return out, tables, list(s.queries)
    finally:
        s.stop()


@pytest.mark.parametrize("method", sorted(METHODS))
def test_datastore_method_on_mysql_as_jax(method):
    """`method` through both packages' MySQLDatastore on the same seeded
    rows: the same answer and the same tables after it; the port's answer
    and tables equal its SQLite Datastore's (the methods that name their
    engine aside); every statement the port sent is MySQL's dialect.
    JAX's ``wal_checkpoint`` fails on MySQL (it reads SQLite's PRAGMA);
    the port's ``delete_detection`` recomputes the day's rollup, which
    JAX's leaves stale (``test_torch_detection.py`` holds that on
    SQLite)."""
    jax_out, jax_tables, _ = _run_mysql(J, method)
    out, tables, sent = _run_mysql(T, method)
    if method == "wal_checkpoint":
        assert jax_out == ("raised", "TypeError")
        assert out == _plain({"busy": 0, "log_frames": 0,
                              "checkpointed_frames": 0})
    else:
        assert out == jax_out
    if method == "delete_detection":
        jax_tables.pop("daily_events")
        rollup = tables.pop("daily_events")
        day = _detection(T, 0).timestamp.date().isoformat()
        n = sum(1 for r in tables["detections"] if r[2] == day)
        assert [r[1] for r in rollup if r[0] == day] == [n]
    assert tables == jax_tables
    bad = {sql: _mysql_lint(sql) for sql in sent if _mysql_lint(sql)}
    assert not bad, bad
    if method in ENGINE_METHODS:
        return
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(time, "time", lambda: NOW)
        lite = T.sqlite.Datastore(":memory:")
        _seed(T, lite)
        assert _plain(METHODS[method](lite)) == out
        lite.close()


def test_jax_sends_what_mysql_refuses():
    """Why the port's translation differs: the statements JAX's
    MySQLDatastore sends for an insert and the schema hold the constructs
    the port repairs (SQLite takes them, so JAX's tests pass)."""
    _, _, sent = _run_mysql(J, "insert_detection")
    found = {name for sql in sent for name in _mysql_lint(sql)}
    assert found == {"a scalar two-argument MIN/MAX",
                     "a derived table without an alias",
                     "CREATE INDEX IF NOT EXISTS"}
