"""Seeded inputs for the importers (``utils/imports.py``): a BirdNET-Pi
detection log and a legacy BirdNET-Go database, made from numpy's
generator and a seed, so that a test and ``chip_smoke.py`` phase 21 feed
the same data to the JAX package's importers and the port's.

    write_birdnet_pi_log(path, rows, seed)   # BirdDB.txt
    write_birdnet_go_db(path, notes, seed)   # the reference's GORM schema

Every generated row has its own (timestamp, species), the importers' dedup
key, so a first import takes every row and a second skips every row.
"""

from __future__ import annotations

import datetime as _dt
import sqlite3
from pathlib import Path

import numpy as np

# (scientific, common, eBird code): a northern European station's list
SPECIES = (
    ("Turdus merula", "Eurasian Blackbird", "eurbla"),
    ("Erithacus rubecula", "European Robin", "eurrob1"),
    ("Parus major", "Great Tit", "gretit1"),
    ("Cyanistes caeruleus", "Eurasian Blue Tit", "eurbtit1"),
    ("Fringilla coelebs", "Common Chaffinch", "comcha"),
    ("Phylloscopus collybita", "Common Chiffchaff", "comchi1"),
    ("Phylloscopus trochilus", "Willow Warbler", "wlwwar"),
    ("Sylvia atricapilla", "Eurasian Blackcap", "blackc1"),
    ("Troglodytes troglodytes", "Eurasian Wren", "winwre4"),
    ("Turdus philomelos", "Song Thrush", "sonthr1"),
    ("Columba palumbus", "Common Wood-Pigeon", "cowpig1"),
    ("Corvus corone", "Carrion Crow", "carcro1"),
    ("Pica pica", "Eurasian Magpie", "eurmag1"),
    ("Sturnus vulgaris", "European Starling", "eursta"),
    ("Passer domesticus", "House Sparrow", "houspa"),
    ("Carduelis carduelis", "European Goldfinch", "eurgol"),
    ("Chloris chloris", "European Greenfinch", "eurgre1"),
    ("Emberiza citrinella", "Yellowhammer", "yellow2"),
    ("Dendrocopos major", "Great Spotted Woodpecker", "grswoo"),
    ("Strix aluco", "Tawny Owl", "tawowl1"),
    ("Cuculus canorus", "Common Cuckoo", "comcuc"),
    ("Hirundo rustica", "Barn Swallow", "barswa"),
    ("Apus apus", "Common Swift", "comswi"),
    ("Motacilla alba", "White Wagtail", "whiwag"),
    ("Aegithalos caudatus", "Long-tailed Tit", "lottit1"),
    ("Sitta europaea", "Eurasian Nuthatch", "eurnut2"),
    ("Certhia familiaris", "Eurasian Treecreeper", "eurtre1"),
    ("Regulus regulus", "Goldcrest", "goldcr1"),
    ("Garrulus glandarius", "Eurasian Jay", "eurjay1"),
    ("Buteo buteo", "Common Buzzard", "combuz1"),
)

COMMENTS = ("great song", "two birds calling", "heard at the feeder",
            "faint, far away", "check the spectrogram", "dawn chorus")
VERDICTS = ("correct", "false_positive")


def _unique_times(rng, n: int, start: _dt.datetime, days: int
                  ) -> list[_dt.datetime]:
    """n distinct seconds within `days` days from `start`, in order."""
    secs = np.sort(rng.choice(days * 86400, size=n, replace=False))
    return [start + _dt.timedelta(seconds=int(s)) for s in secs]


def write_birdnet_pi_log(path: str | Path, rows: int, seed: int = 0,
                         junk: int = 0, delimiter: str = ";",
                         header: bool = True) -> dict:
    """A BirdNET-Pi ``BirdDB.txt`` of `rows` detections over a week from
    2024-05-01 (BirdNET-Pi's eleven columns), and `junk` lines the parser
    skips (too few columns, a bad date, a bad confidence) among them.
    Returns {"rows", "junk", "species"}."""
    rng = np.random.default_rng(seed)
    times = _unique_times(rng, rows, _dt.datetime(2024, 5, 1), 7)
    kinds = rng.integers(0, len(SPECIES), rows)
    conf = np.round(rng.uniform(0.5, 0.99, rows), 4)
    lines = []
    if header:
        lines.append(delimiter.join(
            ("Date", "Time", "Sci_Name", "Com_Name", "Confidence", "Lat",
             "Lon", "Cutoff", "Week", "Sens", "Overlap")))
    for t, k, c in zip(times, kinds, conf):
        sci, com, _ = SPECIES[k]
        lines.append(delimiter.join((
            t.strftime("%Y-%m-%d"), t.strftime("%H:%M:%S"), sci, com,
            f"{c:.4f}", "60.1699", "24.9384", "0.7",
            str(t.isocalendar()[1]), "1.25", "0.0")))
    bad = ("2024-05-02;07:00:00;Turdus merula",
           "2024-13-40;07:00:00;Turdus merula;Eurasian Blackbird;0.9",
           "2024-05-02;07:00:00;Turdus merula;Eurasian Blackbird;high")
    for j in range(junk):
        at = 1 + int(rng.integers(0, len(lines)))
        lines.insert(at, bad[j % len(bad)].replace(";", delimiter))
    Path(path).write_text("\n".join(lines) + "\n")
    return {"rows": rows, "junk": junk,
            "species": len(set(int(k) for k in kinds))}


def write_birdnet_go_db(path: str | Path, notes: int, seed: int = 0
                        ) -> dict:
    """A legacy BirdNET-Go SQLite database (the reference's GORM schema:
    notes + results/note_reviews/note_comments/note_locks) of `notes`
    detections over 30 days from 2023-06-01, each with one to three
    secondary results, a review for about a third, one or two comments
    for about a fifth and a lock for about a tenth. Returns the counts:
    {"notes", "results", "reviews", "comments", "locks"}."""
    rng = np.random.default_rng(seed)
    times = _unique_times(rng, notes, _dt.datetime(2023, 6, 1), 30)
    conn = sqlite3.connect(path)
    try:
        conn.executescript("""
        CREATE TABLE notes (id INTEGER PRIMARY KEY, source_node TEXT,
          date TEXT, time TEXT, scientific_name TEXT, common_name TEXT,
          species_code TEXT, confidence REAL, latitude REAL, longitude REAL,
          threshold REAL, sensitivity REAL, clip_name TEXT);
        CREATE TABLE results (id INTEGER PRIMARY KEY, note_id INTEGER,
          species TEXT, confidence REAL);
        CREATE TABLE note_reviews (id INTEGER PRIMARY KEY, note_id INTEGER,
          verified TEXT, created_at TEXT, updated_at TEXT);
        CREATE TABLE note_comments (id INTEGER PRIMARY KEY, note_id INTEGER,
          entry TEXT, created_at TEXT, updated_at TEXT);
        CREATE TABLE note_locks (id INTEGER PRIMARY KEY, note_id INTEGER,
          locked_at TEXT);
        """)
        counts = {"notes": notes, "results": 0, "reviews": 0,
                  "comments": 0, "locks": 0}
        for i, t in enumerate(times, start=1):
            k = int(rng.integers(0, len(SPECIES)))
            sci, com, code = SPECIES[k]
            conf = round(float(rng.uniform(0.6, 0.99)), 4)
            stamp = t.strftime("%Y-%m-%d %H:%M:%S")
            conn.execute(
                "INSERT INTO notes VALUES (?,'',?,?,?,?,?,?,60.1699,24.9384,"
                "0.8,1.0,?)",
                (i, t.strftime("%Y-%m-%d"), t.strftime("%H:%M:%S"), sci,
                 com, code, conf, f"clip_{i}.wav"))
            others = rng.choice(len(SPECIES), size=int(rng.integers(0, 3)),
                                replace=False)
            second = [(sci, com, conf)] + [
                (SPECIES[o][0], SPECIES[o][1],
                 round(float(rng.uniform(0.05, 0.5)), 4))
                for o in others if o != k]
            for s, c, v in second:
                conn.execute("INSERT INTO results (note_id, species, "
                             "confidence) VALUES (?,?,?)",
                             (i, f"{s}_{c}", v))
            counts["results"] += len(second)
            if rng.uniform() < 1 / 3:
                conn.execute("INSERT INTO note_reviews (note_id, verified, "
                             "created_at, updated_at) VALUES (?,?,?,?)",
                             (i, VERDICTS[int(rng.integers(0, 2))], stamp,
                              stamp))
                counts["reviews"] += 1
            if rng.uniform() < 0.2:
                for j in range(int(rng.integers(1, 3))):
                    at = (t + _dt.timedelta(minutes=j + 1)).strftime(
                        "%Y-%m-%d %H:%M:%S")
                    conn.execute("INSERT INTO note_comments (note_id, entry, "
                                 "created_at, updated_at) VALUES (?,?,?,?)",
                                 (i, COMMENTS[int(rng.integers(
                                     0, len(COMMENTS)))], at, at))
                    counts["comments"] += 1
            if rng.uniform() < 0.1:
                conn.execute("INSERT INTO note_locks (note_id, locked_at) "
                             "VALUES (?,?)", (i, stamp))
                counts["locks"] += 1
        conn.commit()
    finally:
        conn.close()
    return counts
