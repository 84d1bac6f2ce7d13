"""The SPA (``birdnet_go_tpu_torch/api/static/``, byte for byte the JAX
package's) against the port's own API server, on the CPU.

``tests/test_spa_runtime.py``'s gate, run on the port: the whole ES-module
SPA executes in the JAX package's jsrt interpreter (``BrowserSession``,
a DOM shim; a test may import the JAX package, the port may not) and its
``fetch()`` performs real HTTP against the port's ``ApiServer`` on
``api/web.py``, served by a started ``Application`` on the CPU with a
tiny v2.4 (``tests/test_torch_app.py``'s) and one detection of an hour
ago. Each view of ``VIEWS`` renders with no uncaught error, no
``console.error``, no unhandled rejection, no error signature in its
text and no fetch of an API route that answers 404. The subsystems the
port refuses (backup, MQTT, BirdWeather, weather) stay off, as their
settings must; none of the views needs them to render.
"""

from __future__ import annotations

import socket
import time

import pytest

from tests import test_torch_app as A
from tests.test_spa_runtime import ERROR_SIGNATURES, VIEWS
from tests.test_torch_app import tiny_v24  # noqa: F401  (fixture)

T = A.T


@pytest.fixture()
def spa(tiny_v24, tmp_path, monkeypatch):  # noqa: F811
    """The port's app with its API started and a booted jsrt session."""
    from birdnet_go_tpu.jsrt.runner import BrowserSession
    from birdnet_go_tpu_torch.analysis.results import Detection
    from birdnet_go_tpu_torch.taxonomy.labels import Species

    A._patch_models(T, monkeypatch, tiny_v24)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    st = T.settings.Settings()
    st.models = [T.settings.ModelSettings(model_id="BirdNET_V2.4",
                                          threshold=0.0)]
    st.database.path = str(tmp_path / "test.db")
    st.export.path = str(tmp_path / "clips")
    st.export.clip_length_seconds = 4.0
    st.export.pre_capture_seconds = 1.0
    st.data_dir = str(tmp_path)
    st.webserver.host, st.webserver.port = "127.0.0.1", port
    st.webserver.token_file = str(tmp_path / "tokens.json")
    # no image lookup leaves the machine
    st.imageprovider.providers = ["avicommons"]
    st.realtime.tick_ms = 20
    st.realtime.max_batch = 8
    app = T.app.Application(st, device="cpu")
    app.setup()
    ts = time.time() - 3600
    import datetime

    app.datastore.insert_detection(Detection(
        species=Species("Turdus merula", "Eurasian Blackbird"),
        confidence=0.9, begin_seconds=ts, end_seconds=ts + 12,
        model_id="BirdNET_V2.4", source_id="s1",
        timestamp=datetime.datetime.fromtimestamp(ts),
        species_code="eurbla"))
    app.start(warmup=False)
    session = BrowserSession(f"http://127.0.0.1:{app.api.port}")
    session.boot()
    yield app, session
    app.stop()


def _assert_clean(session, context: str) -> None:
    assert not session.errors, f"{context}: " + "\n".join(session.errors)
    txt = session.text().lower()
    hits = [sig for sig in ERROR_SIGNATURES if sig in txt]
    assert not hits, (f"{context}: error signature {hits} rendered "
                      f"into the view:\n{session.text()[:800]}")


def _misses(session) -> list:
    return [(m, u, st) for (m, u, st) in session.fetch_log
            if st in (404, -1) and u.startswith("/api/")]


def test_boot_renders_shell_and_dashboard(spa):
    _, session = spa
    _assert_clean(session, "boot")
    assert "Dashboard" in session.doc.root.text_content()
    assert len(session.text()) > 50
    assert "/api/v2/auth/status" in [u for (_, u, _s) in session.fetch_log]
    assert not _misses(session)


@pytest.mark.parametrize("view", VIEWS)
def test_view_renders_against_the_port(view, spa):
    """One view of ``VIEWS``: rendered, clean, and every API fetch
    answered by a registered route."""
    _, session = spa
    session.navigate(view)
    _assert_clean(session, f"view {view}")
    assert len(session.text()) > 20, f"view {view} rendered nothing"
    assert not _misses(session), f"view {view}: {_misses(session)}"


def test_detail_and_species_routes_render_seeded_data(spa):
    _, session = spa
    session.navigate("detection/1")
    _assert_clean(session, "detection detail")
    assert "Turdus merula" in session.text()
    session.navigate("species/Turdus%20merula")
    _assert_clean(session, "species detail")
    assert "Turdus" in session.text()
    assert not _misses(session)
