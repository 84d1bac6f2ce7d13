"""Downloadable-model catalog + installer, the "models gallery" (a copy of
``birdnet_go_tpu/models/catalog.py``, which the port may not import).

Reference: internal/classifier/model_catalog.go (CatalogEntry with pinned
SHA-256 HuggingFace artifacts + per-device benchmarks) and
model_manager.go (install/scan/heal into the models dir).

Installed layout: <model_home>/<model_id>/model.(tflite|onnx) — the
loader (inference.loader) resolves these through the importers. Downloads
verify SHA-256 before the atomic rename; no pin → refuse (supply-chain
hygiene, same as the reference). Without an injected session a download
streams through the port's transport (``utils/httpclient.py``
``UrllibSession``: the card's machine has no ``httpx``), following
redirects, with a 120 s timeout, as the JAX package's httpx client.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import shutil
from pathlib import Path

from birdnet_go_tpu_torch.inference.loader import model_home
from birdnet_go_tpu_torch.taxonomy.labels import resolve_data_dir
from birdnet_go_tpu_torch.utils.httpclient import UrllibSession

log = logging.getLogger("birdnet_tpu.catalog")


@dataclasses.dataclass(frozen=True)
class CatalogEntry:
    model_id: str
    display_name: str
    description: str
    url: str                      # artifact URL (HF resolve link)
    sha256: str                   # pinned digest ("" = catalog stub)
    file_name: str                # installed artifact name
    size_mb: float = 0.0
    license: str = ""


# Catalog stubs: ids/names mirror the reference's registry; artifact URLs
# and pins are populated per deployment (the reference pins HuggingFace
# repos the same way — model weights are not distributed with the code).
CATALOG: list[CatalogEntry] = [
    CatalogEntry(
        model_id="BirdNET_V2.4", display_name="BirdNET v2.4 (FP32)",
        description="Global 6K species classifier, 48 kHz / 3 s",
        url="", sha256="", file_name="model.tflite", size_mb=50.0,
        license="CC BY-NC-SA 4.0"),
    CatalogEntry(
        model_id="BirdNET_V3.0", display_name="BirdNET v3.0",
        description="Next-gen classifier, 32 kHz / 5 s",
        url="", sha256="", file_name="model.onnx", size_mb=120.0,
        license="CC BY-NC-SA 4.0"),
    CatalogEntry(
        model_id="Perch_V2", display_name="Google Perch v2",
        description="14,795-species classifier, 32 kHz / 5 s",
        url="", sha256="", file_name="model.onnx", size_mb=180.0,
        license="Apache-2.0"),
    CatalogEntry(
        model_id="BattyBirdNET", display_name="BattyBirdNET bat classifier",
        description="Two-stage bat classifier for 256 kHz ultrasonic audio",
        url="", sha256="", file_name="model.onnx", size_mb=60.0,
        license="CC BY-NC-SA 4.0"),
    CatalogEntry(
        model_id="BSG", display_name="BSG Finland v4.4",
        description="Regional classifier for Finnish bird species,"
                    " 48 kHz / 3 s (University of Jyväskylä)",
        url="https://huggingface.co/tphakala/BSG/resolve/main/"
            "BSG_birds_Finland_v4_4_fused_fp32.onnx",
        sha256="dd2b6b21c6b3d8adc5d72954f9e33c48"
               "b3d692dbbc647758340a69d68b203300",
        file_name="model.onnx", size_mb=45.4, license="Non-commercial"),
    CatalogEntry(
        model_id="Geomodel_V3.0", display_name="BirdNET Geomodel v3.0",
        description="Geographic range filter (lat/lon/week occurrence)",
        url="", sha256="", file_name="model.onnx", size_mb=15.0,
        license="CC BY-NC-SA 4.0"),
]


def catalog_entries() -> list[CatalogEntry]:
    return list(CATALOG)


def get_entry(model_id: str) -> CatalogEntry | None:
    for e in CATALOG:
        if e.model_id == model_id:
            return e
    return None


class ModelManager:
    """Install/scan/remove model artifacts under the model home."""

    def __init__(self, home: Path | None = None, session=None):
        self.home = home or model_home()
        self._session = session

    # -- inventory ---------------------------------------------------------------

    def installed(self) -> list[dict]:
        out = []
        if not self.home.is_dir():
            return out
        for d in sorted(self.home.iterdir()):
            if not d.is_dir():
                continue
            artifacts = [p.name for p in d.iterdir() if p.is_file()]
            out.append({
                "model_id": d.name,
                "artifacts": artifacts,
                "bytes": sum((d / a).stat().st_size for a in artifacts),
            })
        return out

    def is_installed(self, model_id: str) -> bool:
        d = self.home / model_id
        return d.is_dir() and any(d.iterdir())

    def remove(self, model_id: str) -> bool:
        d = self.home / model_id
        if not d.is_dir():
            return False
        shutil.rmtree(d)
        return True

    # -- install -------------------------------------------------------------------

    def _stage_labels(self, model_id: str, dest_dir: Path) -> int:
        """Copy the vendored label tables for this model next to the
        weights (the reference keeps labels+weights together —
        models_embedded.go:14-22), so a deployment that installs a model
        artifact gets its species names even when no shared data dir is
        configured. Returns the number of locale files staged."""
        base = resolve_data_dir()
        if base is None:
            return 0
        src = base / "labels" / ("V2.4" if model_id == "BirdNET_V2.4"
                                 else model_id)
        if not src.is_dir():
            return 0
        out = dest_dir / "labels"
        out.mkdir(exist_ok=True)
        n = 0
        for f in sorted(src.glob("*.txt")):
            (out / f.name).write_bytes(f.read_bytes())
            n += 1
        if n:
            log.info("staged %d label file(s) beside %s", n, model_id)
        return n

    def install_from_file(self, model_id: str, artifact: str | Path,
                          file_name: str | None = None) -> Path:
        """Install a local .tflite/.onnx artifact (import staging path)."""
        src = Path(artifact)
        if not src.is_file():
            raise FileNotFoundError(src)
        name = file_name or ("model" + src.suffix)
        dest_dir = self.home / model_id
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / name
        tmp = dest.with_suffix(dest.suffix + ".tmp")
        tmp.write_bytes(src.read_bytes())
        tmp.rename(dest)
        self._stage_labels(model_id, dest_dir)
        log.info("installed %s from %s", model_id, src)
        return dest

    def install_from_url(self, entry: CatalogEntry,
                         progress=None) -> Path:
        """Download + verify + install a catalog artifact."""
        if not entry.url:
            raise ValueError(
                f"catalog entry {entry.model_id} has no artifact URL "
                f"configured for this deployment")
        if not entry.sha256:
            raise ValueError(
                f"refusing unpinned download for {entry.model_id}")
        session = self._session or UrllibSession(timeout=120.0)
        digest = hashlib.sha256()
        chunks = []
        with session.stream("GET", entry.url) as r:
            r.raise_for_status()
            total = int(r.headers.get("Content-Length", 0))
            got = 0
            for chunk in r.iter_bytes(1 << 20):
                digest.update(chunk)
                chunks.append(chunk)
                got += len(chunk)
                if progress:
                    progress(got, total)
        if digest.hexdigest() != entry.sha256:
            raise ValueError(
                f"sha256 mismatch for {entry.model_id}: "
                f"got {digest.hexdigest()}, pinned {entry.sha256}")
        dest_dir = self.home / entry.model_id
        dest_dir.mkdir(parents=True, exist_ok=True)
        dest = dest_dir / entry.file_name
        tmp = dest.with_suffix(dest.suffix + ".tmp")
        tmp.write_bytes(b"".join(chunks))
        tmp.rename(dest)
        self._stage_labels(entry.model_id, dest_dir)
        log.info("installed %s (%d bytes, sha256 verified)",
                 entry.model_id, dest.stat().st_size)
        return dest
