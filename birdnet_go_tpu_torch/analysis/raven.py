"""Raven selection-table output for offline file analysis (a copy of
``birdnet_go_tpu/analysis/raven.py``; the port's tests hold its text equal
to the original's).

Behavior spec: doc/wiki/file-analysis.md:18-44 — tab-separated table, one
row per detected window (top result above threshold), Selection = window
index + 1 (gaps where nothing was detected), Low/High Freq constants
0/15000 Hz, species code + common name + confidence (4 decimals).
"""

from __future__ import annotations

import io
from pathlib import Path

from birdnet_go_tpu_torch.analysis.results import Detection

_HEADER = ("Selection\tView\tChannel\tBegin File\tBegin Time (s)\t"
           "End Time (s)\tLow Freq (Hz)\tHigh Freq (Hz)\tSpecies Code\t"
           "Common Name\tConfidence")
_LOW_FREQ = 0
_HIGH_FREQ = 15000


def format_raven_table(detections: list[Detection], begin_file: str) -> str:
    out = io.StringIO()
    out.write(_HEADER + "\n")
    for d in detections:
        out.write(
            f"{d.window_index + 1}\tSpectrogram 1\t1\t{begin_file}\t"
            f"{_fmt_t(d.begin_seconds)}\t{_fmt_t(d.end_seconds)}\t"
            f"{_LOW_FREQ}\t{_HIGH_FREQ}\t{d.species_code}\t"
            f"{d.species.common}\t{d.confidence:.4f}\n")
    return out.getvalue()


def write_raven_table(detections: list[Detection], input_path: str | Path,
                      output_dir: str | Path = "output") -> Path:
    """Write output/<inputname>.txt (reference writes <input>.wav.txt)."""
    input_path = Path(input_path)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / (input_path.name + ".txt")
    out_path.write_text(format_raven_table(detections, input_path.name),
                        encoding="utf-8")
    return out_path


def _fmt_t(seconds: float) -> str:
    """Times like '0.0', '3.0', '10.5' (trailing .0 kept, minimal digits)."""
    s = f"{seconds:.1f}"
    return s


def format_csv(detections: list[Detection]) -> str:
    """BirdNET-Analyzer-style CSV output (`--rtype csv` analogue)."""
    out = io.StringIO()
    out.write("Start (s),End (s),Scientific name,Common name,Confidence\n")
    for d in detections:
        common = d.species.common.replace('"', '""')
        sci = d.species.scientific.replace('"', '""')
        out.write(f'{_fmt_t(d.begin_seconds)},{_fmt_t(d.end_seconds)},'
                  f'"{sci}","{common}",{d.confidence:.4f}\n')
    return out.getvalue()


def write_csv(detections: list[Detection], input_path: str | Path,
              output_dir: str | Path = "output") -> Path:
    input_path = Path(input_path)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / (input_path.stem + ".csv")
    out_path.write_text(format_csv(detections), encoding="utf-8")
    return out_path
