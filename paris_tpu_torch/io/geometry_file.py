"""Geometry config file parsing (ini-style key=value).

Same schema as the reference geometry file
(src/program_options.cpp:83-91): required keys

    n_row n_col l_px_row l_px_col delta_s delta_t d_so d_od delta_phi

Lines starting with '#' or ';' are comments; 'key = value' with optional
whitespace.  (Note: the reference's own doc/schaum.geo uses OBSOLETE key
names that its parser rejects — SURVEY.md §5 quirk 6; we implement the
parser's schema, not the stale example's.)
"""

from __future__ import annotations

from typing import Dict

from ..geometry import DetectorGeometry

__all__ = ["parse_geometry_text", "load_geometry_file", "GEOMETRY_KEYS",
           "geometry_format_help", "dump_geometry_file"]

GEOMETRY_KEYS = {
    "n_row": int,
    "n_col": int,
    "l_px_row": float,
    "l_px_col": float,
    "delta_s": float,
    "delta_t": float,
    "d_so": float,
    "d_od": float,
    "delta_phi": float,
}

_KEY_HELP = {
    "n_row": "[integer] number of pixels per detector row (= projection width)",
    "n_col": "[integer] number of pixels per detector column (= projection height)",
    "l_px_row": "[float] horizontal pixel size (= distance between pixel centers) in mm",
    "l_px_col": "[float] vertical pixel size (= distance between pixel centers) in mm",
    "delta_s": "[float] horizontal detector offset in pixels",
    "delta_t": "[float] vertical detector offset in pixels",
    "d_so": "[float] distance between object (= center of rotation) and source in mm",
    "d_od": "[float] distance between object (= center of rotation) and detector in mm",
    "delta_phi": "[float] angle step between two successive projections in °",
}


def geometry_format_help() -> str:
    lines = ["Geometry file:"]
    for k in GEOMETRY_KEYS:
        lines.append(f"  {k:<12} {_KEY_HELP[k]}")
    return "\n".join(lines)


def parse_geometry_text(text: str, origin: str = "<geometry>") -> DetectorGeometry:
    values: Dict[str, object] = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.split("#", 1)[0].split(";", 1)[0].strip()
        if not line:
            continue
        if "=" not in line:
            raise ValueError(f"{origin}:{lineno}: expected 'key = value', got {raw!r}")
        key, _, val = line.partition("=")
        key, val = key.strip(), val.strip()
        if key not in GEOMETRY_KEYS:
            raise ValueError(f"{origin}:{lineno}: unknown geometry key {key!r}")
        try:
            values[key] = GEOMETRY_KEYS[key](val)
        except ValueError as e:
            raise ValueError(f"{origin}:{lineno}: bad value for {key}: {val!r}") from e
    missing = [k for k in GEOMETRY_KEYS if k not in values]
    if missing:
        raise ValueError(f"{origin}: missing required geometry keys: {missing}")
    return DetectorGeometry(**values)  # type: ignore[arg-type]


def load_geometry_file(path: str) -> DetectorGeometry:
    with open(path, "r", encoding="utf-8") as f:
        return parse_geometry_text(f.read(), origin=path)


def dump_geometry_file(det: DetectorGeometry, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        for k in GEOMETRY_KEYS:
            f.write(f"{k} = {getattr(det, k)}\n")
