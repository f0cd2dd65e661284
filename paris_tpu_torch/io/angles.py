"""Projection angle files.

Whitespace-separated float angles in degrees.  Like the reference
(src/source.cpp:43-72) we auto-detect German comma-decimal files: if the
content contains ',' but no '.', commas are treated as decimal points
(the reference switched to the de_DE locale for the same effect).
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_angles", "angles_for"]


def read_angles(path: str) -> np.ndarray:
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    if "," in text and "." not in text:
        text = text.replace(",", ".")
    vals = [float(tok) for tok in text.split()]
    return np.asarray(vals, dtype=np.float32)


def angles_for(indices, delta_phi: float, angle_table=None) -> np.ndarray:
    """Angle per global projection index: table lookup or idx*delta_phi.

    (reference: backprojection.cpp:53-57)
    """
    idx = np.asarray(indices)
    if angle_table is not None and len(angle_table) > 0:
        return np.asarray(angle_table, dtype=np.float32)[idx]
    return (idx.astype(np.float32) * np.float32(delta_phi))
