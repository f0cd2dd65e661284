"""The comparison that decides ``correct``: the program's voxels against
the plain reference's, each number beside its limit."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def rel_rmse(got: torch.Tensor, ref: torch.Tensor) -> float:
    """RMSE over max|ref|, the repository's relative RMSE (float64);
    inf where ``got`` holds a value that is not finite."""
    got = got.to(torch.float64)
    ref = ref.to(torch.float64)
    if not bool(torch.isfinite(got).all()):
        return float("inf")
    peak = float(ref.abs().max())
    return float(torch.sqrt(torch.mean((got - ref) ** 2))) / max(peak, 1e-300)


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number within its limit, {name: {value, limit}}); a number
    without a limit, or a limit without a number, fails."""
    out, ok = {}, set(numbers) == set(limits)
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, float("nan"))
        limit = limits.get(name, float("nan"))
        out[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, out
