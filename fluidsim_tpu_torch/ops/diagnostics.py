"""Grid validation — the counterpart of ``fluidsim_tpu/ops/diagnostics.py``
(``openvdb/tools/Diagnostics.h``: ``checkLevelSet``, ``checkFogVolume``,
``CheckNan``/``CheckInf``/``CheckRange``): each check is one reduction
over the grid, with an optional bool mask of the offending voxels, and a
report string (empty = all good, as ``tools::Diagnose``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fluidsim_tpu_torch.ops.gridops import gradient, magnitude

__all__ = ["CheckReport", "check_finite_grid", "check_range",
           "check_levelset", "check_fog_volume", "diagnose"]


class CheckReport(NamedTuple):
    """One predicate's outcome: failure count and (optional) voxel mask."""
    name: str
    failed: int
    mask: object  # (N,N,N) bool tensor | None

    @property
    def ok(self) -> bool:
        return self.failed == 0

    def __str__(self) -> str:  # report-string surface like the reference
        return (f"{self.name}: ok" if self.ok
                else f"{self.name}: {self.failed} voxels failed")


def _report(name, bad, want_mask):
    return CheckReport(name, int(torch.sum(bad)), bad if want_mask else None)


def check_finite_grid(grid, mask: bool = False) -> CheckReport:
    """``CheckNan`` + ``CheckInf``: every value finite."""
    bad = ~torch.isfinite(grid)
    if bad.dim() == 4:
        bad = torch.any(bad, dim=-1)
    return _report("finite", bad, mask)


def check_range(grid, lo: float, hi: float, mask: bool = False) -> CheckReport:
    """``CheckRange``: values within [lo, hi]."""
    bad = ~torch.isfinite(grid) | (grid < lo) | (grid > hi)
    return _report(f"range[{lo},{hi}]", bad, mask)


def check_levelset(phi, half_width: float = 3.0, grad_tol: float = 0.5,
                   dx: float = 1.0, mask: bool = False):
    """``tools::checkLevelSet``: finite values, |φ| ≤ band everywhere
    (truncated narrow-band convention), and |∇φ| within ``grad_tol`` of 1
    inside the band.  Returns a list of CheckReports."""
    w = half_width * dx
    reports = [check_finite_grid(phi, mask)]
    over = torch.abs(phi) > w * (1.0 + 1e-4)
    reports.append(_report("band", over, mask))
    g = magnitude(gradient(phi, dx))
    band = torch.abs(phi) < 0.9 * w
    # skip a 1-voxel rind: central differences there read out-of-box zeros
    interior = torch.zeros(phi.shape, dtype=torch.bool, device=phi.device)
    interior[1:-1, 1:-1, 1:-1] = True
    badg = band & interior & (torch.abs(g - 1.0) > grad_tol)
    reports.append(_report("unit-gradient", badg, mask))
    return reports


def check_fog_volume(fog, mask: bool = False):
    """``tools::checkFogVolume``: finite and within [0, 1]."""
    return [check_finite_grid(fog, mask), check_range(fog, 0.0, 1.0, mask)]


def diagnose(reports) -> str:
    """Join CheckReports into the reference-style report string (empty
    string = all good, same contract as ``tools::Diagnose``)."""
    return "\n".join(str(r) for r in reports if not r.ok)
