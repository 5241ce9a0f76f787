"""Scene 17 with the dragon loaded as a scan, as ``cornell_dragon_scan``,
for the fit at the sizes of ``cornell_dragon_scan_fit.json``."""
from __future__ import annotations

from .cornell_dragon_scan import build, make_inputs  # noqa: F401
