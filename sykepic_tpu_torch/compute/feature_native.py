"""The ``.feat.csv`` contract, trimmed to what the fused pass writes (the
port of ``sykepic_tpu/compute/feature_native.py:26-36``): the file suffix,
the 7-column schema and the python-backend pixel -> um^3 conversion. The
host feature extractor and the ``feat`` sub-command are ROADMAP Queue 1
item 12.
"""

from __future__ import annotations

from .units import PY_MICRON_FACTOR

FILE_SUFFIX = ".feat"
CSV_COLUMNS = (
    "roi,biovolume_px,biovolume_um3,biomass_ugl,"
    "area,major_axis_length,minor_axis_length"
)


def pixels_to_um3(pixels, micron_factor: float = PY_MICRON_FACTOR):
    """Pixel volume -> um^3 (python-backend micron factor 2.8)."""
    return pixels / (micron_factor**3)
