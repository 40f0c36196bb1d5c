"""Unit conversions shared across feature extraction and post-processing
(a copy of ``sykepic_tpu/compute/units.py``).

The reference keeps two copies of ``pixels_to_um3`` with different default
micron factors: 2.8 for the Python feature backend
(``sykepic/compute/feature_python.py:121-123``) and 3.5 for the MATLAB
backend and size-group binning (``sykepic/compute/feature_matlab.py:156-157``,
``sykepic/compute/size_group.py:7,135-136``).
"""

from __future__ import annotations

PY_MICRON_FACTOR = 2.8
MATLAB_MICRON_FACTOR = 3.5


def pixels_to_um3(pixels, micron_factor: float = MATLAB_MICRON_FACTOR):
    """Convert a biovolume in pixel units to cubic micrometres."""
    return pixels / (micron_factor**3)


def biovolume_to_biomass(biovol_um3, volume_ml):
    """µm³ of biovolume in a sample of ``volume_ml`` -> µg/L of biomass
    (reference ``feature_python.py:125-129``)."""
    try:
        return biovol_um3 / volume_ml / 1000
    except ZeroDivisionError:
        return 0
