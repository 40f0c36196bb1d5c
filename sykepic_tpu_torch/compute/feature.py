"""Feature-extraction dispatcher (the port of
``sykepic_tpu/compute/feature.py``; reference ``sykepic/compute/feature.py``):
``--matlab BIN`` routes to the external MATLAB ifcb-analysis batch, otherwise
the native backend runs (which, unlike the reference's external
``ifcb_features`` dependency, is always available)."""

from __future__ import annotations


def call(args):
    if args.matlab:
        from . import feature_matlab

        return feature_matlab.call(args)
    from . import feature_native

    return feature_native.call(args)
