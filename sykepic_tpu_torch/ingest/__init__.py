from .ifcb import (  # noqa: F401
    SampleRois,
    extract_sample_images,
    filter_out_quality_flagged_samples,
    iter_rois,
    parse_adc,
    raw_to_numpy,
    raw_to_png,
    read_sample,
    sample_to_datetime,
    sample_volume,
)
