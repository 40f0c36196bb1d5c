from .preprocess import (  # noqa: F401
    border_values,
    compute_geometry,
    eval_preprocess,
    eval_preprocess_meta,
    mode_pixel_batch,
    resize_pad_batch,
    resize_pad_plain,
)
