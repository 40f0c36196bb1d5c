from . import files, logger  # noqa: F401
