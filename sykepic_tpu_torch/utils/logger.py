"""Logging setup (parity with reference ``sykepic/utils/logger.py:14-34``).

Behavior kept from the reference:

- ``get_logger(name)`` lazily runs :func:`setup` once, then returns the named
  stdlib logger (reference ``logger.py:14-19``).
- ``setup()`` without a config file uses ``logging.basicConfig`` with the
  ``LOGLEVEL`` environment override and the same ``{asctime} - {name} -
  {levelname} - {message}`` format (reference ``logger.py:29-34``).
- ``setup(config_file)`` loads a YAML dictConfig and auto-creates the log file
  directory (reference ``logger.py:22-28``).
"""

import logging
import os
from logging.config import dictConfig
from pathlib import Path

_SETUP_RAN = False


def get_logger(name: str) -> logging.Logger:
    global _SETUP_RAN
    if not _SETUP_RAN:
        setup()
        _SETUP_RAN = True
    return logging.getLogger(name)


# the reference's record format, str.format style (parity: downstream log
# scrapers may key on it)
_FORMAT = " - ".join("{" + f + "}" for f in
                     ("asctime", "name", "levelname", "message"))


def setup(config_file=None) -> None:
    if not config_file:
        env_level = os.environ.get("LOGLEVEL", "INFO")
        logging.basicConfig(level=env_level, format=_FORMAT, style="{")
        return
    import yaml

    config = yaml.safe_load(Path(config_file).read_text())
    file_target = Path(config["handlers"]["file"]["filename"])
    file_target.parent.mkdir(parents=True, exist_ok=True)
    dictConfig(config)
