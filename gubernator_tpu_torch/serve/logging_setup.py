"""Logging setup: leveled, optionally JSON-formatted, category-tagged
(the port's copy of gubernator_tpu/serve/logging_setup.py).

The reference logs through logrus with a `category` field per subsystem
and a JSON-(un)marshallable level knob (reference logging/logging.go:25-54,
gubernator.go:54). Here: stdlib logging with logger names as the category,
a JSON formatter for machine-shipped logs, and level parsing that accepts
the same spellings logrus does ("panic" through "trace").
"""

from __future__ import annotations

import json
import logging
import sys
import time

# logrus level names (logging/logging.go) -> stdlib levels
_LEVELS = {
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warning": logging.WARNING,
    "warn": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def parse_level(name: str) -> int:
    """Parse a log level name; raises ValueError on unknown (the unmarshal
    contract of reference logging/logging.go:37-53)."""
    try:
        return _LEVELS[name.strip().lower()]
    except KeyError:
        raise ValueError(f"unknown log level {name!r}") from None


class JsonFormatter(logging.Formatter):
    """One JSON object per line: time, level, category, message."""

    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S%z", time.localtime(record.created)
            ),
            "level": record.levelname.lower(),
            "category": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            entry["exc"] = self.formatException(record.exc_info)
        return json.dumps(entry)


def setup_logging(level: str = "info", json_format: bool = False) -> None:
    """Configure the root logger for the daemon."""
    handler = logging.StreamHandler(sys.stderr)
    if json_format:
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(parse_level(level))
