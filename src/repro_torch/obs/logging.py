"""Structured JSON line logging for the serving stack.

One logger namespace (``repro_torch``), one formatter: every record renders as
a single canonical-JSON line (sorted keys, compact separators) with
``ts`` (unix seconds), ``level``, ``logger``, ``event``, plus whatever
structured fields the call site attached::

    log = get_logger("repro_torch.server")
    log.info("request", route="/v1/query", status=200, dur_us=581)
    # -> {"dur_us":581,"event":"request","level":"info", ...}

Until :func:`configure_logging` runs, the ``repro_torch`` logger holds only a
``NullHandler`` -- imports and tests stay silent by default;
:func:`configure_logging` is what turns output on. The active trace id
(:func:`repro_torch.obs.trace.current_trace_id`) is stamped onto every line
emitted inside a traced request, which is how access-log lines join up
with span trees.
"""

from __future__ import annotations

import json
import logging
import sys
from typing import Any, Optional

from .trace import current_trace_id

__all__ = ["configure_logging", "get_logger", "StructuredLogger"]

_ROOT_NAME = "repro_torch"

_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _JSONFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        line = {
            "ts": round(record.created, 6),
            "level": record.levelname.lower(),
            "logger": record.name,
            "event": record.getMessage(),
        }
        fields = getattr(record, "repro_fields", None)
        if fields:
            # structured fields never shadow the envelope keys above
            for k, v in fields.items():
                if k not in line:
                    line[k] = _jsonable(v)
        if record.exc_info and record.exc_info[0] is not None:
            line["exc"] = self.formatException(record.exc_info).splitlines()[-1]
        return json.dumps(line, sort_keys=True, separators=(",", ":"),
                          default=str)


def _jsonable(v: Any) -> Any:
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class StructuredLogger:
    """Thin wrapper binding keyword fields into JSON log lines."""

    __slots__ = ("_log",)

    def __init__(self, log: logging.Logger):
        self._log = log

    def _emit(self, level: int, event: str, fields: dict) -> None:
        if not self._log.isEnabledFor(level):
            return
        tid = current_trace_id()
        if tid is not None and "trace_id" not in fields:
            fields = {**fields, "trace_id": tid}
        self._log.log(level, event, extra={"repro_fields": fields})

    def debug(self, event: str, **fields: Any) -> None:
        self._emit(logging.DEBUG, event, fields)

    def info(self, event: str, **fields: Any) -> None:
        self._emit(logging.INFO, event, fields)

    def warning(self, event: str, **fields: Any) -> None:
        self._emit(logging.WARNING, event, fields)

    def error(self, event: str, **fields: Any) -> None:
        self._emit(logging.ERROR, event, fields)

    def isEnabledFor(self, level: int) -> bool:
        return self._log.isEnabledFor(level)


def get_logger(name: str = _ROOT_NAME) -> StructuredLogger:
    """A structured logger under the ``repro_torch`` namespace (dotted names
    outside it are re-rooted: ``server`` -> ``repro_torch.server``)."""
    if name != _ROOT_NAME and not name.startswith(_ROOT_NAME + "."):
        name = f"{_ROOT_NAME}.{name}"
    return StructuredLogger(logging.getLogger(name))


# default-quiet: a NullHandler suppresses logging's lastResort fallback so
# unconfigured imports/tests never see stray lines on stderr.
logging.getLogger(_ROOT_NAME).addHandler(logging.NullHandler())


def configure_logging(
    level: str = "info", stream: Optional[Any] = None
) -> None:
    """Install the JSON line handler on the ``repro_torch`` root logger at
    ``level`` (debug|info|warning|error). Idempotent: reconfiguring
    replaces the previous handler rather than stacking a second one."""
    lvl = _LEVELS.get(str(level).lower())
    if lvl is None:
        raise ValueError(
            f"unknown log level {level!r}; expected one of {sorted(_LEVELS)}"
        )
    root = logging.getLogger(_ROOT_NAME)
    for h in list(root.handlers):
        if getattr(h, "_repro_obs_handler", False):
            root.removeHandler(h)
    handler = logging.StreamHandler(stream if stream is not None else sys.stderr)
    handler.setFormatter(_JSONFormatter())
    handler._repro_obs_handler = True  # type: ignore[attr-defined]
    root.addHandler(handler)
    root.setLevel(lvl)
    root.propagate = False
