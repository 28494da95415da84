"""R-compatible TSV metrics logger (the CLI's -rlog).

The port's copy of `libfm_tpu.utils.rlog` (libFM src/util/rlog.h:29-103):
fields are declared with defaults, `init` writes the header row,
`new_line` writes one TSV row and resets the values to their defaults.
Declaring a field twice raises, as rlog.h:77-85 does.
"""

from __future__ import annotations

import math


class RLog:
    def __init__(self, stream=None, path: str | None = None):
        if path is not None:
            stream = open(path, "w")
        self._out = stream
        self._own = path is not None
        self._header: list[str] = []
        self._defaults: dict[str, float] = {}
        self._values: dict[str, float] = {}

    def add_field(self, name: str, default: float = math.nan) -> None:
        if name in self._defaults:
            raise ValueError(f"the field {name} already exists")
        self._header.append(name)
        self._defaults[name] = default

    def init(self) -> None:
        if self._out is not None:
            self._out.write("\t".join(self._header) + "\n")
            self._out.flush()
        self._values = dict(self._defaults)

    def log(self, field: str, value: float) -> None:
        self._values[field] = value

    def new_line(self) -> None:
        if self._out is not None:
            row = "\t".join(_fmt(self._values.get(h, self._defaults[h])) for h in self._header)
            self._out.write(row + "\n")
            self._out.flush()
        self._values = dict(self._defaults)

    def close(self) -> None:
        if self._own and self._out is not None:
            self._out.close()
            self._out = None


def _fmt(v: float) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return str(v)
    if math.isnan(f):
        return "nan"
    return f"{f:.6g}"
