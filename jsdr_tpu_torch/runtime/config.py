"""Configuration service — the IConfig analog (IConfig.java:4-7,
jsdr.java:81-115).

Java-properties-style file with schema versioning (unknown/old versions
are discarded, jsdr.java:242-254), typed accessors that write back
defaults on first read, and CLI ``key=val`` overrides
(jsdr.java:256-265).

A copy of :mod:`jsdr_tpu.runtime.config` (it imports no jax),
numbers and behaviour unchanged; tests/test_torch_host_copies.py holds
it equal to the reference.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Optional

CONFIG_VERSION = 1
_VERSION_KEY = "jsdr-tpu-version"


class Config:
    def __init__(self, path: Optional[str | Path] = None,
                 overrides: Optional[Iterable[str]] = None):
        self.path = Path(path) if path else None
        self._props: dict[str, str] = {}
        if self.path and self.path.exists():
            self._load()
        for kv in overrides or []:
            if "=" in kv:
                k, v = kv.split("=", 1)
                self._props[k.strip()] = v.strip()

    def _load(self):
        props: dict[str, str] = {}
        for line in self.path.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith(("#", "!")):
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                props[k.strip()] = v.strip()
        # version check: discard stale schemas (jsdr.java:246-254)
        try:
            if int(props.get(_VERSION_KEY, "-1")) == CONFIG_VERSION:
                self._props = props
        except ValueError:
            pass

    def save(self):
        if not self.path:
            return
        self._props[_VERSION_KEY] = str(CONFIG_VERSION)
        lines = [f"{k}={v}" for k, v in sorted(self._props.items())]
        self.path.write_text("# jsdr-tpu configuration\n" + "\n".join(lines) + "\n")

    # typed accessors with default write-back (jsdr.java:81-103)
    def get(self, key: str, default: str = "") -> str:
        if key not in self._props:
            self._props[key] = default
        return self._props[key]

    def get_int(self, key: str, default: int) -> int:
        try:
            if key in self._props:
                return int(self._props[key])
        except ValueError:
            pass
        self._props[key] = str(default)
        return default

    def get_float(self, key: str, default: float) -> float:
        try:
            if key in self._props:
                return float(self._props[key])
        except ValueError:
            pass
        self._props[key] = str(default)
        return default

    def set(self, key: str, val) -> None:
        self._props[key] = str(val)

    def as_dict(self) -> dict[str, str]:
        return dict(self._props)
