"""Configuration: ``.env`` file + process environment (the port's own
copy of the part of gofr_tpu/config.py's reader that
``new_engine_from_config``, the App and the pub/sub clients use).
``get`` returns the raw string; ``get_or_default`` the string or its
default when unset; ``get_int`` and ``get_float`` fall back to their
default on a missing or malformed value; ``get_bool`` reads
1/true/yes/on; ``keys`` names every row that is set."""

from __future__ import annotations

import os
from typing import Mapping


class _TypedMixin:
    """Typed getters shared by the Config implementations."""

    def get(self, key: str) -> str | None:  # pragma: no cover - overridden
        raise NotImplementedError

    def get_int(self, key: str, default: int) -> int:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return int(v)
        except ValueError:
            return default

    def get_float(self, key: str, default: float) -> float:
        v = self.get(key)
        if v in (None, ""):
            return default
        try:
            return float(v)
        except ValueError:
            return default

    def get_or_default(self, key: str, default: str) -> str:
        v = self.get(key)
        return default if v in (None, "") else v

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get(key)
        if v in (None, ""):
            return default
        return v.strip().lower() in ("1", "true", "yes", "on")


def parse_env_file(path: str) -> dict[str, str]:
    """KEY=VALUE lines, '#' comments, optional quoting."""
    out: dict[str, str] = {}
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("export "):
                    line = line[len("export "):]
                if "=" not in line:
                    continue
                key, _, val = line.partition("=")
                key, val = key.strip(), val.strip()
                if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
                    val = val[1:-1]
                elif " #" in val:
                    val = val.split(" #", 1)[0].rstrip()
                if key:
                    out[key] = val
    except OSError:
        pass
    return out


class EnvConfig(_TypedMixin):
    """Loads ``<folder>/.env`` (+ ``.<APP_ENV>.env`` override); the
    process environment wins over the files."""

    def __init__(self, folder: str = "./configs"):
        self.folder = folder
        self._file_vars = parse_env_file(os.path.join(folder, ".env"))
        app_env = os.environ.get("APP_ENV", "")
        if app_env:
            self._file_vars.update(
                parse_env_file(os.path.join(folder, f".{app_env}.env")))

    def get(self, key: str) -> str | None:
        if key in os.environ:
            return os.environ[key]
        return self._file_vars.get(key)

    def keys(self) -> set[str]:
        """Every row set in the files or the process environment."""
        return set(self._file_vars) | set(os.environ)


class MapConfig(_TypedMixin):
    """In-memory config (tests, scripts)."""

    def __init__(self, values: Mapping[str, str] | None = None):
        self.values: dict[str, str] = dict(values or {})

    def get(self, key: str) -> str | None:
        return self.values.get(key)

    def keys(self) -> set[str]:
        return set(self.values)
