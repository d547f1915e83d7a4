"""CLI runtime: regex sub-command routes with flag binding (the port's
own copy of gofr_tpu/cli.py).

Reference: pkg/gofr/cmd.go:27-63 -- non-flag args are joined into a command
string matched against regex route patterns; pkg/gofr/cmd/request.go:25-67
parses ``-k``, ``--k`` and ``-k=v`` flags; the responder prints data to
stdout and errors to stderr (cmd/responder.go:10-19). ``run_cmd`` returns
the process exit code: 0 when a handler returned, 1 when it raised (its
message on stderr) or when no pattern matched ("No Command Found!" and
the help on stderr).
"""

from __future__ import annotations

import re
import sys
from typing import Any, Iterable

from .context import Context


class CmdRequest:
    """Implements the framework Request surface over argv flags."""

    def __init__(self, args: list[str], flags: dict[str, str]):
        self.args = args
        self.flags = flags
        self.path_params: dict[str, str] = {}

    def param(self, key: str, default: str = "") -> str:
        return self.flags.get(key, default)

    def path_param(self, key: str, default: str = "") -> str:
        return self.flags.get(key, self.path_params.get(key, default))

    def bind(self, into: type | None = None) -> Any:
        """Bind flags into a dataclass (reference cmd/request.go:89-118
        reflection-binds string/bool/int fields)."""
        if into is None:
            return dict(self.flags)
        import dataclasses

        if dataclasses.is_dataclass(into):
            kwargs = {}
            for f in dataclasses.fields(into):
                if f.name not in self.flags:
                    continue
                raw = self.flags[f.name]
                if f.type in (int, "int"):
                    kwargs[f.name] = int(raw)
                elif f.type in (bool, "bool"):
                    kwargs[f.name] = raw.lower() in ("", "1", "true", "yes")
                else:
                    kwargs[f.name] = raw
            return into(**kwargs)
        return into(dict(self.flags))

    def header(self, key: str, default: str = "") -> str:
        return default

    def host_name(self) -> str:
        return "cli"


def parse_args(argv: list[str]) -> tuple[list[str], dict[str, str]]:
    """Split argv into positional args and flags (cmd/request.go:25-67)."""
    args: list[str] = []
    flags: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-"):
            key = a.lstrip("-")
            if "=" in key:
                k, _, v = key.partition("=")
                flags[k] = v
            elif i + 1 < len(argv) and not argv[i + 1].startswith("-"):
                flags[key] = argv[i + 1]
                i += 1
            else:
                flags[key] = "true"
        else:
            args.append(a)
        i += 1
    return args, flags


def run_cmd(app, argv: Iterable[str] | None = None) -> int:
    """Match the joined args against registered sub-command patterns and run
    the handler (reference cmd.go:31-52). Returns a process exit code."""
    argv = list(argv if argv is not None else sys.argv[1:])
    args, flags = parse_args(argv)
    command = " ".join(args)

    for pattern, handler, _desc in app._cmd_routes:
        m = re.fullmatch(pattern, command)
        if m is None:
            continue
        req = CmdRequest(args, flags)
        req.path_params.update(m.groupdict())
        ctx = Context(request=req, container=app.container)
        try:
            data = handler(ctx)
        except Exception as e:
            print(str(e), file=sys.stderr)  # noqa: T201 — command output
            return 1
        if data is not None:
            print(data if isinstance(data, str)  # noqa: T201 — command output
                  else _render(data))
        return 0

    if app._cmd_routes:
        print("No Command Found!", file=sys.stderr)  # noqa: T201 — command output
        _print_help(app)
    return 1


def _render(data: Any) -> str:
    import json

    try:
        return json.dumps(data, indent=2, default=str)
    except TypeError:
        return str(data)


def _print_help(app) -> None:
    for pattern, _h, desc in app._cmd_routes:
        print(f"  {pattern:<30} {desc}", file=sys.stderr)  # noqa: T201 — command output
