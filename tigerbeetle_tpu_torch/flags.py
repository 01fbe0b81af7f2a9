"""Struct-driven CLI parsing.

The reference derives its whole CLI from structs at compile time
(reference: src/flags.zig — field name -> --flag, defaults from the
struct, `fatal` helpers; src/tigerbeetle/cli.zig:54-116 builds the
command surface from them). The Python analog: a dataclass per command,
parsed by introspection —

    @dataclasses.dataclass
    class Start:
        addresses: str          # required (no default): --addresses=...
        replica: int = 0        # optional with default
        verbose: bool = False   # presence flag: --verbose
        path: str = positional("data file")  # positional argument

    args = flags.parse(Start, argv)

Field name `snake_case` maps to `--kebab-case`. Unknown flags, missing
required flags, and malformed values exit via `fatal` (the reference's
behavior: print one line, exit 1).

The port's copy of `tigerbeetle_tpu/flags.py`, the same code, so that
both CLIs parse the same argument lists into the same dataclasses.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import get_type_hints


def positional(help_: str = ""):
    """Marks a dataclass field as a positional argument."""
    return dataclasses.field(
        default=dataclasses.MISSING, metadata={"positional": True, "help": help_}
    )


def fatal(msg: str) -> "NoReturn":  # noqa: F821
    sys.stderr.write(f"error: {msg}\n")
    raise SystemExit(1)


def _kebab(name: str) -> str:
    return name.replace("_", "-")


def usage(spec_cls) -> str:
    """Generated per-command help: the dataclass IS the flag surface."""
    hints = get_type_hints(spec_cls)
    flags_out, pos_out = [], []
    for f in dataclasses.fields(spec_cls):
        typ = hints[f.name].__name__
        if f.metadata.get("positional"):
            pos_out.append(f"  <{f.name}>  {f.metadata.get('help', '')}")
            continue
        default = (
            "required"
            if f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
            else f"default: {f.default!r}"
        )
        comment = (f.metadata or {}).get("help", "")
        flags_out.append(
            f"  --{_kebab(f.name)} <{typ}>  ({default}) {comment}".rstrip()
        )
    return "\n".join(["flags:"] + flags_out + ["arguments:"] + pos_out) + "\n"


def parse(spec_cls, argv: list[str]):
    """Parse argv into an instance of the dataclass `spec_cls`."""
    assert dataclasses.is_dataclass(spec_cls)
    if any(a in ("-h", "--help") for a in argv):
        sys.stdout.write(usage(spec_cls))
        raise SystemExit(0)
    hints = get_type_hints(spec_cls)
    by_flag: dict[str, dataclasses.Field] = {}
    positionals: list[dataclasses.Field] = []
    for f in dataclasses.fields(spec_cls):
        if f.metadata.get("positional"):
            positionals.append(f)
        else:
            by_flag["--" + _kebab(f.name)] = f

    values: dict[str, object] = {}
    pos_seen: list[str] = []
    i = 0
    while i < len(argv):
        arg = argv[i]
        i += 1
        if not arg.startswith("--"):
            pos_seen.append(arg)
            continue
        name, eq, inline = arg.partition("=")
        f = by_flag.get(name)
        if f is None:
            fatal(f"unknown flag {name}")
        typ = hints[f.name]
        if typ is bool:
            if eq:
                fatal(f"{name} takes no value")
            values[f.name] = True
            continue
        if eq:
            raw = inline
        else:
            if i >= len(argv):
                fatal(f"{name} requires a value")
            raw = argv[i]
            i += 1
        try:
            values[f.name] = typ(raw)
        except ValueError:
            fatal(f"{name}: invalid {typ.__name__} {raw!r}")

    if len(pos_seen) > len(positionals):
        fatal(f"unexpected argument {pos_seen[len(positionals)]!r}")
    for f, raw in zip(positionals, pos_seen):
        try:
            values[f.name] = hints[f.name](raw)
        except ValueError:
            fatal(f"{f.name}: invalid {hints[f.name].__name__} {raw!r}")

    for f in dataclasses.fields(spec_cls):
        if f.name in values:
            continue
        if (
            f.default is dataclasses.MISSING
            and f.default_factory is dataclasses.MISSING
        ):
            what = f.name if f.metadata.get("positional") else "--" + _kebab(f.name)
            fatal(f"missing required {what}")
    return spec_cls(**values)
