"""CLI subcommand registry — the `weed` entry point's role
(weed/weed.go:38 + weed/command/command.go:10-29); the port of
seaweedfs_tpu/command/.

Each module registers a Command; `python -m seaweedfs_tpu_torch <name>`
dispatches here. The reference's subcommands are all registered under
their names, flags and help. Those whose planes the port does not have
yet exit 2 naming their ROADMAP item (`Waiting`), as does a command
whose flags ask for such a plane (the NotImplementedError the port's
servers raise for it). `help` prints the command list, as upstream
`weed help` does.
"""

from __future__ import annotations

import argparse
import sys

COMMANDS: dict[str, "Command"] = {}


class Command:
    name = ""
    help = ""

    def add_arguments(self, parser: argparse.ArgumentParser) -> None:
        pass

    def run(self, args: argparse.Namespace) -> int:
        raise NotImplementedError


def register(cls):
    COMMANDS[cls.name] = cls()
    return cls


class Waiting(Command):
    """A reference subcommand whose plane the port does not have yet:
    registered with the reference's flags and help, refused when run
    with exit code 2."""

    item = 0

    def run(self, args: argparse.Namespace) -> int:
        print(f"`{self.name}` is not ported yet (ROADMAP item {self.item})",
              file=sys.stderr)
        return 2


def main(argv: list[str] | None = None) -> int:
    # import for registration side effects
    from seaweedfs_tpu_torch.command import (  # noqa: F401
        servers,
        tools,
        benchmark,
        filer_tools,
    )

    parser = argparse.ArgumentParser(
        prog="seaweedfs_tpu_torch",
        description="SeaweedFS-capability distributed object store, "
        "erasure coding on an NVIDIA GPU (PyTorch + CUDA)",
    )
    sub = parser.add_subparsers(dest="command")
    for name, cmd in sorted(COMMANDS.items()):
        p = sub.add_parser(name, help=cmd.help)
        cmd.add_arguments(p)
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["help"]:
        parser.print_help()
        return 0
    args = parser.parse_args(argv)
    if not args.command:
        parser.print_help()
        return 2
    try:
        return COMMANDS[args.command].run(args) or 0
    except NotImplementedError as e:
        # a plane the port does not have yet, asked for by a flag
        print(f"{args.command}: {e}", file=sys.stderr)
        return 2
