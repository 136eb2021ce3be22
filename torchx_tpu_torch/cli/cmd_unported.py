"""Stand-ins for the ``tpx`` commands whose layers are not ported yet.

Each keeps its name in ``tpx-torch``'s command table and, when run, exits
1 with a message naming the ROADMAP queue 1 item that brings its layer,
never in silence. A command moves to its own module with its layer.
"""

from __future__ import annotations

import argparse
import sys

from torchx_tpu_torch.cli.cmd_base import SubCommand


class UnportedCommand(SubCommand):
    """A command whose layer lands with a later ROADMAP item."""

    #: the command's name in the table
    name = ""
    #: what it needs, with the item that brings it
    needs = ""

    def add_arguments(self, subparser: argparse.ArgumentParser) -> None:
        # every argument, options and --help included, reaches run(): no
        # prefix character marks an option from here on
        subparser.prefix_chars = "\0"
        subparser.add_argument("rest", nargs="*")

    def run(self, args: argparse.Namespace) -> None:
        print(
            f"error: `tpx-torch {self.name}` needs {self.needs}, which the port"
            " has not brought over yet",
            file=sys.stderr,
        )
        sys.exit(1)


def _unported(name: str, needs: str) -> type[UnportedCommand]:
    return type(f"Cmd_{name}", (UnportedCommand,), {"name": name, "needs": needs})


CmdLint = _unported("lint", "the analyzer, ROADMAP queue 1 item 2.8 (analyze/)")
CmdExplain = _unported("explain", "the analyzer, ROADMAP queue 1 item 2.8 (analyze/)")
CmdTune = _unported("tune", "the tuner, ROADMAP queue 1 item 2.8 (tune/)")
CmdSim = _unported("sim", "the simulator, ROADMAP queue 1 item 2.8 (sim/)")
CmdSelfcheck = _unported(
    "selfcheck", "the analyzer's self-check, ROADMAP queue 1 item 2.8 (selfcheck/)"
)
CmdCell = _unported("cell", "the federation, ROADMAP queue 1 item 2.8 (federation/)")
CmdTop = _unported(
    "top",
    "the federation beside the control client, ROADMAP queue 1 items 2.7"
    " (control/client.py, ported) and 2.8 (federation/)",
)
