"""CLI shell of the port: dispatch and usage.

Reference: src/mmseqs.cpp, src/commons/Application.cpp:24-237. The device is
resolved before a command runs (device.py): the CUDA card unless
MMSEQS2_TPU_TORCH_DEVICE=cpu, and an error when neither is available.
"""

import sys
from collections import OrderedDict

from . import __version__
from .device import get_device
from .params import Params
from .registry import COMMANDS, get_command
from .utils import log


def print_usage():
    out = [f"mmseqs2-tpu-torch — PyTorch/CUDA port of mmseqs2-tpu "
           f"(version {__version__})\n"]
    cats = OrderedDict()
    for c in COMMANDS:
        cats.setdefault(c.category, []).append(c)
    for cat, cmds in cats.items():
        out.append(f"\n{cat}:")
        for c in cmds:
            out.append(f"  {c.name:<22} {c.description}")
    out.append("\nUse `python -m mmseqs2_tpu_torch <command> --help` for "
               "command usage.\n")
    print("\n".join(out))


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print_usage()
        return 0
    name = argv[0]
    cmd = get_command(name)
    if cmd is None:
        log.error(f"Command {name} is not yet ported (see ROADMAP.md)")
        return 1
    if "--help" in argv or "-h" in argv:
        print(f"Usage: python -m mmseqs2_tpu_torch {cmd.usage}\n\n"
              f"{cmd.description}")
        return 0
    timer = log.Timer()
    get_device()      # raises without a card unless the CPU was requested
    par = Params().parse(argv[1:], cmd, cmd.min_db, cmd.max_db)
    fn = cmd.load()
    ret = fn(par, cmd)
    log.info(f"Time for processing: {timer}")
    return ret or 0


if __name__ == "__main__":
    sys.exit(main())
