"""Command registry of the port: the commands ported so far.

Same shape as the JAX package's registry (reference src/MMseqsBase.cpp):
each command is a callable `fn(params, command) -> int` registered with its
name, usage string and positional-argument arity, loaded lazily from
`mmseqs2_tpu_torch.commands`. Commands not listed here are not yet ported;
ROADMAP.md says which slice brings them.
"""

import importlib
from dataclasses import dataclass
from typing import Callable, List, Optional

CAT_CORE = "Core modules"
CAT_DB = "Database management"


@dataclass
class Command:
    name: str
    module: str            # python module under mmseqs2_tpu_torch.commands
    func: str              # function name inside the module
    category: str
    description: str
    usage: str
    min_db: int = 0
    max_db: int = 0

    def load(self) -> Callable:
        mod = importlib.import_module(
            f"mmseqs2_tpu_torch.commands.{self.module}")
        return getattr(mod, self.func)


COMMANDS: List[Command] = [
    Command("createdb", "createdb", "createdb", CAT_DB,
            "Convert FASTA/Q to a sequence DB",
            "createdb <fasta[.gz|.bz2]> ... <seqDB>", 2, 0),
    Command("align", "align_cmd", "align", CAT_CORE,
            "Smith-Waterman gapped alignment of prefilter results",
            "align <queryDB> <targetDB> <prefDB> <alnDB>", 4, 4),
]

_BY_NAME = {c.name: c for c in COMMANDS}


def get_command(name: str) -> Optional[Command]:
    return _BY_NAME.get(name)
