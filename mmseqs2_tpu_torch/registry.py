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

CAT_MAIN = "Easy workflows (for non-experts)"
CAT_WORKFLOW = "Main workflows"
CAT_CORE = "Core modules"
CAT_UTIL = "Utility modules"
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
    Command("easy-search", "easy_search", "easy_search", CAT_MAIN,
            "Sensitive homology search (FASTA in, BLAST-tab out)",
            "easy-search <queryFasta> <targetFastaOrDB> <outFile> <tmpDir>",
            4, 0),
    Command("search", "search", "search", CAT_WORKFLOW,
            "Sensitive homology search",
            "search <queryDB> <targetDB> <alnDB> <tmpDir>", 4, 4),
    Command("createdb", "createdb", "createdb", CAT_DB,
            "Convert FASTA/Q to a sequence DB",
            "createdb <fasta[.gz|.bz2]> ... <seqDB>", 2, 0),
    Command("align", "align_cmd", "align", CAT_CORE,
            "Smith-Waterman gapped alignment of prefilter results",
            "align <queryDB> <targetDB> <prefDB> <alnDB>", 4, 4),
    Command("prefilter", "prefilter_kmer", "prefilter_kmer", CAT_CORE,
            "K-mer inverted-index double-diagonal prefilter",
            "prefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("ungappedprefilter", "prefilter_cmd", "ungappedprefilter",
            CAT_CORE, "Exhaustive ungapped diagonal prefilter",
            "ungappedprefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("gappedprefilter", "prefilter_cmd", "gappedprefilter", CAT_CORE,
            "Exhaustive gapped Smith-Waterman prefilter",
            "gappedprefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("gpuserver", "gpuserver_cmd", "gpuserver", CAT_UTIL,
            "Start a resident device index server",
            "gpuserver <paddedSeqDB>", 1, 1),
    Command("makepaddedseqdb", "db_tools", "makepaddedseqdb", CAT_DB,
            "Write a padded (GPU-layout) sequence DB",
            "makepaddedseqdb <seqDB> <outDB>", 2, 2),
    Command("convertalis", "convertalis", "convertalis", CAT_UTIL,
            "Convert an alignment DB to BLAST-tab/SAM",
            "convertalis <queryDB> <targetDB> <alnDB> <outFile>", 4, 4),
]

_BY_NAME = {c.name: c for c in COMMANDS}


def get_command(name: str) -> Optional[Command]:
    return _BY_NAME.get(name)
