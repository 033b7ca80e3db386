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
    Command("easy-cluster", "easy_cluster", "easy_cluster", CAT_MAIN,
            "Cluster sequences by similarity (FASTA in)",
            "easy-cluster <fasta> <outPrefix> <tmpDir>", 3, 0),
    Command("easy-linclust", "easy_cluster", "easy_linclust", CAT_MAIN,
            "Cluster sequences in linear time (FASTA in)",
            "easy-linclust <fasta> <outPrefix> <tmpDir>", 3, 0),
    Command("search", "search", "search", CAT_WORKFLOW,
            "Sensitive homology search",
            "search <queryDB> <targetDB> <alnDB> <tmpDir>", 4, 4),
    Command("cluster", "cluster_wf", "cluster", CAT_WORKFLOW,
            "Cluster a sequence DB",
            "cluster <seqDB> <clustDB> <tmpDir>", 3, 3),
    Command("linclust", "cluster_wf", "linclust", CAT_WORKFLOW,
            "Cluster a sequence DB in linear time",
            "linclust <seqDB> <clustDB> <tmpDir>", 3, 3),
    Command("createindex", "indexdb_cmd", "createindex", CAT_WORKFLOW,
            "Precompute the prefilter index (workflow wrapper)",
            "createindex <seqDB> [<tmpDir>]", 1, 2),
    Command("createdb", "createdb", "createdb", CAT_DB,
            "Convert FASTA/Q to a sequence DB",
            "createdb <fasta[.gz|.bz2]> ... <seqDB>", 2, 0),
    Command("align", "align_cmd", "align", CAT_CORE,
            "Smith-Waterman gapped alignment of prefilter results",
            "align <queryDB> <targetDB> <prefDB> <alnDB>", 4, 4),
    Command("prefilter", "prefilter_kmer", "prefilter_kmer", CAT_CORE,
            "K-mer inverted-index double-diagonal prefilter",
            "prefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("result2profile", "result2profile", "result2profile", CAT_CORE,
            "Compute a PSSM profile DB from alignment results",
            "result2profile <queryDB> <targetDB> <alnDB> <profileDB>", 4, 4),
    Command("filterresult", "result2profile", "filterresult", CAT_UTIL,
            "Pass an alignment result DB through the MSA filter",
            "filterresult <queryDB> <targetDB> <resultDB> <outDB>", 4, 4),
    Command("ungappedprefilter", "prefilter_cmd", "ungappedprefilter",
            CAT_CORE, "Exhaustive ungapped diagonal prefilter",
            "ungappedprefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("gappedprefilter", "prefilter_cmd", "gappedprefilter", CAT_CORE,
            "Exhaustive gapped Smith-Waterman prefilter",
            "gappedprefilter <queryDB> <targetDB> <prefDB>", 3, 3),
    Command("rescorediagonal", "rescorediagonal", "rescorediagonal",
            CAT_CORE, "Rescore prefilter hits along their diagonal",
            "rescorediagonal <queryDB> <targetDB> <resultDB> <outDB>", 4, 4),
    Command("clust", "clust_cmd", "clust", CAT_CORE,
            "Cluster result DB by set-cover/connected-component/greedy",
            "clust <seqDB> <resultDB> <clustDB>", 3, 3),
    Command("kmermatcher", "kmermatcher", "kmermatcher", CAT_CORE,
            "Find k-mer sharing candidate pairs in linear time",
            "kmermatcher <seqDB> <prefDB>", 2, 2),
    Command("clusthash", "misc_tools", "clusthash", CAT_CORE,
            "Group sequences by reduced-alphabet hash",
            "clusthash <seqDB> <alnDB>", 2, 2),
    Command("gpuserver", "gpuserver_cmd", "gpuserver", CAT_UTIL,
            "Start a resident device index server",
            "gpuserver <paddedSeqDB>", 1, 1),
    Command("align2clust", "align2clust", "align2clust", CAT_UTIL,
            "Fused alignment + incremental clustering",
            "align2clust <seqDB> <resultDB> <clusterDB>", 3, 3),
    Command("mergeclusters", "cluster_tools", "mergeclusters", CAT_UTIL,
            "Merge cascaded clustering steps",
            "mergeclusters <seqDB> <outDB> <clustDB1> ... <clustDBn>", 4, 0),
    Command("result2repseq", "cluster_tools", "result2repseq", CAT_UTIL,
            "Extract representative sequences from clustering",
            "result2repseq <seqDB> <clustDB> <outDB>", 3, 3),
    Command("createseqfiledb", "cluster_tools", "createseqfiledb", CAT_UTIL,
            "Create a DB of unaligned FASTA files from clusters",
            "createseqfiledb <seqDB> <clustDB> <outDB>", 3, 3),
    Command("extractorfs", "nucl_tools", "extractorfs", CAT_UTIL,
            "Extract (and translate) open reading frames",
            "extractorfs <nuclDB> <outDB>", 2, 2),
    Command("translatenucs", "nucl_tools", "translatenucs", CAT_UTIL,
            "Translate a nucleotide DB to amino acids",
            "translatenucs <nuclDB> <aaDB>", 2, 2),
    Command("extractframes", "nucl_tools", "extractframes", CAT_UTIL,
            "Extract frames from a nucleotide sequence DB",
            "extractframes <seqDB> <outSeqDB>", 2, 2),
    Command("splitsequence", "nucl_tools", "splitsequence", CAT_UTIL,
            "Split long sequences into overlapping chunks",
            "splitsequence <seqDB> <outSeqDB>", 2, 2),
    Command("offsetalignment", "nucl_tools", "offsetalignment", CAT_UTIL,
            "Map ORF/frame alignments back to contig coordinates",
            "offsetalignment <qSrcDB> <qOrfDB> <tSrcDB> <tOrfDB> <alnDB> "
            "<outDB>", 6, 6),
    Command("result2dnamsa", "nucl_tools", "result2dnamsa", CAT_UTIL,
            "Generate a DNA MSA DB from a nucleotide result DB",
            "result2dnamsa <queryDB> <targetDB> <resultDB> <msaDB>", 4, 4),
    Command("proteinaln2nucl", "nucl_tools", "proteinaln2nucl", CAT_UTIL,
            "Transform protein alignments to nucleotide space",
            "proteinaln2nucl <nuclQueryDB> <nuclTargetDB> <aaQueryDB> "
            "<aaTargetDB> <alnDB> <outDB>", 6, 6),
    Command("filterdb", "filterdb_cmd", "filterdb", CAT_UTIL,
            "Filter result DB entries by column/file criteria",
            "filterdb <resultDB> <outDB>", 2, 2),
    Command("convertalis", "convertalis", "convertalis", CAT_UTIL,
            "Convert an alignment DB to BLAST-tab/SAM",
            "convertalis <queryDB> <targetDB> <alnDB> <outFile>", 4, 4),
    Command("createtsv", "db_tools", "createtsv", CAT_UTIL,
            "Convert a result DB to TSV",
            "createtsv <queryDB> [<targetDB>] <resultDB> <tsvFile>", 3, 4),
    Command("swapresults", "db_tools", "swapresults", CAT_UTIL,
            "Transpose a result DB (query<->target)",
            "swapresults <queryDB> <targetDB> <resultDB> <outDB>", 4, 4),
    Command("createclusearchdb", "db_tools", "createclusearchdb", CAT_UTIL,
            "Split a clustered sequence DB into rep + member DBs",
            "createclusearchdb <seqDB> <clusterDB> <outDB>", 3, 3),
    Command("view", "db_tools", "view", CAT_UTIL,
            "Print DB entries", "view <DB> [<key> ...]", 1, 0),
    Command("indexdb", "indexdb_cmd", "indexdb", CAT_DB,
            "Precompute the k-mer index table for a sequence DB",
            "indexdb <seqDB> <indexDbBase>", 2, 2),
    Command("makepaddedseqdb", "db_tools", "makepaddedseqdb", CAT_DB,
            "Write a padded (GPU-layout) sequence DB",
            "makepaddedseqdb <seqDB> <outDB>", 2, 2),
    Command("createsubdb", "db_tools", "createsubdb", CAT_DB,
            "Create a subset DB from keys",
            "createsubdb <subsetFileOrDB> <DB> <outDB>", 3, 3),
    Command("mergedbs", "db_tools", "mergedbs", CAT_DB,
            "Merge entries of multiple DBs",
            "mergedbs <DB> <outDB> <DB1> ... <DBn>", 4, 0),
    Command("subtractdbs", "db_tools", "subtractdbs", CAT_DB,
            "Remove all entries of a result DB found in another result DB",
            "subtractdbs <resultDBLeft> <resultDBRight> <outDB>", 3, 3),
    Command("concatdbs", "db_tools", "concatdbs", CAT_DB,
            "Concatenate two DBs",
            "concatdbs <DB1> <DB2> <outDB>", 3, 3),
    Command("rmdb", "db_tools", "rmdb", CAT_DB,
            "Remove a DB", "rmdb <DB>", 1, 1),
    Command("mvdb", "db_tools", "mvdb", CAT_DB,
            "Move a DB", "mvdb <srcDB> <dstDB>", 2, 2),
    Command("cpdb", "db_tools", "cpdb", CAT_DB,
            "Copy a DB", "cpdb <srcDB> <dstDB>", 2, 2),
    Command("lndb", "db_tools", "lndb", CAT_DB,
            "Symlink a DB", "lndb <srcDB> <dstDB>", 2, 2),
    Command("touchdb", "db_tools", "touchdb", CAT_DB,
            "Preload a DB into memory", "touchdb <DB>", 1, 1),
    Command("compress", "db_tools", "compress", CAT_DB,
            "Compress DB entries (per-entry zstd)",
            "compress <DB> <outDB>", 2, 2),
    Command("decompress", "db_tools", "decompress", CAT_DB,
            "Decompress DB entries",
            "decompress <DB> <outDB>", 2, 2),
    Command("setextendeddbtype", "db_tools", "setextendeddbtype", CAT_DB,
            "OR an extended dbtype flag into a DB's .dbtype",
            "setextendeddbtype <DB>", 1, 1),
    Command("dbtype", "db_tools", "dbtype_cmd", CAT_DB,
            "Print the DB type", "dbtype <DB>", 1, 1),
    Command("unpackdb", "db_tools", "unpackdb", CAT_DB,
            "Unpack a DB into separate files",
            "unpackdb <DB> <outDir>", 2, 2),
    Command("tar2db", "db_tools", "tar2db", CAT_DB,
            "Convert content of tar archives to a DB",
            "tar2db <tar[.gz]> ... <outDB>", 2, 0),
    Command("db2tar", "db_tools", "db2tar", CAT_DB,
            "Archive a DB into a tar file",
            "db2tar <DB> <out.tar[.gz]>", 2, 2),
]

_BY_NAME = {c.name: c for c in COMMANDS}


def get_command(name: str) -> Optional[Command]:
    return _BY_NAME.get(name)
