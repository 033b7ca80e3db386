"""Typed command-line parameter system.

Mirrors the semantics of the reference Parameters singleton
(reference src/commons/Parameters.h:21-95): typed flags with defaults,
per-command visible subsets, `was_set` tracking, and MultiParam aa/nucl dual
values ("aa:11,nucl:5" syntax).
"""

import copy
import re
import sys
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from .utils import log


@dataclass
class MultiParam:
    """Dual amino-acid/nucleotide value (reference src/commons/MultiParam.h)."""

    aa: Any
    nucl: Any

    @classmethod
    def parse(cls, text: str, typ: Callable = str):
        if isinstance(text, MultiParam):
            return text
        s = str(text)
        if "aa:" in s or "nucl:" in s:
            aa = nucl = None
            for part in s.split(","):
                part = part.strip()
                if part.startswith("aa:"):
                    aa = typ(part[3:])
                elif part.startswith("nucl:"):
                    nucl = typ(part[5:])
                elif part.startswith("seq:") or part.startswith("prof:"):
                    # k-score style seq/prof MultiParam; store as aa/nucl slots
                    if part.startswith("seq:"):
                        aa = typ(part[4:])
                    else:
                        nucl = typ(part[5:])
            return cls(aa, nucl)
        v = typ(s)
        return cls(v, v)

    def __str__(self):
        return f"aa:{self.aa},nucl:{self.nucl}"


@dataclass
class Param:
    name: str           # e.g. "--max-seqs"
    attr: str           # python attribute name, e.g. "max_seqs"
    typ: Any            # int, float, str, bool, or ("multi", subtype)
    default: Any
    description: str = ""
    category: int = 0   # 1=common, 2=expert
    was_set: bool = field(default=False, compare=False)

    def parse_value(self, text: str):
        if self.typ is bool:
            return bool(int(text))
        if isinstance(self.typ, tuple) and self.typ[0] == "multi":
            return MultiParam.parse(text, self.typ[1])
        return self.typ(text)


class ParamRegistry:
    """All known parameters; commands reference subsets by attr name."""

    def __init__(self):
        self._params: Dict[str, Param] = {}

    def add(self, name, attr, typ, default, description="", category=1):
        p = Param(name, attr, typ, default, description, category)
        self._params[name] = p
        return p

    def by_flag(self, flag: str) -> Optional[Param]:
        return self._params.get(flag)

    def all(self):
        return list(self._params.values())


REGISTRY = ParamRegistry()
_A = REGISTRY.add

# -- global/common ---------------------------------------------------------------
_A("-v", "verbosity", int, 3, "verbosity level 0-3")
_A("--threads", "threads", int, 0, "CPU threads (0 = all)")
_A("--compressed", "compressed", int, 0, "write compressed output")
_A("--extended-dbtype", "extended_dbtype", int, 0,
   "extended dbtype flag: 1 compressed, 2 need src, 4 context pseudo counts")
_A("--max-seq-len", "max_seq_len", int, 65535, "maximum sequence length")
_A("--sub-mat", "sub_mat", ("multi", str),
   MultiParam("blosum62.out", "nucleotide.out"), "substitution matrix")
_A("--seed-sub-mat", "seed_sub_mat", ("multi", str),
   MultiParam("VTML80.out", "nucleotide.out"), "k-mer seed substitution matrix")
_A("--gap-open", "gap_open", ("multi", int), MultiParam(11, 5), "gap open penalty")
_A("--gap-extend", "gap_extend", ("multi", int), MultiParam(1, 2), "gap extend penalty")
_A("--db-load-mode", "db_load_mode", int, 0, "database preload mode")
_A("--remove-tmp-files", "remove_tmp_files", bool, True, "delete temporary files")
_A("--force-reuse", "force_reuse", bool, False, "reuse tmp files from previous runs")

# -- createdb ----------------------------------------------------------------------
_A("--dbtype", "dbtype", int, 0, "0: auto, 1: amino acid, 2: nucleotides")
_A("--shuffle", "shuffle", bool, True, "shuffle the input database")
_A("--createdb-mode", "createdb_mode", int, 0, "0: copy data, 1: soft-link")
_A("--write-lookup", "write_lookup", int, 1, "write .lookup file")
_A("--tar-include", "tar_include", str, ".*", "include tar members matching regex")
_A("--tar-exclude", "tar_exclude", str, "^$", "exclude tar members matching regex")
_A("--unpack-suffix", "unpack_suffix", str, "", "file suffix for unpacked files")
_A("--unpack-name-mode", "unpack_name_mode", int, 1,
   "name unpacked files by 0: DB key, 1: accession (through .lookup)")
_A("--id-offset", "id_offset", int, 0, "numeric id offset")

# -- prefilter ---------------------------------------------------------------------
_A("-s", "sensitivity", float, 4.0, "sensitivity: 1.0 fast .. 7.5 sensitive")
_A("-k", "kmer_size", int, 0, "k-mer length (0: auto)")
_A("--k-score", "k_score", ("multi", int), MultiParam(2147483647, 2147483647),
   "k-mer threshold")
_A("--alph-size", "alph_size", ("multi", int), MultiParam(21, 5), "alphabet size")
_A("--max-seqs", "max_seqs", int, 300, "max prefilter results per query")
_A("--split", "split", int, 0, "split database (0: auto)")
_A("--split-mode", "split_mode", int, 2, "0: target 1: query 2: auto")
_A("--split-memory-limit", "split_memory_limit", str, "0", "RAM per split")
_A("--comp-bias-corr", "comp_bias_corr", bool, True, "composition bias correction")
_A("--comp-bias-corr-scale", "comp_bias_corr_scale", float, 1.0,
   "composition bias correction scale")
_A("--diag-score", "diag_score", bool, True, "ungapped diagonal rescoring")
_A("--exact-kmer-matching", "exact_kmer_matching", int, 0,
   "only exact k-mer matches")
_A("--mask", "mask", int, 1, "low-complexity masking of the index")
_A("--mask-prob", "mask_prob", float, 0.9, "tantan masking probability")
_A("--mask-lower-case", "mask_lower_case", int, 0, "mask lowercase residues")
_A("--mask-n-repeat", "mask_n_repeat", int, 0, "mask N-repeats")
_A("--min-ungapped-score", "min_ungapped_score", int, 15,
   "minimum ungapped diagonal score")
_A("--add-self-matches", "include_identity", bool, False,
   "artificially add entries of queries with themselves (for clustering)")
_A("--spaced-kmer-mode", "spaced_kmer_mode", int, 1, "spaced k-mer pattern")
_A("--spaced-kmer-pattern", "spaced_kmer_pattern", str, "", "custom pattern")
_A("--taxon-list", "taxon_list", str, "", "taxonomy filter expression")
_A("--pairing-dummy-mode", "pairdummymode", int, 0,
   "0: dont include, 1: include dummy pairing entry")
_A("--pairing-mode", "pairmode", int, 0,
   "0: pair maximal per species, 1: pair only if all chains covered")
_A("--pairing-filter", "pairfilter", int, 0,
   "filter hits by 0: top hit, 1: pair by proximity of IDs")
_A("--pairing-prox-dist", "pair_proximity_distance", int, 20,
   "proximity distance threshold for pairing (--pairing-filter 1)")
_A("--prefilter-mode", "prefilter_mode", int, 0,
   "0: kmer, 1: ungapped, 2: exhaustive, 3: ungapped+gapped")
_A("--target-search-mode", "target_search_mode", int, 0, "target search mode")
_A("--gpu", "gpu", int, 0, "use accelerator (TPU) path")
_A("--pca", "pca", str, "substitution:1.100,context:1.400", "pseudo count a")
_A("--pcb", "pcb", str, "substitution:4.100,context:5.800", "pseudo count b")

# -- align --------------------------------------------------------------------------
_A("-a", "add_backtrace", bool, False, "add backtrace (cigar) to alignment db")
_A("--alignment-mode", "alignment_mode", int, 0,
   "0: auto 1: score+endpos 2: +cov 3: +seqid 4: only ungapped")
_A("--alignment-output-mode", "alignment_output_mode", int, 0, "output mode")
_A("-e", "evalue", float, 1.0e-3, "E-value threshold")
_A("--min-seq-id", "min_seq_id", float, 0.0, "minimum sequence identity")
_A("--min-aln-len", "min_aln_len", int, 0, "minimum alignment length")
_A("--expansion-mode", "expansion_mode", int, 0,
   "0: transfer E-value from input alignment 1: rescore inferred backtrace")
_A("--expand-filter-clusters", "expand_filter_clusters", int, 0,
   "filter each cluster alignment set before expansion")
_A("--seq-id-mode", "seq_id_mode", int, 0,
   "0: alignment len 1: shorter seq 2: longer seq")
_A("--alt-ali", "alt_align", int, 0, "alternative alignments")
_A("--mact", "mact", float, 0.035, "maximum accuracy threshold (fwbw)")
_A("--tau", "tau", float, 0.9, "context state pseudo count mixture")
_A("--proteome-similarity", "proteome_sim_thr", float, 0.9,
   "unidirectional proteome similarity threshold")
_A("--proteome-relative-similarity", "proteome_relative_sim_thr", float, 0.9,
   "bidirectional proteome similarity threshold")
_A("--proteome-cascaded-clustering", "proteome_cascaded_clustering", bool, False,
   "cascaded proteome clustering")
_A("--cluster-weight-threshold", "weight_thr", float, 0.9,
   "weight threshold used for cluster priorization")
_A("--pps-weight-file", "pps_weight_file", str, "",
   "precomputed proteome weight file for representative selection")
_A("--proteome-weights", "proteome_weight_file", str, "",
   "proteome weight file for representative selection")
_A("--weight-clustercount", "weight_cluster_count", float, 0.0,
   "cluster-count weight for proteome representative selection")
_A("--proteome-weight-clustercount", "proteome_weight_cluster_count",
   float, 0.0, "cluster-count weight (proteome variant)")
_A("--cluster-module", "cluster_module", int, 0,
   "0: linclust, 1: cluster (easy-proteomecluster)")
_A("--db-suffix-list", "db_suffix_list", str, "_h",
   "suffixes for database to be split in rep/seq")
_A("--db-mirror", "db_mirror", str, "",
   "local mirror directory for `databases` source artifacts (no egress)")
_A("--include-align-files", "include_align_files", bool, False,
   "align2clust: also write an alignment DB at <outDB>_aln")
_A("--filter-cludb-file", "filter_clu_db_file", str, "",
   "align2clust: cluster DB for the all-member gate")
_A("--filter-seqdb-file", "filter_seq_db_file", str, "",
   "align2clust: sequence DB for the all-member gate")
_A("--context-lib", "context_lib", str, "",
   "CRF context library file (default: built-in synthetic library)")
_A("--fwbw-gapopen", "fwbw_gapopen", float, 10.0, "fwbw gap open penalty")
_A("--fwbw-gapextend", "fwbw_gapextend", float, 2.0,
   "fwbw gap extension penalty")
_A("--temperature", "temperature", float, 1.0,
   "temperature for forward-backward")
_A("--blocklen", "blocklen", int, 16, "block length for forward-backward")
_A("--fwbw-backtrace-mode", "fwbw_backtrace_mode", int, 1,
   "0: no backtrace 1: local MAC backtrace")
_A("-c", "cov_thr", float, 0.0, "coverage threshold")
_A("--cov-mode", "cov_mode", int, 0, "coverage mode")
_A("--max-rejected", "max_rejected", int, 2147483647, "max rejected before stop")
_A("--max-accept", "max_accept", int, 2147483647, "max accepted before stop")
_A("--score-bias", "score_bias", float, 0.0, "score bias")
_A("--realign", "realign", bool, False, "realign with adjusted bias")
_A("--realign-score-bias", "realign_score_bias", float, -0.2, "realign bias")
_A("--realign-max-seqs", "realign_max_seqs", int, 2147483647, "realign max seqs")
_A("--corr-score-weight", "corr_score_weight", float, 0.0,
   "correlation score weight")
_A("--zdrop", "zdrop", int, 40, "zdrop (nucleotide alignment)")
_A("--wrapped-scoring", "wrapped_scoring", bool, False, "wrapped diagonal scoring")

# -- clustering -----------------------------------------------------------------------
_A("--cluster-mode", "cluster_mode", int, 0,
   "0: set-cover 1: connected component 2: greedy by length 3: greedy low mem")
_A("--max-iterations", "max_iterations", int, 1000, "CC clustering max depth")
_A("--similarity-type", "similarity_type", int, 2, "2: score 1: seq id")
_A("--single-step-clustering", "single_step_clustering", bool, False,
   "non-cascaded clustering")
_A("--cluster-steps", "cluster_steps", int, 3, "cascaded clustering steps")
_A("--cluster-reassign", "cluster_reassign", bool, False,
   "reassign leaves cascaded errors")
_A("--kmer-per-seq", "kmer_per_seq", int, 21, "k-mers per sequence (linclust)")
_A("--kmer-per-seq-scale", "kmer_per_seq_scale", ("multi", float),
   MultiParam(0.0, 0.2), "scale k-mers per sequence with length")
_A("--adjust-kmer-len", "adjust_kmer_len", bool, False, "adjust k-mer length")
_A("--hash-shift", "hash_shift", int, 67, "hash shift (linclust)")
_A("--include-only-extendable", "include_only_extendable", bool, False,
   "include only extendable")
_A("--ignore-multi-kmer", "ignore_multi_kmer", bool, False,
   "skip repeated k-mers")
_A("--include-adjacency", "include_adjacency", bool, True,
   "adjacency-context center swapping (linclust v2)")
_A("--include-count-table", "include_count_table", bool, True,
   "count-table center swapping (linclust v2)")
_A("--num-adjacency", "num_adjacency", int, 3,
   "adjacency center-swapping iterations")
_A("--num-count-table", "num_count_table", int, 2,
   "count-table center-swapping iterations")
_A("--count-table-scale", "count_table_scale", float, 0.1,
   "fraction of k-mers sampled for the count table")
_A("--linclust-version", "linclust_version", int, 2,
   "linclust version: 1 longest-center, 2 center-swapping chain")
_A("--filter-file", "filter_file", str, "", "filter by file membership")
_A("--rescore-mode", "rescore_mode", int, 0,
   "0: hamming 1: substitution 2: ungapped alignment 3: end-to-end 4: window")
_A("--filter-hits", "filter_hits", bool, False, "filter hits by seqid/cov")
_A("--sort-results", "sort_results", int, 0, "sort results 0: eval 1: seqid")

# -- format conversion ------------------------------------------------------------------
_A("--format-mode", "format_mode", int, 0,
   "0: BLAST-TAB 1: SAM 2: BLAST-TAB+len 3: HTML 4: BLAST-TAB+cols")
_A("--format-output", "format_output", str,
   "query,target,fident,alnlen,mismatch,gapopen,qstart,qend,tstart,tend,evalue,bits",
   "output columns")
_A("--translation-table", "translation_table", int, 1, "NCBI translation table")
_A("--search-type", "search_type", int, 0,
   "0: auto 1: amino 2: translated 3: nucleotide 4: translated-nucl-aln")
_A("--db-output", "db_output", bool, False, "write DB instead of flat file")

# -- profiles ----------------------------------------------------------------------
_A("--e-profile", "e_profile", float, 0.1, "profile inclusion E-value")
_A("--filter-msa", "filter_msa", int, 1, "filter MSA before PSSM")
_A("--max-seq-id", "filter_max_seq_id", float, 0.9, "MSA max pairwise seq id")
_A("--qsc", "qsc", float, -20.0, "MSA min score per aligned residue")
_A("--qid", "qid", str, "0.0", "MSA min seq identity with query")
_A("--cov", "cov_msa_thr", float, 0.0, "MSA min query coverage")
_A("--diff", "n_diff", int, 1000, "keep N most diverse seqs per MSA block")
_A("--filter-min-enable", "filter_min_enable", int, 0,
   "filter only MSAs with more than N seqs")
_A("--wg", "wg", bool, False, "global sequence weighting")
_A("--mask-profile", "mask_profile", int, 1, "tantan-mask profile query")
_A("--profile-output-mode", "profile_output_mode", int, 0,
   "0: profile db, 1: plain text")
_A("--msa-format-mode", "msa_format_mode", int, 2,
   "result2msa output: 2: FASTA MSA, 5/6: a3m")
_A("--skip-query", "skip_query", bool, False, "skip the query sequence")
_A("--match-mode", "match_mode", int, 0,
   "0: MSA columns by first sequence, 1: by gap fraction")
_A("--match-ratio", "match_ratio", float, 0.5, "column match gap ratio")
_A("--msa-type", "msa_type", int, 2, "0: ca3m, 1: a3m, 2: fasta")
_A("--summary-prefix", "summary_prefix", str, "cl", "summary line prefix")
_A("--extract-mode", "extract_mode", int, 2, "extract from 1: query, 2: target")
_A("--gff-type", "gff_type", str, "",
   "feature type(s) in the GFF file to filter by")
_A("--use-seq-id", "use_seq_id", bool, False,
   "diff by fasta accession instead of whole header")
_A("--header-type", "header_type", int, 1, "1: uniclust, 2: metaclust")
_A("--allow-deletion", "allow_deletion", bool, False, "allow MSA deletions")

# -- taxonomy ----------------------------------------------------------------------
_A("--ncbi-tax-dump", "ncbi_tax_dump", str, "", "NCBI taxdump directory")
_A("--tax-mapping-file", "tax_mapping_file", str, "",
   "accession to taxid mapping file")
_A("--tax-mapping-mode", "tax_mapping_mode", int, 0,
   "map by 0: .lookup 1: .source")
_A("--tax-db-mode", "tax_db_mode", int, 1, "0: dmp files, 1: binary")
_A("--lca-ranks", "lca_ranks", str, "", "add column with ranks (',' sep)")
_A("--blacklist", "blacklist", str,
   "12908:unclassified sequences,28384:other sequences",
   "ignored taxa in LCA computation")
_A("--tax-lineage", "tax_lineage", int, 0,
   "0: none, 1: lineage names, 2: lineage taxids")
_A("--majority", "majority_thr", float, 0.5, "majority agreement fraction")
_A("--vote-mode", "vote_mode", int, 1,
   "0: uniform, 1: -log(E-value), 2: score")
_A("--pick-id-from", "pick_id_from", int, 2, "1: query, 2: target")
_A("--report-mode", "report_mode", int, 0,
   "0: Kraken, 1: Krona, 2: skip, 3: Kraken per query DB")
_A("--lca-mode", "lca_mode", int, 3,
   "1: single search LCA, 2/3: approx. 2bLCA, 4: top hit")
_A("--tax-output-mode", "tax_output_mode", int, 0,
   "0: LCA, 1: alignment, 2: both")
_A("--lca-search", "lca_search", bool, False, "approximate 2bLCA search")
_A("--beats-first", "beats_first", bool, False,
   "filter by comparing each entry to the first")
_A("--filter-column", "filter_column", int, 1, "column to filter on")
_A("--comparison-operator", "comparison_operator", str, "",
   "ge, le, e, ip, op, ep")
_A("--comparison-value", "comparison_value", float, 0.0, "comparison value")
_A("--filter-regex", "filter_regex", str, "^.*$", "regex to select column")
_A("--positive-filter", "positive_filter", bool, True,
   "with --filter-file: keep matching lines (else drop them)")
_A("--identifier-field", "identifier_field", int, 1,
   "STOCKHOLM field for the MSA identifier: 0: ID, 1: AC")
_A("--kb-columns", "kb_columns", str, "",
   "list of UniProtKB columns to extract")
_A("--pc-mode", "pc_mode", int, 0,
   "pseudo count mode: 0 substitution-score, 1 context-specific")
_A("--id-list", "id_list", str, "",
   "comma-separated database keys for appenddbtoindex")
_A("--preserve-keys", "preserve_keys", bool, False,
   "keep the keys of the two DBs when concatenating")
_A("--take-larger-entry", "take_larger_entry", bool, False,
   "concatdbs: keep the larger entry on key collision")
_A("--recover-deleted", "recover_deleted", bool, False,
   "recover deleted sequences during clustering update")
_A("--subdb-mode", "subdb_mode", int, 0,
   "subdb mode: 0 copy data, 1 soft-link data, 2 hard-link data")
_A("--mapping-file", "mapping_file", str, "",
   "rewrite the filter column by a key->value mapping file")
_A("--extract-lines", "extract_lines", int, 0, "extract first N lines")
_A("--sort-entries", "sort_entries", int, 0,
   "sort entries: 1 increasing, 2 decreasing, 3 shuffle, 4 priority")
_A("--weights", "weights", str, "", "weights file for priority sorting")
_A("--join-db", "join_db", str, "",
   "join another database entry by the key in the filter column")
_A("--filter-expression", "filter_expression", str, "",
   "mathematical expression over $N columns to filter lines")
_A("--trim-to-one-column", "trim_to_one_column", bool, False,
   "output only the filter column")

_A("--use-fasta-header", "use_header", bool, False, "use fasta header")
_A("--prefix", "mapping_prefix", str, "", "prefix for all entries")
_A("--tsv", "tsv_out", bool, False, "TSV output")
_A("--output-dbtype", "output_dbtype", int, 12,
   "dbtype of the resulting database (12: generic)")
_A("--stat", "stat", str, "",
   "statistic: linecount mean min max sum doolittle charges seqlen strlen "
   "firstline")
_A("--simple-best-hit", "simple_best_hit", bool, True,
   "use the best hit's E-value without second-best correction")
_A("--alpha", "alpha", float, 1.0,
   "set significance threshold alpha for p-value aggregation")
_A("--aggregation-mode", "aggregation_mode", int, 0,
   "combine p-values: 0 multihit 1 min 2 product 3 truncated product")
_A("--short-output", "short_output", bool, False,
   "print only the set p-value (resultsbyset)")
_A("--overlap", "overlap", float, 0.0, "maximum overlap of covered regions")
_A("--split-aa", "split_aa", bool, False, "split by amino acid counts")

# -- nucleotide / translated search ------------------------------------------------
_A("--strand", "strand", int, 1, "strand: 0 reverse, 1 forward, 2 both")
_A("--forward-frames", "forward_frames", str, "1,2,3", "forward frames")
_A("--reverse-frames", "reverse_frames", str, "1,2,3", "reverse frames")
_A("--translate", "translate", int, 0, "translate ORF to amino acids")
_A("--sequence-overlap", "sequence_overlap", int, 0,
   "overlap between split sequences")
_A("--sequence-split-mode", "sequence_split_mode", int, 1,
   "0: soft-link split, 1: hard copy split")
_A("--headers-split-mode", "headers_split_mode", int, 0,
   "0: original headers, 1: position headers")
_A("--merge-query", "merge_query", int, 1, "combine ORFs+contigs")
_A("--chain-alignments", "chain_alignments", int, 0, "chain alignments")
_A("--orf-start-mode", "orf_start_mode", int, 1,
   "0: from start to stop, 1: any to stop, 2: longest ORF")
_A("--min-length", "orf_min_length", int, 30, "min codons in ORF")
_A("--max-length", "orf_max_length", int, 32734, "max codons in ORF")
_A("--max-gaps", "orf_max_gaps", int, 2147483647, "max ORF gaps")
_A("--contig-start-mode", "contig_start_mode", int, 2,
   "contig start: 0 incomplete, 1 complete, 2 both")
_A("--contig-end-mode", "contig_end_mode", int, 2,
   "contig end: 0 incomplete, 1 complete, 2 both")
_A("--orf-filter", "orf_filter", int, 1, "prefilter ORFs before search")
_A("--orf-filter-e", "orf_filter_e", float, 100.0, "ORF filter evalue")
_A("--orf-filter-s", "orf_filter_s", float, 2.0, "ORF filter sensitivity")
_A("--use-all-table-starts", "use_all_table_starts", bool, False,
   "use all codons in table as ORF start")

# -- workflow --------------------------------------------------------------------------
_A("--start-sens", "start_sens", float, 4.0, "start sensitivity")
_A("--sens-steps", "sens_steps", int, 1, "number of search steps")
_A("--num-iterations", "num_iterations", int, 1, "profile search iterations")
_A("--exhaustive-search", "exhaustive_search", bool, False, "exhaustive mode")


class Params:
    """Parsed parameter values for one command invocation."""

    def __init__(self):
        for p in REGISTRY.all():
            setattr(self, p.attr, copy.deepcopy(p.default))
        self._was_set = set()
        self.filenames: List[str] = []

    def was_set(self, attr: str) -> bool:
        return attr in self._was_set

    def set(self, attr: str, value) -> None:
        setattr(self, attr, value)
        self._was_set.add(attr)

    def parse(self, argv: List[str], command=None, min_db: int = 0,
              max_db: int = 0) -> "Params":
        i = 0
        n = len(argv)
        while i < n:
            tok = argv[i]
            if tok == "--":
                # everything after a bare `--` is positional (apply's
                # program + args; reference src/util/apply.cpp argv split)
                self.filenames.extend(argv[i + 1:])
                break
            if tok.startswith("-") and len(tok) > 1 and not _is_number(tok):
                p = REGISTRY.by_flag(tok)
                if p is None:
                    log.die(f"Unrecognized parameter \"{tok}\"")
                if p.typ is bool and (i + 1 >= n or argv[i + 1] not in ("0", "1")):
                    self.set(p.attr, True)
                    i += 1
                else:
                    if i + 1 >= n:
                        log.die(f"Missing argument for {tok}")
                    self.set(p.attr, p.parse_value(argv[i + 1]))
                    i += 2
            else:
                self.filenames.append(tok)
                i += 1
        if max_db and len(self.filenames) > max_db:
            log.die(f"Too many positional arguments ({len(self.filenames)} > {max_db})")
        if min_db and len(self.filenames) < min_db:
            usage = command.usage if command is not None else ""
            log.die(f"Not enough positional arguments.\nUsage: {usage}")
        log.set_level(self.verbosity)
        return self

    def to_args(self, attrs: List[str]) -> List[str]:
        """Serialize selected params back to CLI tokens (for workflow steps)."""
        out = []
        for attr in attrs:
            for p in REGISTRY.all():
                if p.attr == attr:
                    v = getattr(self, attr)
                    if isinstance(v, bool):
                        v = int(v)
                    out += [p.name, str(v)]
                    break
        return out


def _is_number(tok: str) -> bool:
    return bool(re.match(r"^-[0-9.]", tok))

_A("--proteome-include-align-files", "proteome_include_align_files", bool,
   False, "proteomecluster: also write the protein alignment DB")
_A("--cluster-version", "cluster_version", int, 1, "clustering version")
_A("--set-mode", "set_mode", bool, False, "set mode (linclust)")
_A("--clust-hash", "clust_hash", bool, False,
   "use whole-sequence hashing for clustering")
_A("--use-parallelism", "use_parallelism", bool, False,
   "parallel write-buffer dataflow (accepted; the device pipeline always "
   "batches)")
_A("--need-write-buffer", "need_write_buffer", bool, False,
   "write-buffer dataflow (accepted for CLI parity)")
_A("--switch-consensus-rep", "switch_consensus_rep", bool, False,
   "switch cluster representatives to the consensus sequence")
_A("--translation-mode", "translation_mode", int, 0,
   "0: orfs->translate, 1: full reading frames")
_A("--add-orf-stop", "add_orf_stop", bool, False,
   "add stop codon '*' at the ORF ends")
_A("--disk-space-limit", "disk_space_limit", str, "0",
   "max disk usage for tmp files")
_A("--local-tmp", "local_tmp", str, "", "local per-node tmp directory")
_A("--mpi-runner", "runner", str, "",
   "multi-host launcher prefix (reference: mpirun; here: informational)")
_A("--gpu-server", "gpu_server", int, 0,
   "use a running gpuserver for device scans")
_A("--gpu-server-wait-timeout", "gpu_server_wait_timeout", int, 600,
   "seconds to wait for the device server")
_A("--min-sequences", "min_sequences", int, 1,
   "minimum members for profile conversion")
_A("--max-sequences", "max_sequences", int, 2147483647,
   "maximum members for profile conversion")
_A("--full-header", "full_header", bool, False,
   "use the full header in output")
_A("--first-seq-as-repr", "first_seq_as_repr", bool, False,
   "use the first sequence of a cluster as its representative")
_A("--pick-n-sim-kmer", "pick_n_best_kmer", int, 1,
   "pick N similar k-mers per position (profile linclust)")

_A("--check-compatible", "check_compatible", int, 0,
   "0: always recreate index, 1: recreate only if needed, 2: fail if "
   "incompatible")
_A("--column-to-take", "column_to_take", int, -1,
   "column to take in join mode (-1: whole line)")
_A("--create-lookup", "create_lookup", int, 0,
   "create a database lookup file")
_A("--exhaustive-search-filter", "exhaustive_search_filter", int, 0,
   "filter results during exhaustive search")
_A("--greedy-best-hits", "greedy_best_hits", bool, False,
   "choose best hits greedily to cover the query (summarizeresult)")
_A("--hh-format", "hh_format", bool, False,
   "format singleton entries for hhsuite (convertmsa)")
_A("--id-mode", "id_mode", int, 0,
   "select entries by 0: db keys, 1: FASTA identifiers (createsubdb)")
_A("--idx-entry-type", "idx_entry_type", int, 0,
   "0: sequence, 1: src sequence, 2: header, 3: src header")
_A("--idx-seq-src", "idx_seq_src", int, 0,
   "0: auto, 1: split/translated sequences, 2: input sequences")
_A("--index-dbsuffix", "index_dbsuffix", str, "",
   "db suffix for the index (cluster dbs)")
_A("--index-subset", "index_subset", int, 0,
   "specialized index subset bits")
_A("--merge-filter-target", "merge_filter_target", bool, False,
   "mergedbs: keep merged lines whose target key is in the db1 entry")
_A("--merge-stop-empty", "merge_stop_empty", bool, False,
   "mergedbs: stop merging after an empty entry")
_A("--neff", "neff", float, 1.0,
   "Neff included into context state profile")
_A("--prefixes", "prefixes", str, "",
   "mergedbs: comma separated prefixes for each entry")
_A("--pseudo-cnt-mode", "pseudo_cnt_mode", int, 0,
   "0: substitution-matrix or 1: context-specific pseudocounts")
_A("--result-direction", "result_direction", int, 1,
   "result is 0: query, 1: target centric (kmersearch)")
_A("--target-column", "target_column", int, 1,
   "swapdb: target column (0 if no target id)")
_A("--touch-lock", "touch_lock", bool, False,
   "touchdb: keep the database resident until killed")
_A("--use-header-file", "use_header_file", bool, False,
   "map entry keys through the header DB")
_A("--gap-pc", "gap_pc", int, 10,
   "pseudo count for position-specific gap penalties (accepted; gap "
   "position scoring is not compiled in the reference default either)")
