"""`indexdb` / `createindex`: precompute the target k-mer index.

Reference: src/util/indexdb.cpp + PrefilteringIndexReader::createIndexFile
(PrefilteringIndexReader.cpp:52) serialize the IndexTable + SequenceLookup +
metadata into `<db>.idx`; `createindex` (data/workflow/createindex.sh) is
the workflow wrapper (ORF/frame pre-extraction for nucleotide DBs).
`prefilter` prefers a compatible prebuilt index over rebuilding
(IndexReader.h preference, Prefiltering.cpp:111-160 meta override).

Port of mmseqs2_tpu/commands/indexdb_cmd.py for protein and nucleotide
sequence DBs; the index file is the JAX package's format, so either package
reads the other's. A nucleotide DB is indexed with the 5-letter matrix at 1
bit, exact 15-mers by default (Prefiltering.cpp:62-66,207-216).
"""

from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..prefilter.index_io import save_index
from ..utils import log
from .common import EncodedDB, open_seq_db
from .prefilter_kmer import (build_index, compute_kmer_size,
                             get_kmer_threshold)

def indexdb(par, command):
    seq_path, out_path = par.filenames[:2]
    reader = open_seq_db(seq_path)
    is_nucl = reader.base_type == dbt.DBTYPE_NUCLEOTIDES

    if is_nucl:
        seed_name = par.sub_mat.nucl
        seed = get_submat(seed_name, 1.0, 0.0)
        kmer_size = par.kmer_size or 15
        kmer_thr = 0
    else:
        seed_name = par.seed_sub_mat.aa
        seed = get_submat(seed_name, 8.0, -0.2)
        kmer_size = par.kmer_size or compute_kmer_size(
            reader.total_residues())
        kmer_thr = get_kmer_threshold(par.sensitivity, kmer_size,
                                      par.k_score.aa)
    db = EncodedDB(reader, seed)
    spaced = par.spaced_kmer_mode == 1
    table = build_index(db, seed, kmer_size, kmer_thr,
                        par.mask == 1, par.mask_prob,
                        par.mask_lower_case == 1, spaced,
                        par.spaced_kmer_pattern)
    meta = {
        "seed_mat": seed_name,
        "kmer_thr": int(kmer_thr),
        "sensitivity": float(par.sensitivity),
        "mask": int(par.mask), "mask_prob": float(par.mask_prob),
        "mask_lower": int(par.mask_lower_case),
        "spaced": int(spaced), "nucl": int(is_nucl),
        "src_dbtype": int(reader.base_type),
    }
    idx_path = out_path + ".idx"
    save_index(idx_path, table, meta)
    log.info(f"Wrote prebuilt index {idx_path}: "
             f"{len(table.entries_seq)} k-mer positions (k={kmer_size})")
    return 0


def createindex(par, command):
    """Workflow wrapper; this is indexdb directly. Reference createindex.sh
    additionally extracts ORFs/frames for nucleotide DBs before indexing;
    here a nucleotide DB's index is the raw nucleotide index, which the
    nucleotide prefilter reads (as in the JAX package)."""
    seq_path = par.filenames[0]
    par.filenames = [seq_path, seq_path]
    return indexdb(par, command)
