"""createdb: convert FASTA/FASTQ input to a sequence DB.

Byte-compatible with the reference `createdb` default path
(reference src/util/createdb.cpp:348-810):
  - with --shuffle 1 (default) entries are distributed round-robin over 32
    buckets by read order (id % 32), buckets are concatenated in order and
    keys are renumbered 0..N-1 in that physical order
    (DBWriter::createRenumberedDB, createdb.cpp:747-752)
  - data entry = sequence + "\\n\\0"; header entry = header + "\\n\\0"
  - `.lookup` rows key \\t accession \\t sourceFileIdx
  - `.source` rows fileIdx \\t fileName
  - dbtype auto-detection: among the first sampled sequences, if every sample
    has >90% ACGTUN content the DB is nucleotide (createdb.cpp:580-605)
"""

import os

from ..db import dbtype as dbt
from ..db.fasta import iter_fasta, parse_fasta_header
from ..db.writer import DBWriter, write_lookup, write_source
from ..utils import log

SHUFFLE_SPLITS = 32


def createdb(par, cmd):
    filenames = list(par.filenames)
    out_db = filenames.pop(-1)
    # consistent order (reference sorts by basename)
    filenames.sort(key=lambda p: os.path.basename(p))

    # createdb-mode 1 (soft link) keeps sequences in file order; we copy the
    # data (layout differs from the reference's symlink mode) but keys and
    # sequence bytes — everything downstream consumes — match
    n_splits = 1 if par.createdb_mode == 1 else (
        SHUFFLE_SPLITS if par.shuffle else 1)
    # buckets hold (seq, header, file_idx); round-robin by read id
    buckets = [[] for _ in range(n_splits)]

    sample_count = 0
    is_nucl_cnt = 0
    dbtype_forced = {1: dbt.DBTYPE_AMINO_ACIDS, 2: dbt.DBTYPE_NUCLEOTIDES}.get(
        par.dbtype)

    sources = []
    read_id = 0
    for file_idx, path in enumerate(filenames):
        sources.append((file_idx, os.path.basename(path)))
        n_in_file = 0
        for header, seq in iter_fasta(path):
            if len(seq) == 0:
                log.error(f"Invalid sequence {read_id} (length 0)")
                continue
            if dbtype_forced is None and (sample_count < 10 or sample_count % 100 == 0):
                if sample_count < 100:
                    cnt = sum(seq.upper().count(c) for c in b"TAGCUN")
                    if cnt / len(seq) > 0.9:
                        is_nucl_cnt += 1
                sample_count += 1
            buckets[read_id % n_splits].append((seq, header, file_idx))
            read_id += 1
            n_in_file += 1
        if n_in_file == 0:
            log.warning(f"No sequences in {path}")

    base = dbtype_forced
    if base is None:
        base = (dbt.DBTYPE_NUCLEOTIDES
                if sample_count > 0 and is_nucl_cnt == sample_count
                else dbt.DBTYPE_AMINO_ACIDS)

    seq_writer = DBWriter(out_db, base)
    hdr_writer = DBWriter(out_db + "_h", dbt.DBTYPE_GENERIC_DB)
    lookup = []
    key = par.id_offset
    for bucket in buckets:
        for seq, header, file_idx in bucket:
            seq_writer.write(key, seq + b"\n")
            hdr_writer.write(key, header + b"\n")
            acc = parse_fasta_header(header).decode(errors="replace")
            lookup.append((key, acc if acc else str(key), file_idx))
            key += 1
    seq_writer.close()
    hdr_writer.close()
    if par.write_lookup:
        write_lookup(out_db, lookup)
    write_source(out_db, sources)
    log.info(f"Created database {out_db} with {key - par.id_offset} sequences")
    return 0
