"""Database tools of the port: `makepaddedseqdb`.

Port of mmseqs2_tpu/commands/db_tools.py, of which this slice needs the one
command that prepares a target DB for the resident device server.
"""

import os
import shutil

import numpy as np

from ..data.submat import get_submat
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter, write_lookup
from ..ops.tantan import likelihood_ratio_matrix, mask_batch
from .convertalis import parse_fasta_header


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def makepaddedseqdb(par, command):
    """Write the GPU-padded numeric sequence DB: entries are aa2num codes
    (+32 when masked/lowercase), 4-byte aligned with X padding, renumbered
    0..N-1 in ascending-length order; the index records L+2
    (reference src/util/makepaddedseqdb.cpp)."""
    db, out = par.filenames[:2]
    ALIGN = 4
    reader = DBReader(db)
    if reader.base_type != dbt.DBTYPE_AMINO_ACIDS:
        _not_ported("makepaddedseqdb of a nucleotide or profile database")
    hdr = DBReader(db + "_h")
    submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
    aa2num = submat.make_aa2num_table()
    lr = likelihood_ratio_matrix(submat) if par.mask else None
    x_idx = submat.alphabet_size - 1
    # SORT_BY_LENGTH descending, then iterate reversed -> ascending length,
    # ties by key-sorted id descending (makepaddedseqdb.cpp:66)
    order = sorted(range(reader.size),
                   key=lambda i: (-int(reader.lengths[i]), i), reverse=True)
    sw = DBWriter(out, reader.base_type,
                  reader.extended_type | dbt.DBTYPE_EXTENDED_GPU)
    hw = DBWriter(out + "_h", dbt.DBTYPE_GENERIC_DB)
    lookup = []
    raws = [np.frombuffer(reader.get_seq(i), dtype=np.uint8) for i in order]
    nums = [aa2num[raw] for raw in raws]
    if par.mask:    # one batched pass; a sequence's mask is its own
        masked, _ = mask_batch([num.astype(np.int64) for num in nums], lr,
                               x_idx, par.mask_prob)
    for new_key, i in enumerate(order):
        key = reader.get_db_key(i)
        raw, num = raws[new_key], nums[new_key]
        is_masked = raw >= ord("a")
        if par.mask:
            if par.mask_lower_case:
                is_masked = is_masked | (masked[new_key] == x_idx)
            else:
                is_masked = masked[new_key] == x_idx
        outnum = np.where(is_masked, num + 32, num).astype(np.uint8)
        pad = (-len(outnum)) % ALIGN
        payload = outnum.tobytes() + bytes([20]) * pad
        sw.write(new_key, payload, add_null=False,
                 index_len=len(outnum) + 2)
        h = hdr.get_data_by_key(key)
        hw.write(new_key, h)
        lookup.append((new_key, parse_fasta_header(h.decode()), key))
    sw.close(sort_by_key=False)
    hw.close(sort_by_key=False)
    if par.write_lookup:
        write_lookup(out, lookup)
        if os.path.exists(db + ".source"):
            shutil.copy(db + ".source", out + ".source")
    reader.close()
    hdr.close()
    return 0
