"""Format converters: convertmsa (Stockholm -> MSA DB), convertprofiledb
(HH-suite HHM ffindex -> profile DB) and the tsv2exprofiledb workflow.

Port of mmseqs2_tpu/commands/convert_tools.py, of which these three
commands come with the MSA tools; `convertkb`, `appenddbtoindex` and
`diskspaceavail` are not yet ported (see ROADMAP.md).
References: src/util/convertmsa.cpp, src/util/convertprofiledb.cpp,
src/util/tsv2exprofiledb.cpp + data/workflow/tsv2exprofiledb.sh.
"""

import math
import os

import numpy as np

from ..db import dbtype as dbt
from ..db.fasta import _open_auto
from ..db.writer import DBWriter
from ..profile.mathx import convert_neff_to_char, fpow2
from ..utils import log
from .common import fast_atoi, get_sub_mat


def convertmsa(par, command):
    """Stockholm MSA flat file (optionally gzipped) -> MSA DB
    (src/util/convertmsa.cpp:11-124). Sequence keys follow entry order;
    '.' gaps become '-' on the first block of a sequence only (the
    reference skips the replacement on continuation appends)."""
    in_path, out_path = par.filenames[:2]
    fh = _open_auto(in_path)
    with DBWriter(out_path, dbt.DBTYPE_MSA_DB,
                  compressed=bool(par.compressed)) as w:
        i = 0
        in_entry = False
        seq_order = []
        sequences = {}
        identifier = ""
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if len(line) < 1:
                continue
            if not in_entry and line == b"# STOCKHOLM 1.0":
                in_entry = True
                continue
            if in_entry and line == b"//":
                in_entry = False
                parts = []
                for j, acc in enumerate(seq_order):
                    hdr = b">"
                    if j == 0 and identifier:
                        hdr += identifier + b" "
                    parts.append(hdr + acc + b"\n" + sequences[acc] + b"\n")
                w.write(i, b"".join(parts))
                i += 1
                seq_order = []
                sequences = {}
                identifier = b""
                continue
            if not in_entry:
                continue
            cols = line.split()
            if line[0:1] == b"#":
                if line.startswith(b"#=GF"):
                    if len(cols) < 3:
                        log.warning("Invalid annotation!")
                        in_entry = False
                        continue
                    if par.identifier_field == 1 and cols[1][:2] == b"AC":
                        identifier = cols[2]
                    elif par.identifier_field == 0 and cols[1][:2] == b"ID":
                        identifier = cols[2]
            else:
                if len(cols) < 2:
                    log.warning("Invalid sequence!")
                    in_entry = False
                    continue
                acc, seq = cols[0], cols[1]
                if acc not in sequences:
                    sequences[acc] = seq.replace(b".", b"-")
                    seq_order.append(acc)
                else:
                    sequences[acc] += seq
    fh.close()
    return 0


# -- convertprofiledb (src/util/convertprofiledb.cpp) --------------------------


def _convert_float_to_char(v: float) -> int:
    """MathUtil::convertFloatToChar minifloat encoder (MathUtil.h:185-204):
    3 exponent bits (excess 6), 5 mantissa bits."""
    if math.isnan(v) or v <= 0.0:
        return 0
    if v >= 2.0:
        return 0xFF
    r, exp = math.frexp(v)
    exp += 6
    if exp > 7:
        return 0xFF
    if -exp >= 5:
        return 0
    mantissa = int(r * 64.0)
    if exp > 0:
        return ((exp << 5) | (mantissa & ~0x20)) & 0xFF
    return (mantissa >> (1 - exp)) & 0x1F


def _parse_hhm(data: bytes, aa2num, pback):
    """parseHMM (convertprofiledb.cpp:15-128), including the reference's
    NEFF-from-the-score-line quirk (it re-parses the same line instead of
    the transition line, convertprofiledb.cpp:115-117)."""
    lines = data.split(b"\n")
    li = 0
    while not lines[li].startswith(b"NAME"):
        li += 1
    header = lines[li][6:] + b"\n"
    while not lines[li].startswith(b">Consensus"):
        li += 1
    li += 1
    while not lines[li].startswith(b">"):
        li += 1
    li += 1
    seq = bytearray()
    while not (lines[li].startswith(b">") or lines[li].startswith(b"#")):
        seq += lines[li]
        li += 1
    while not lines[li].startswith(b"#"):
        li += 1
    li += 5
    out = bytearray()
    seq_pos = 0
    while not lines[li].startswith(b"//"):
        words = lines[li].split()
        probs = np.zeros(20, dtype=np.float32)
        for aa in range(20):
            w = words[aa + 2]
            if w[0:1] == b"*":
                probs[aa] = 0.0
            elif w[0:1] == b"0":
                probs[aa] = 1.0
            else:
                probs[aa] = float(fpow2(np.float32(
                    -(fast_atoi(w) / 1000.0))))
            b = _convert_float_to_char(float(probs[aa])) + 1
            if (b & 0xFF) == 0:
                log.die(f"PSSM score of 0 is too large at pos {seq_pos}")
            out.append(b & 0xFF)
        maxw, maxa = 0.0, 21
        for aa in range(20):
            d = float(probs[aa]) - float(pback[aa])
            if d > maxw:
                maxw, maxa = d, aa
        out.append(int(aa2num[seq[seq_pos]]))
        out.append(maxa)
        neff = fast_atoi(words[7]) / 1000.0
        out.append(int(convert_neff_to_char(np.float32(neff))))
        seq_pos += 1
        li += 3
    return bytes(out), header


def convertprofiledb(par, command):
    """HH-suite HHM ffindex -> profile DB (convertprofiledb.cpp:130-193).
    Output stride is 23 bytes/position, exactly as the reference writes
    it (query/consensus/neff appended, no gap columns)."""
    in_path, out_path = par.filenames[:2]
    data_path, index_path = in_path, in_path + ".index"
    if os.path.exists(in_path + ".ffdata") and os.path.exists(
            in_path + ".ffindex"):
        data_path, index_path = in_path + ".ffdata", in_path + ".ffindex"
    entries = []
    with open(index_path, "rb") as f:
        for line in f:
            parts = line.rstrip(b"\n").split(b"\t")
            if len(parts) >= 3:
                entries.append((parts[0], int(parts[1]), int(parts[2])))
    submat = get_sub_mat(par)
    aa2num = submat.make_aa2num_table()
    dtype = dbt.DBTYPE_HMM_PROFILE
    ext = 0
    if par.pc_mode == 1:  # PCMODE_CONTEXT_SPECIFIC
        ext = dbt.DBTYPE_EXTENDED_CONTEXT_PSEUDO_COUNTS
    data_f = open(data_path, "rb")
    with DBWriter(out_path, dtype, ext,
                  compressed=bool(par.compressed)) as w, \
            DBWriter(out_path + "_h", dbt.DBTYPE_GENERIC_DB,
                     compressed=bool(par.compressed)) as wh:
        for i, (_name, off, length) in enumerate(entries):
            data_f.seek(off)
            payload, header = _parse_hhm(data_f.read(length), aa2num,
                                         submat.pback)
            w.write(i, payload, add_null=True)
            wh.write(i, header)
    data_f.close()
    return 0


def tsv2exprofiledb(par, command):
    """Expandable-profile DB from 4 TSV files
    (data/workflow/tsv2exprofiledb.sh): <in>{,_h,_seq,_aln}.tsv ->
    <out>{,_h,_seq,_seq_h,_aln}."""
    from .db_tools import compress as compress_cmd
    from .db_tools import rmdb as _rm
    from .multihit import tsv2db as _tsv2db
    from .util_tools import aliasdb as _aliasdb

    in_base, out = par.filenames[:2]
    for suf in (".tsv", "_h.tsv", "_seq.tsv", "_aln.tsv"):
        if not os.path.exists(in_base + suf):
            log.die(f"{in_base}{suf} not found!")
    compressed = bool(par.compressed) if par.was_set("compressed") else True
    if par.gpu:
        log.info("Disabling compression for GPU-databases")
        compressed = False

    def run(fn, files, **kw):
        sub = type(par)()
        sub.filenames = files
        for k, v in kw.items():
            sub.set(k, v)
        return fn(sub, None)

    def tsv_to(tsv, db, out_dbtype):
        if compressed:
            run(_tsv2db, [tsv, db + "_tmp"], output_dbtype=out_dbtype)
            run(compress_cmd, [db + "_tmp", db])
            run(_rm, [db + "_tmp"])
        else:
            run(_tsv2db, [tsv, db], output_dbtype=out_dbtype)

    if not os.path.exists(out + "_seq.dbtype"):
        tsv_to(in_base + "_seq.tsv", out + "_seq", 0)
    if not os.path.exists(out + "_seq_h.dbtype"):
        run(_tsv2db, [in_base + "_h.tsv", out + "_seq_h"],
            output_dbtype=12)
    if not os.path.exists(out + ".dbtype"):
        tsv_to(in_base + ".tsv", out, 0)
    if par.gpu:
        from .db_tools import makepaddedseqdb as _pad
        from .db_tools import mvdb as _mv
        if not os.path.exists(out + ".GPU_READY"):
            run(_aliasdb, [out + "_seq_h", out + "_h"])
            run(_pad, [out, out + "_pad"])
            run(_rm, [out])
            run(_rm, [out + "_h"])
            run(_mv, [out + "_pad", out])
            run(_mv, [out + "_pad_h", out + "_h"])
            open(out + ".GPU_READY", "w").close()
    elif not os.path.exists(out + "_h.dbtype"):
        run(_aliasdb, [out + "_seq_h", out + "_h"])
    if not os.path.exists(out + "_aln.dbtype"):
        tsv_to(in_base + "_aln.tsv", out + "_aln", 5)
    return 0
