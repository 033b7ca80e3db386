"""DB management / conversion commands: createsubdb, view, createtsv,
mergedbs, subtractdbs, concatdbs, rmdb/mvdb/cpdb/lndb, touchdb, dbtype,
compress/decompress, setextendeddbtype, swapresults, unpackdb, tar2db/db2tar,
makepaddedseqdb and createclusearchdb.

Port of mmseqs2_tpu/commands/db_tools.py. Reference: the single-purpose
tools in src/util/ (createsubdb.cpp, mergedbs.cpp, swapresults.cpp,
createtsv.cpp, ...). makepaddedseqdb of a nucleotide or profile DB is not
yet ported (see ROADMAP.md) and raises.
"""

import os
import shutil

import numpy as np

from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter, remove_db, write_lookup, write_source
from ..utils import log
from .common import fast_atoi

DB_SUFFIXES = ["", ".index", ".dbtype", ".lookup", ".source"]


def _not_ported(what):
    raise NotImplementedError(f"{what} is not yet ported (see ROADMAP.md)")


def _read_key_file(path):
    """Subset spec: either a DB (use its keys) or a flat file of keys."""
    if os.path.exists(path + ".index"):
        r = DBReader(path) if os.path.exists(path + ".dbtype") else None
        if r is not None:
            keys = [int(k) for k in r.keys]
            r.close()
            return keys
        with open(path + ".index") as f:
            return [int(line.split("\t")[0]) for line in f if line.strip()]
    with open(path) as f:
        return [int(line.split()[0]) for line in f if line.strip()]


def createsubdb(par, command):
    """Subset a DB by a key file; sequence-DB ancillary files (headers,
    lookup, source) are symlinked like the reference's
    DBReader::softlinkDb(SEQUENCE_ANCILLARY) (createsubdb.cpp).

    --subdb-mode 1 (SUBDB_MODE_SOFT, createsubdb.cpp:64-65,87-89): write
    only an index referencing the original offsets and symlink the data
    file instead of copying entries."""
    subset, db, out = par.filenames[:3]
    keys = _read_key_file(subset)
    if par.subdb_mode == 1:
        with DBReader(db) as r:
            rows = []
            for key in keys:
                i = r.get_id(key)
                if i < 0:
                    log.warning(f"Key {key} not found in database")
                    continue
                rows.append((key, int(r.offsets[i]), int(r.lengths[i])))
            # writer.close(..., !isOrdered) sorts the index by key
            rows.sort()
            for suf in (".index", ".dbtype"):
                if os.path.islink(out + suf):
                    os.unlink(out + suf)
            with open(out + ".index", "w") as f:
                f.writelines(f"{k}\t{o}\t{n}\n" for k, o, n in rows)
            # symlink every data file (plain or multi-file .0/.1/...)
            for suf in [""] + [f".{k}" for k in range(64)]:
                src = db + suf
                if not os.path.exists(src):
                    if suf != "":
                        break
                    continue
                dst = out + suf
                if os.path.lexists(dst):
                    os.unlink(dst)
                os.symlink(os.path.abspath(src), dst)
            with open(out + ".dbtype", "wb") as f, \
                    open(db + ".dbtype", "rb") as g:
                f.write(g.read())
    else:
        with DBReader(db) as r, \
                DBWriter(out, r.base_type, r.extended_type) as w:
            for key in keys:
                i = r.get_id(key)
                if i < 0:
                    continue
                # preserve raw payload incl. trailing newline,
                # re-add terminator
                w.write(key, r.get_data(i))
    for suf in ("_h", "_h.index", "_h.dbtype", ".lookup", ".source",
                "_mapping", "_taxonomy", "_nodes.dmp", "_names.dmp",
                "_merged.dmp"):
        src, dst = db + suf, out + suf
        if os.path.exists(src) and not os.path.exists(dst):
            os.symlink(os.path.abspath(src), dst)
    return 0


def view(par, command):
    db = par.filenames[0]
    keys = [int(k) for k in par.filenames[1:]]
    with DBReader(db) as r:
        ids = range(r.size) if not keys else [r.get_id(k) for k in keys]
        for i in ids:
            if i < 0:
                continue
            print(r.get_data(i).decode(errors="replace"), end="")
    return 0


def createtsv(par, command):
    """createtsv <queryDB> [<targetDB>] <resultDB> <tsv>
    (src/util/createtsv.cpp:55-200).

    Column layout: queryAccession \t targetAccession [\t line...].
    --target-column N: 1-based column holding the target key (0 = none;
    with the default 1 the key token is stripped from the echoed line,
    otherwise the full line is appended).  --first-seq-as-repr replaces the
    query accession by the first entry's target accession.  --full-header
    quotes the whole header.  Set-extended result DBs resolve accessions
    through the .source table.  --db-output writes a GENERIC_DB instead of
    a flat file."""
    names = par.filenames
    has_target = len(names) == 4
    if has_target:
        qdb, tdb, resdb, out = names
    else:
        qdb, resdb, out = names
        tdb = qdb
    from .convertalis import parse_fasta_header
    res = DBReader(resdb)
    need_set = bool(res.extended_type & dbt.DBTYPE_EXTENDED_SET)
    q_src = t_src = None
    qh = th = None
    if need_set:
        def read_source(path):
            table = {}
            with open(path) as f:
                for line in f:
                    p = line.rstrip("\n").split("\t")
                    if len(p) >= 2:
                        table[int(p[0])] = p[1]
            return table
        q_src = read_source(qdb + ".source")
        t_src = read_source(tdb + ".source") if has_target else q_src
    else:
        qh = DBReader(qdb + "_h")
        th = qh if tdb == qdb else DBReader(tdb + "_h")
    tcol = None if par.target_column == 0 else par.target_column - 1

    def header_of(reader, key):
        hid = reader.get_id(key)
        if hid < 0:
            log.die(f"Invalid database read: key {key} not found in "
                    f"header database")
        data = reader.get_data(hid)
        if par.full_header:
            return '"' + data[:-1].decode().rstrip("\n") + '"'
        return parse_fasta_header(data.decode())

    db_writer = None
    flat = None
    if par.db_output:
        db_writer = DBWriter(out, dbt.DBTYPE_GENERIC_DB,
                             compressed=bool(par.compressed))
    else:
        flat = open(out, "w")
    # LINEAR_ACCCESS iteration (createtsv.cpp:60): data-file offset order
    for i in (int(x) for x in np.argsort(res.offsets, kind="stable")):
        qkey = res.get_db_key(i)
        if need_set:
            qheader = q_src.get(qkey, "")
        else:
            qheader = header_of(qh, qkey)
        buf = []
        entry_index = 0
        for line in res.get_data(i).split(b"\n"):
            if not line:
                continue
            if tcol is None:
                tacc = ""
                rest = b"\t" + line
            else:
                words = line.split()
                if len(words) < tcol:
                    log.warning("Not enough columns!")
                    continue
                key_tok = words[tcol]
                if has_target:
                    tkey = fast_atoi(key_tok)
                    if need_set:
                        tacc = t_src.get(tkey, "")
                    else:
                        tacc = header_of(th, tkey)
                else:
                    tacc = key_tok.decode()
                if tcol == 0:
                    # strip the key token, keep the separator
                    rest = line[len(key_tok):]
                else:
                    rest = b"\t" + line
            if par.first_seq_as_repr and entry_index == 0:
                qheader = tacc
            buf.append(f"{qheader}\t{tacc}{rest.decode()}\n")
            entry_index += 1
        if db_writer is not None:
            db_writer.write(qkey, "".join(buf).encode())
        else:
            flat.write("".join(buf))
    if db_writer is not None:
        db_writer.close()
    else:
        flat.close()
    if qh is not None:
        qh.close()
        if th is not qh:
            th.close()
    res.close()
    return 0


def mergedbs(par, command):
    """Merge entries of multiple DBs per key: out[key] = concat(db_i[key]).

    Reference src/util/mergedbs.cpp: entries of the first DB define the
    order. --prefixes prepends per-input prefixes, --merge-stop-empty stops
    a key's merge at the first empty input, --merge-filter-target keeps
    only merged lines whose target key appears in the db1 entry (each
    target emitted at most once, mergedbs.cpp:78-93).
    """
    db = par.filenames[0]
    out = par.filenames[1]
    ins = par.filenames[2:]
    readers = [DBReader(p) for p in ins]
    base = DBReader(db)
    prefixes = par.prefixes.split(",") if par.prefixes else []
    filter_target = bool(par.merge_filter_target)
    with DBWriter(out, readers[0].base_type, readers[0].extended_type) as w:
        for i in range(base.size):
            key = base.get_db_key(i)
            allowed = None
            if filter_target:
                allowed = set()
                for line in base.get_data(i).split(b"\n"):
                    if line.strip():
                        allowed.add(fast_atoi(line.split()[0]))
            chunks = []
            for fi, r in enumerate(readers):
                j = r.get_id(key)
                data = r.get_data(j) if j >= 0 else None
                if data is None or data in (b"", b"\n"):
                    if par.merge_stop_empty:
                        break
                    continue
                if fi < len(prefixes):
                    chunks.append(prefixes[fi].encode())
                if allowed is None:
                    chunks.append(data)
                else:
                    for line in data.split(b"\n"):
                        if not line.strip():
                            continue
                        t = fast_atoi(line.split()[0])
                        if t in allowed:
                            chunks.append(line + b"\n")
                            allowed.discard(t)
            w.write(key, b"".join(chunks))
    for r in readers:
        r.close()
    base.close()
    return 0


def subtractdbs(par, command):
    """out[key] = lines of left[key] whose target is NOT in right[key].

    Reference src/util/subtractdbs.cpp: only lines with E-value <= the
    min(--e, --e-profile) threshold survive on either side; a left line
    above the threshold is dropped outright (its lookup entry stays false).
    Left entries iterate in file-offset order (LINEAR_ACCCESS).
    """
    import numpy as np

    from .common import fast_atoi

    left_path, right_path, out_path = par.filenames[:3]
    eval_thr = min(par.evalue, par.e_profile)
    left = DBReader(left_path)
    right = DBReader(right_path)

    def entry_evals(data):
        out = []
        for line in data.split(b"\n"):
            if not line:
                continue
            parts = line.split(b"\t")
            ev = float(parts[3]) if len(parts) >= 10 else 0.0
            out.append((fast_atoi(parts[0]), ev, line))
        return out

    order = np.argsort(left.offsets, kind="stable")
    with DBWriter(out_path, left.base_type, left.extended_type) as w:
        for i in order:
            key = left.get_db_key(int(i))
            lookup = {}
            lines = entry_evals(left.get_data(int(i)))
            for t_key, ev, _ in lines:
                if ev <= eval_thr:
                    lookup[t_key] = True
            rj = right.get_id(key)
            if rj >= 0:
                for t_key, ev, _ in entry_evals(right.get_data(rj)):
                    if ev <= eval_thr:
                        lookup[t_key] = False
            out = [ln for t_key, _, ln in lines if lookup.get(t_key, False)]
            w.write(key, b"".join(ln + b"\n" for ln in out))
    left.close()
    right.close()
    return 0


def concatdbs(par, command):
    """Concatenate two DBs (src/util/concatdbs.cpp): by default second DB
    keys are shifted past the first DB's max key; --preserve-keys keeps
    both key sets (must be disjoint unless --take-larger-entry)."""
    a, b, out = par.filenames[:3]
    ra, rb = DBReader(a), DBReader(b)
    preserve = bool(par.preserve_keys)
    max_key = int(ra.keys.max()) + 1 if ra.size else 0
    with DBWriter(out, ra.base_type, ra.extended_type) as w:
        if preserve and par.take_larger_entry:
            other = {int(rb.get_db_key(i)): i for i in range(rb.size)}
            for i in range(ra.size):
                key = ra.get_db_key(i)
                j = other.get(int(key))
                da = ra.get_data(i)
                if j is not None:
                    db_ = rb.get_data(j)
                    w.write(key, db_ if len(db_) > len(da) else da)
                    del other[int(key)]
                else:
                    w.write(key, da)
            for key in sorted(other):
                w.write(key, rb.get_data(other[key]))
        else:
            for i in range(ra.size):
                w.write(ra.get_db_key(i), ra.get_data(i))
            for i in range(rb.size):
                key = rb.get_db_key(i) if preserve \
                    else max_key + rb.get_db_key(i)
                w.write(key, rb.get_data(i))
    ra.close()
    rb.close()
    return 0


def _db_files(path):
    out = []
    for suf in DB_SUFFIXES:
        if os.path.exists(path + suf):
            out.append((path + suf, suf))
    i = 0
    while os.path.exists(f"{path}.{i}"):
        out.append((f"{path}.{i}", f".{i}"))
        i += 1
    return out


def rmdb(par, command):
    remove_db(par.filenames[0])
    return 0


def mvdb(par, command):
    src, dst = par.filenames[:2]
    for f, suf in _db_files(src):
        os.replace(f, dst + suf)
    return 0


def cpdb(par, command):
    src, dst = par.filenames[:2]
    for f, suf in _db_files(src):
        shutil.copy(f, dst + suf)
    return 0


def lndb(par, command):
    src, dst = par.filenames[:2]
    for f, suf in _db_files(src):
        target = dst + suf
        if os.path.lexists(target):
            os.remove(target)
        os.symlink(os.path.abspath(f), target)
    return 0


def touchdb(par, command):
    with DBReader(par.filenames[0]) as r:
        for i in range(r.size):
            r.get_data(i)
    return 0


def dbtype_cmd(par, command):
    base, ext = dbt.read_dbtype(par.filenames[0])
    names = {v: k for k, v in vars(dbt).items()
             if k.startswith("DBTYPE_") and isinstance(v, int)
             and not k.startswith("DBTYPE_EXTENDED")}
    print(names.get(base, f"Unknown ({base})"))
    return 0


def _recompress(par, to_compressed: bool):
    """Shared body of compress/decompress (reference src/util/compress.cpp)."""
    db, out = par.filenames[:2]
    with DBReader(db) as r:
        if r.compressed == to_compressed:
            log.info("Database is already %s." %
                     ("compressed" if to_compressed else "decompressed"))
            # still produce the output DB so workflows can rely on it
        with DBWriter(out, r.base_type, r.extended_type,
                      compressed=to_compressed) as w:
            for i in range(r.size):
                w.write(r.get_db_key(i), r.get_data(i))
    for suf in (".lookup", ".source"):
        if os.path.exists(db + suf):
            shutil.copyfile(db + suf, out + suf)
    return 0


def compress(par, command):
    """Per-entry zstd compression (reference src/util/compress.cpp:50-52)."""
    return _recompress(par, True)


def decompress(par, command):
    """Inverse of compress (reference src/util/compress.cpp:54-56)."""
    return _recompress(par, False)


def setextendeddbtype(par, command):
    """OR an extended flag into a DB's .dbtype
    (reference src/util/setextendeddbtype.cpp)."""
    db = par.filenames[0]
    base, ext = dbt.read_dbtype(db)
    dbt.write_dbtype(db, base, ext | (par.extended_dbtype or 0))
    return 0


def swapresults(par, command):
    """Transpose a result DB: entries keyed by target, lines keyed by query.

    Reference src/util/swapresults.cpp (doswap, isGeneralMode=false) +
    Matcher::swapResult (Matcher.h:97-119): E-values are recomputed from the
    bit score against the query-side DB residue count (the new search space),
    query/target coordinate columns swap, I/D swap in the backtrace, hits
    re-sort by Matcher::compareHits, and every target key up to the target
    DB's last key gets an (possibly empty) entry if it exists in the target
    DB or had a hit filtered by -e.
    """
    from ..ops.evalue import EvalueComputation
    from ..data.submat import get_submat
    from .util_tools import _aln_parse, _aln_to_line

    qdb, tdb, resdb, out = par.filenames[:4]
    q = DBReader(qdb)
    t = DBReader(tdb)
    t_nucl = t.base_type == dbt.DBTYPE_NUCLEOTIDES
    if t_nucl:
        submat = get_submat("nucleotide.out", 1.0, 0.0)
        gap_open, gap_extend = par.gap_open.nucl, par.gap_extend.nucl
    else:
        submat = get_submat(par.sub_mat.aa, 2.0, 0.0)
        gap_open, gap_extend = par.gap_open.aa, par.gap_extend.aa
    evaluer = EvalueComputation(q.total_residues(), submat, gap_open,
                                gap_extend)
    max_target_id = 0
    target_exists = set()
    for i in range(t.size):
        key = t.get_db_key(i)
        target_exists.add(key)
        max_target_id = max(max_target_id, key)

    res = DBReader(resdb)
    # hasBacktrace/isAlignmentResult from the first non-empty entry
    is_aln = False
    has_bt = False
    for i in range(res.size):
        data = res.get_data(i)
        if data:
            cols = len(data.split(b"\n")[0].split(b"\t"))
            is_aln = cols >= 10
            has_bt = cols >= 11
            break

    swapped = {}
    eval_break = set()
    for i in range(res.size):
        qkey = res.get_db_key(i)
        for line in res.get_data(i).split(b"\n"):
            if not line:
                continue
            if is_aln:
                r = _aln_parse(line)
                tkey = r["dbKey"]
                raw = evaluer.compute_raw_score_from_bit_score(r["score"])
                r["eval"] = evaluer.compute_evalue(raw, r["dbLen"])
                r["dbKey"] = qkey
                (r["qStart"], r["qEnd"], r["qLen"], r["dbStart"], r["dbEnd"],
                 r["dbLen"]) = (r["dbStart"], r["dbEnd"], r["dbLen"],
                                r["qStart"], r["qEnd"], r["qLen"])
                r["backtrace"] = r["backtrace"].translate(
                    str.maketrans("ID", "DI"))
                if r["eval"] > par.evalue:
                    eval_break.add(tkey)
                else:
                    swapped.setdefault(tkey, []).append(r)
            else:
                p = line.split(b"\t")
                tkey = int(p[0])
                diag = -np.int16(np.uint16(int(p[2]) & 0xFFFF))
                swapped.setdefault(tkey, []).append(
                    {"dbKey": qkey, "score": int(p[1]), "diag": int(diag)})

    with DBWriter(out, res.base_type, res.extended_type) as w:
        for tkey in range(max_target_id + 1):
            hits = swapped.get(tkey)
            if hits:
                if is_aln:
                    hits.sort(key=lambda r: (r["eval"], -r["score"],
                                             r["dbLen"], r["dbKey"]))
                    body = "".join(_aln_to_line(r, has_bt) for r in hits)
                else:
                    hits.sort(key=lambda r: (-r["score"], r["dbKey"]))
                    body = "".join("%i\t%i\t%i\n" % (r["dbKey"], r["score"],
                                                     r["diag"])
                                   for r in hits)
                w.write(tkey, body.encode())
            elif tkey in eval_break or tkey in target_exists:
                w.write(tkey, b"")
    res.close()
    q.close()
    t.close()
    return 0


_SANITIZE = str.maketrans({c: "@" for c in "\\/:*?<>|"})


def unpackdb(par, command):
    """Unpack a DB into one flat file per entry
    (reference src/util/unpackdb.cpp). Names come from the .lookup
    (--unpack-name-mode 1, default) or the numeric key (mode 0)."""
    import gzip

    db, outdir = par.filenames[:2]
    name_mode = par.unpack_name_mode
    names = {}
    if name_mode == 1:
        if not os.path.exists(db + ".lookup"):
            log.info(f"No lookup file for {os.path.basename(db)} found, "
                     "using key-based file naming")
            name_mode = 0
        else:
            with open(db + ".lookup") as f:
                for line in f:
                    parts = line.split("\t")
                    names[int(parts[0])] = parts[1]
    os.makedirs(outdir, exist_ok=True)
    with DBReader(db) as r:
        for i in r.linear_order():
            i = int(i)
            key = r.get_db_key(i)
            if name_mode == 1:
                name = names[key].translate(_SANITIZE)
            else:
                name = str(key)
            path = os.path.join(outdir, name + par.unpack_suffix)
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "wb") as f:
                f.write(r.get_data(i))
    return 0


def tar2db(par, command):
    """Create a DB from the members of tar archive(s)
    (reference src/util/tar2db.cpp). Every regular member consumes a key;
    members failing --tar-include/--tar-exclude are skipped but still
    advance the key counter. .gz/.bz2 members are decompressed."""
    import bz2
    import gzip
    import re
    import tarfile

    *tars, out = par.filenames
    include = re.compile(par.tar_include)
    exclude = re.compile(par.tar_exclude)
    sources = []
    lookup_lines = []
    key = 0
    with DBWriter(out, par.output_dbtype,
                  compressed=bool(par.compressed)) as w:
        for fi, tf in enumerate(tars):
            sources.append((fi, os.path.basename(tf)))
            with tarfile.open(tf, "r:*") as tar:
                for member in tar:
                    if not member.isreg():
                        continue
                    name = member.name
                    cur = key
                    key += 1
                    if not include.search(name) or exclude.search(name):
                        continue
                    data = tar.extractfile(member).read()
                    if name.endswith(".gz"):
                        data = gzip.decompress(data)
                    elif name.endswith(".bz2"):
                        data = bz2.decompress(data)
                    w.write(cur, data)
                    lookup_lines.append(
                        (cur, os.path.basename(name), fi))
    write_lookup(out, lookup_lines)
    write_source(out, sources)
    return 0


def db2tar(par, command):
    """Pack each DB entry into a tar archive member named from the .lookup
    (reference src/util/db2tar.cpp)."""
    import io
    import tarfile

    db, out = par.filenames[:2]
    lookup = {}
    with open(db + ".lookup") as f:
        for line in f:
            parts = line.split("\t")
            lookup[int(parts[0])] = parts[1]
    mode = "w:gz" if out.endswith((".gz", ".tgz")) else "w"
    with DBReader(db) as r, tarfile.open(out, mode, format=tarfile.USTAR_FORMAT) as tar:
        for i in range(r.size):
            data = r.get_data(i)
            info = tarfile.TarInfo(lookup[r.get_db_key(i)])
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    return 0


def makepaddedseqdb(par, command):
    """Write the GPU-padded numeric sequence DB: entries are aa2num codes
    (+32 when masked/lowercase), 4-byte aligned with X padding, renumbered
    0..N-1 in ascending-length order; the index records L+2
    (reference src/util/makepaddedseqdb.cpp)."""
    from ..data.submat import get_submat
    from ..ops.tantan import likelihood_ratio_matrix, mask_batch
    from .convertalis import parse_fasta_header

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


def createclusearchdb(par, command):
    """`createclusearchdb` — split a clustered sequence DB into a
    representative DB plus a member ("_seq") DB whose data is the
    two-file layout [reps (.0 symlink), members (.1)] with a merged
    key-sorted index (reference src/util/createclusterdb.cpp). Also
    copies the cluster DB to <out>_clu and aliases lookup/source/tax
    files onto the _seq DB."""
    import os

    seq_path, clu_path, out_path = par.filenames[:3]
    clu = DBReader(clu_path)
    suffixes = [""] + [s for s in par.db_suffix_list.split(",") if s]
    for suf in suffixes:
        src = DBReader(seq_path + suf)
        rep_out = out_path + suf
        seq_out = out_path + "_seq" + suf
        rep_entries = []   # (key, offset, length) in rep data file
        with open(rep_out, "wb") as rf, open(seq_out + ".1", "wb") as mf:
            rep_off = 0
            mem_entries = []
            mem_off = 0
            for i in range(clu.size):
                rep_key = clu.get_db_key(i)
                rid = src.get_id(rep_key)
                if rid < 0:
                    log.die(f"Representative {rep_key} does not exist in "
                            f"sequence database.")
                payload = src.get_data(rid) + b"\x00"
                rf.write(payload)
                rep_entries.append((rep_key, rep_off, len(payload)))
                rep_off += len(payload)
                for line in clu.get_data(i).split(b"\n"):
                    if not line.strip():
                        continue
                    dbkey = int(line.split()[0])
                    if dbkey == rep_key:
                        continue
                    mid = src.get_id(dbkey)
                    if mid < 0:
                        log.die(f"Cluster member {dbkey} does not exist in "
                                f"sequence database.")
                    p = src.get_data(mid) + b"\x00"
                    mf.write(p)
                    mem_entries.append((dbkey, mem_off, len(p)))
                    mem_off += len(p)
        # rep DB: plain single-file DB
        rep_entries.sort()
        with open(rep_out + ".index", "w") as f:
            for k, o, l in rep_entries:
                f.write(f"{k}\t{o}\t{l}\n")
        dbt.write_dbtype(rep_out, src.base_type, src.extended_type)
        # _seq DB: .0 -> rep data (symlink), .1 = members, merged index
        if os.path.lexists(seq_out + ".0"):
            os.unlink(seq_out + ".0")
        os.symlink(os.path.basename(rep_out), seq_out + ".0")
        merged = rep_entries + [(k, o + rep_off, l)
                                for k, o, l in mem_entries]
        merged.sort()
        with open(seq_out + ".index", "w") as f:
            for k, o, l in merged:
                f.write(f"{k}\t{o}\t{l}\n")
        dbt.write_dbtype(seq_out, src.base_type, src.extended_type)
        src.close()
    clu.close()
    # copy the clustering and ancillary files
    for suf in ("", ".index", ".dbtype"):
        if os.path.exists(clu_path + suf):
            shutil.copyfile(clu_path + suf, out_path + "_clu" + suf)
    for anc in (".lookup", ".source", "_mapping", "_names.dmp",
                "_nodes.dmp", "_merged.dmp", "_taxonomy"):
        srcf = seq_path + anc
        if os.path.exists(srcf):
            shutil.copyfile(srcf, out_path + anc)
            dst = out_path + "_seq" + anc
            if os.path.lexists(dst):
                os.unlink(dst)
            os.symlink(os.path.basename(out_path + anc), dst)
    return 0
