"""`easy-cluster` / `easy-linclust`: FASTA in, cluster TSV/FASTA out.

Reference: src/workflow/EasyCluster.cpp + data/workflow/easycluster.sh —
createdb -> cluster/linclust -> createtsv + result2repseq(+flat FASTA).
Outputs: <prefix>_cluster.tsv, <prefix>_rep_seq.fasta, <prefix>_all_seqs.fasta.
"""

from ..db.reader import DBReader
from ..utils import log
from ..workflow import Workflow
from .easy_search import is_database


def _easy(par, command, cluster_cmd):
    fasta, out_prefix, tmp = par.filenames[:3]
    wf = Workflow(tmp, par.force_reuse)

    seq_db = wf.path("input")
    if is_database(fasta):
        seq_db = fasta
    else:
        # EasyCluster.cpp:17 uses soft createdb mode (file order, no shuffle)
        wf.step(seq_db, "createdb",
                [fasta, seq_db, "--createdb-mode", 1], par)

    clu = wf.path("clu")
    clu_tmp = wf.path("clu_tmp")
    wf.step(clu, cluster_cmd, [seq_db, clu, clu_tmp], par)

    # cluster.tsv
    from ..registry import get_command
    from ..params import Params

    def run(name, args):
        cmd = get_command(name)
        sub = Params().parse([str(a) for a in args], cmd, cmd.min_db,
                             cmd.max_db)
        cmd.load()(sub, cmd)

    run("createtsv", [seq_db, seq_db, clu, out_prefix + "_cluster.tsv"])

    # representative sequences as FASTA
    rep_db = wf.path("rep")
    wf.step(rep_db, "result2repseq", [seq_db, clu, rep_db], par)
    _db_to_fasta(seq_db, rep_db, out_prefix + "_rep_seq.fasta")
    _all_seqs_fasta(seq_db, clu, out_prefix + "_all_seqs.fasta")

    if par.remove_tmp_files:
        wf.cleanup(True)
    log.info(f"Wrote {out_prefix}_cluster.tsv, {out_prefix}_rep_seq.fasta, "
             f"{out_prefix}_all_seqs.fasta")
    return 0


def _db_to_fasta(seq_db_path, sub_db_path, out_path):
    hdr = DBReader(seq_db_path + "_h")
    sub = DBReader(sub_db_path)
    with open(out_path, "wb") as f:
        for i in range(sub.size):
            key = sub.get_db_key(i)
            f.write(b">" + hdr.get_data(hdr.get_id(key)))
            f.write(sub.get_data(i))
    hdr.close()
    sub.close()


def _all_seqs_fasta(seq_db_path, clu_path, out_path):
    from .common import fast_atoi
    seq = DBReader(seq_db_path)
    hdr = DBReader(seq_db_path + "_h")
    clu = DBReader(clu_path)
    with open(out_path, "wb") as f:
        for i in range(clu.size):
            rep = clu.get_db_key(i)
            rep_hdr = hdr.get_data(hdr.get_id(rep))
            f.write(b">" + rep_hdr.split(b"\n")[0].split(b" ")[0] + b"\n")
            for line in clu.get_data(i).split(b"\n"):
                if not line:
                    continue
                key = fast_atoi(line)
                f.write(b">" + hdr.get_data(hdr.get_id(key)))
                f.write(seq.get_data(seq.get_id(key)))
    for r in (seq, hdr, clu):
        r.close()


def easy_cluster(par, command):
    return _easy(par, command, "cluster")


def easy_linclust(par, command):
    return _easy(par, command, "linclust")
