"""`clust`: cluster a result DB (set-cover / connected-component / greedy).

Reference: src/clustering/Clustering.cpp (:179 run, writeData) — output is a
cluster DB: entry key = representative, data = member keys one per line
(representative first).
"""

from ..cluster import algorithms as alg
from ..db import dbtype as dbt
from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log

MODE_SET_COVER = 0
MODE_CONNECTED_COMPONENT = 1
MODE_GREEDY = 2
MODE_GREEDY_MEM = 3


def clust(par, command):
    seq_path, res_path, out_path = par.filenames[:3]
    seq = DBReader(seq_path)
    res = DBReader(res_path)

    # local ids follow (length desc, key asc) like SORT_BY_LENGTH
    order = alg.length_order(seq.keys, seq.lengths)
    keys_sorted = seq.keys[order]
    key_to_lid = {int(k): i for i, k in enumerate(keys_sorted)}

    mode = par.cluster_mode
    if mode in (MODE_GREEDY, MODE_GREEDY_MEM):
        log.info("Clustering mode: Greedy Low Mem")
        assigned = alg.greedy_incremental(res, keys_sorted, key_to_lid)
    else:
        targets, scores = alg.parse_edges(res, keys_sorted, key_to_lid,
                                          par.similarity_type)
        targets, scores = alg.symmetrize(targets, scores)
        if mode == MODE_CONNECTED_COMPONENT:
            log.info("Clustering mode: Connected Component")
            assigned = alg.connected_component(targets, par.max_iterations)
        else:
            log.info("Clustering mode: Set Cover")
            assigned = alg.set_cover(targets, scores)

    rep_keys = keys_sorted[assigned]
    member_keys = keys_sorted
    pairs = sorted(zip((int(k) for k in rep_keys),
                       (int(k) for k in member_keys)))
    n_clusters = len(set(p[0] for p in pairs))
    log.info(f"Number of clusters: {n_clusters}")

    writer = DBWriter(out_path, dbt.DBTYPE_CLUSTER_RES)
    cur_rep = None
    members = []
    for rep, member in pairs:
        if rep != cur_rep:
            if cur_rep is not None:
                writer.write(cur_rep, "".join(members).encode())
            cur_rep = rep
            members = [f"{rep}\n"]
        if member != rep:
            members.append(f"{member}\n")
    if cur_rep is not None:
        writer.write(cur_rep, "".join(members).encode())
    writer.close()
    seq.close()
    res.close()
    return 0
