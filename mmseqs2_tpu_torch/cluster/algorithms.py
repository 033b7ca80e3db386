"""Clustering algorithms: greedy set-cover, connected components, greedy
incremental — over a symmetrized similarity graph.

Reference: src/clustering/ClusteringAlgorithms.cpp (setCover :217, connected
component :95-124, greedyIncrementalLowMem :284) and
src/clustering/AlignmentSymmetry.cpp (edge reading :20-130, reverse-edge
completion :287-330). Semantics preserved exactly:
  - sequences ordered by (length desc, key asc); ties in priorities follow
    that local order (DBReader SORT_BY_LENGTH, DBReader.h:436-448)
  - scores: aln DB -> bit score (type 1) or seqId*1000 (type 2); prefilter
    DB -> |score|; cluster DB -> USHRT_MAX; u16 truncation as in the
    reference casts
  - missing reverse edges appended with the forward score
  - set-cover processes clusters from largest (counting-sort order, ties by
    local id asc); members move to a new representative only on strictly
    greater score; cluster sizes of affected sets decrease dynamically
  - connected component: BFS from largest sets with --max-iterations depth
  - greedy incremental: length-desc scan assigning unassigned members
"""

import numpy as np

USHRT_MAX = 65535

APC_ALIGNMENTSCORE = 1
APC_SEQID = 2


def length_order(keys: np.ndarray, entry_lens: np.ndarray):
    """Local ids: sort by entry length desc, then key asc."""
    order = np.lexsort((keys, -entry_lens))
    return order


def parse_edges(res_reader, seq_keys_sorted, key_to_lid, score_type: int):
    """Read the result DB into adjacency lists in local-id space.

    Returns (targets list-of-arrays, scores list-of-arrays) indexed by local
    id; empty entries become a self-edge with max score.
    """
    from ..db import dbtype as dbt
    alntype = res_reader.base_type
    n = len(seq_keys_sorted)
    targets = [None] * n
    scores = [None] * n
    for lid in range(n):
        key = int(seq_keys_sorted[lid])
        i = res_reader.get_id(key)
        data = res_reader.get_data(i) if i >= 0 else b""
        if not data:
            targets[lid] = np.array([lid], dtype=np.int64)
            scores[lid] = np.array([USHRT_MAX if (
                alntype != dbt.DBTYPE_ALIGNMENT_RES
                or score_type == APC_ALIGNMENTSCORE) else 1000],
                dtype=np.uint16)
            continue
        t_l, s_l = [], []
        for line in data.split(b"\n"):
            if not line:
                continue
            parts = line.split(b"\t")
            t_l.append(key_to_lid[int(parts[0])])
            if alntype == dbt.DBTYPE_ALIGNMENT_RES:
                if score_type == APC_ALIGNMENTSCORE:
                    s_l.append(np.uint16(int(float(parts[1]))))
                else:
                    s_l.append(np.uint16(
                        int(np.float32(float(parts[2])) * np.float32(1000))))
            elif alntype in (dbt.DBTYPE_PREFILTER_RES,
                             dbt.DBTYPE_PREFILTER_REV_RES):
                s_l.append(np.uint16(abs(int(parts[1])) & 0xFFFF))
            else:
                s_l.append(np.uint16(USHRT_MAX))
        targets[lid] = np.array(t_l, dtype=np.int64)
        scores[lid] = np.array(s_l, dtype=np.uint16)
    return targets, scores


def symmetrize(targets, scores):
    """addMissingLinks: append (v -> u, score(u,v)) when absent."""
    n = len(targets)
    # directed-edge presence
    src = np.concatenate([np.full(len(t), i, dtype=np.int64)
                          for i, t in enumerate(targets)]) \
        if n else np.zeros(0, np.int64)
    dst = np.concatenate(targets) if n else np.zeros(0, np.int64)
    have = set((int(a) * n + int(b)) for a, b in zip(src, dst))
    extra_t = [[] for _ in range(n)]
    extra_s = [[] for _ in range(n)]
    for u in range(n):
        tu = targets[u]
        su = scores[u]
        for p in range(len(tu)):
            v = int(tu[p])
            if (v * n + u) not in have:
                extra_t[v].append(u)
                extra_s[v].append(su[p])
                have.add(v * n + u)
    out_t, out_s = [], []
    for i in range(n):
        if extra_t[i]:
            out_t.append(np.concatenate(
                [targets[i], np.array(extra_t[i], dtype=np.int64)]))
            out_s.append(np.concatenate(
                [scores[i], np.array(extra_s[i], dtype=np.uint16)]))
        else:
            out_t.append(targets[i])
            out_s.append(scores[i])
    return out_t, out_s


def set_cover(targets, scores):
    """Greedy weighted set cover — faithful port of the reference's
    counting-sort + swap priority structure (tie order among equal sizes is
    defined by the swap history, not by id)."""
    n = len(targets)
    INVALID = -1
    clustersizes = np.array([len(t) for t in targets], dtype=np.int64)
    max_size = int(clustersizes.max()) if n else 0
    # initClustersizes: counting sort ascending by size, stable by id
    abundance = np.bincount(clustersizes, minlength=max_size + 1)
    borders = np.concatenate([[0], np.cumsum(abundance)[:-1]]).astype(
        np.int64)
    sorted_cs = np.zeros(n + 1, dtype=np.int64)
    pos_of = np.zeros(n + 1, dtype=np.int64)
    fill = borders.copy()
    for i in range(n):
        p = fill[clustersizes[i]]
        sorted_cs[p] = i
        pos_of[i] = p
        fill[clustersizes[i]] += 1

    assigned = np.full(n, INVALID, dtype=np.int64)
    best = np.full(n, np.iinfo(np.int16).min, dtype=np.int64)

    def remove(cid):
        clustersizes[cid] = 0
        sorted_cs[pos_of[cid]] = INVALID
        pos_of[cid] = INVALID

    def decrease(cid):
        oldp = pos_of[cid]
        newp = borders[clustersizes[cid]]
        swapid = sorted_cs[newp]
        if swapid != INVALID:
            pos_of[swapid] = oldp
        sorted_cs[oldp] = swapid
        sorted_cs[newp] = cid
        pos_of[cid] = newp
        borders[clustersizes[cid]] += 1
        clustersizes[cid] -= 1

    for cl_pos in range(n - 1, -1, -1):
        rep = int(sorted_cs[cl_pos])
        if rep == INVALID:
            continue
        remove(rep)
        assigned[rep] = rep
        members = targets[rep]
        mscores = scores[rep]
        for p in range(len(members)):
            m = int(members[p])
            sc = int(np.int16(mscores[p]))
            if sc > best[m]:
                assigned[m] = rep
                best[m] = sc
            if m == rep:
                continue
            if clustersizes[m] < 1:
                continue
            remove(m)
        for p in range(len(members)):
            m = int(members[p])
            if m == rep:
                clustersizes[m] = -1
                continue
            if clustersizes[m] < 0:
                continue
            clustersizes[m] = -1
            for q in targets[m]:
                qq = int(q)
                # the reference refuses to empty a size-1 set here (it
                # reports an inconsistency instead of decreasing)
                if clustersizes[qq] > 1:
                    decrease(qq)
    return assigned


def connected_component(targets, max_iterations: int):
    n = len(targets)
    sizes = np.array([len(t) for t in targets], dtype=np.int64)
    assigned = np.full(n, -1, dtype=np.int64)
    # counting-sort array scanned from the top: ties by LARGEST id first
    order = np.lexsort((-np.arange(n), -sizes))
    from collections import deque
    for rep in order:
        rep = int(rep)
        if assigned[rep] != -1:
            continue
        assigned[rep] = rep
        q = deque([(rep, 0)])
        while q:
            cur, depth = q.popleft()
            assigned[cur] = rep
            for e in targets[cur]:
                e = int(e)
                if assigned[e] == -1 and depth < max_iterations:
                    q.append((e, depth + 1))
                assigned[e] = rep
    return assigned


def greedy_incremental(res_reader, seq_keys_sorted, key_to_lid):
    n = len(seq_keys_sorted)
    assigned = np.full(n, -1, dtype=np.int64)
    for lid in range(n):
        if assigned[lid] != -1:
            continue
        key = int(seq_keys_sorted[lid])
        i = res_reader.get_id(key)
        data = res_reader.get_data(i) if i >= 0 else b""
        keys = [int(line.split(b"\t")[0]) for line in data.split(b"\n")
                if line]
        if len(keys) <= 1:
            continue
        for k in keys:
            m = key_to_lid.get(k)
            if m is not None and assigned[m] == -1:
                assigned[m] = lid
    missing = np.nonzero(assigned == -1)[0]
    assigned[missing] = missing
    return assigned
