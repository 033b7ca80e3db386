"""NCBI taxonomy tree + per-sequence taxon mapping.

Port of mmseqs2_tpu/taxonomy/ncbi.py (host code).

Reference: src/taxonomy/NcbiTaxonomy.cpp (dmp parsing, LCA, ranks,
lineages, weighted majority LCA), MappingReader.h (text `<db>_mapping`
with two sorted columns). The binary `<db>_taxonomy` serialization is not
read; databases created with --tax-db-mode 0 (dmp files kept) work.
"""

import os
import struct

import numpy as np

from ..utils import log

NCBI_RANKS = {
    "forma": 1, "varietas": 2, "subspecies": 3, "species": 4,
    "species subgroup": 5, "species group": 6, "subgenus": 7, "genus": 8,
    "subtribe": 9, "tribe": 10, "subfamily": 11, "family": 12,
    "superfamily": 13, "parvorder": 14, "infraorder": 15, "suborder": 16,
    "order": 17, "superorder": 18, "infraclass": 19, "subclass": 20,
    "class": 21, "superclass": 22, "subphylum": 23, "phylum": 24,
    "superphylum": 25, "subkingdom": 26, "kingdom": 27, "superkingdom": 28,
}

SHORT_RANKS = {
    "species": "s", "genus": "g", "family": "f", "order": "o",
    "class": "c", "phylum": "p", "kingdom": "k", "superkingdom": "d",
}

ROOT_TAXID = 1
ROOT_RANK = 1 << 31
MAX_TAX_WEIGHT = 1000.0


def find_rank_index(rank: str) -> int:
    return NCBI_RANKS.get(rank, -1)


def find_short_rank(rank: str) -> str:
    return SHORT_RANKS.get(rank, "-")


def parse_ranks(ranks: str):
    out = [r for r in ranks.split(",") if r]
    for r in out:
        if find_rank_index(r) == -1:
            log.die(f"Invalid taxonomic rank {r}given")
    return out


class TaxonNode:
    __slots__ = ("tax_id", "parent_tax_id", "rank", "name")

    def __init__(self, tax_id, parent_tax_id, rank, name=""):
        self.tax_id = tax_id
        self.parent_tax_id = parent_tax_id
        self.rank = rank
        self.name = name


class NcbiTaxonomy:
    def __init__(self, names_file: str, nodes_file: str, merged_file: str):
        self.nodes = {}
        with open(nodes_file) as f:
            for line in f:
                parts = line.split("\t|\t")
                tax_id = int(parts[0])
                parent = int(parts[1])
                rank = parts[2].strip()
                self.nodes[tax_id] = TaxonNode(tax_id, parent, rank)
        # merged.dmp: old -> new alias
        self.alias = {}
        if os.path.exists(merged_file):
            with open(merged_file) as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|") if p.strip()]
                    if len(parts) >= 2:
                        self.alias[int(parts[0])] = int(parts[1])
        with open(names_file) as f:
            for line in f:
                if "scientific name" not in line:
                    continue
                parts = line.split("\t|\t")
                tax_id = int(parts[0])
                if tax_id in self.nodes:
                    self.nodes[tax_id].name = parts[1]

    @classmethod
    def open_taxonomy(cls, db: str) -> "NcbiTaxonomy":
        if os.path.exists(db + "_taxonomy"):
            return load_binary_taxonomy(db + "_taxonomy")
        for suf in ("_nodes.dmp", "_names.dmp"):
            if not os.path.exists(db + suf):
                log.die(f"Missing taxonomy file {db}{suf}")
        return cls(db + "_names.dmp", db + "_nodes.dmp", db + "_merged.dmp")

    def _resolve(self, tax_id: int):
        if tax_id in self.nodes:
            return tax_id
        return self.alias.get(tax_id)

    def node_exists(self, tax_id: int) -> bool:
        return self._resolve(tax_id) is not None

    def taxon_node(self, tax_id: int):
        r = self._resolve(tax_id)
        return self.nodes.get(r) if r is not None else None

    def _depth(self, tax_id: int) -> int:
        d = 0
        node = self.nodes[tax_id]
        while node.parent_tax_id != node.tax_id:
            node = self.nodes[self._resolve(node.parent_tax_id)]
            d += 1
        return d

    def lca_pair(self, a: int, b: int) -> int:
        da, db = self._depth(a), self._depth(b)
        na, nb = self.nodes[a], self.nodes[b]
        while da > db:
            na = self.nodes[self._resolve(na.parent_tax_id)]
            da -= 1
        while db > da:
            nb = self.nodes[self._resolve(nb.parent_tax_id)]
            db -= 1
        while na.tax_id != nb.tax_id:
            na = self.nodes[self._resolve(na.parent_tax_id)]
            nb = self.nodes[self._resolve(nb.parent_tax_id)]
        return na.tax_id

    def lca(self, taxa):
        """LCA over a list, skipping unknown IDs (NcbiTaxonomy::LCA)."""
        red = None
        for t in taxa:
            r = self._resolve(t)
            if r is None:
                log.warning(f"No node for taxID {t}, ignoring it.")
                continue
            red = r if red is None else self.lca_pair(red, r)
        return self.nodes.get(red) if red is not None else None

    def is_ancestor(self, ancestor: int, child: int) -> bool:
        a = self._resolve(ancestor)
        c = self._resolve(child)
        if a is None or c is None:
            return False
        node = self.nodes[c]
        while True:
            if node.tax_id == a:
                return True
            if node.parent_tax_id == node.tax_id:
                return False
            node = self.nodes[self._resolve(node.parent_tax_id)]

    def all_ranks(self, node: TaxonNode):
        result = {}
        while True:
            if node.tax_id == 1:
                result.setdefault(node.rank, node.name)
                return result
            if node.rank not in ("no_rank", "no rank"):
                result.setdefault(node.rank, node.name)
            node = self.nodes[self._resolve(node.parent_tax_id)]

    def at_ranks(self, node: TaxonNode, levels):
        result = []
        allr = self.all_ranks(node)
        base_rank_index = find_rank_index(node.rank)
        base_rank = "uc_" + node.name
        for lv in levels:
            if lv in allr:
                result.append(allr[lv])
            elif NCBI_RANKS[lv] < base_rank_index:
                result.append(base_rank)
            else:
                result.append("unknown")
        return result

    def tax_lineage(self, node: TaxonNode, info_as_name: bool) -> str:
        chain = []
        while True:
            chain.append(node)
            parent = self.nodes[self._resolve(node.parent_tax_id)]
            if parent.parent_tax_id == parent.tax_id:
                break
            node = parent
        parts = []
        for n in reversed(chain):
            if info_as_name:
                parts.append(find_short_rank(n.rank) + "_" + n.name)
            else:
                parts.append(str(n.tax_id))
        return ";".join(parts)

    # -- weighted majority LCA (NcbiTaxonomy.cpp:622-760) --------------------

    def weighted_majority_lca(self, weighted_taxa, majority_cutoff: float):
        # counts: taxid -> [weight, is_candidate, last_child]; a node is a
        # candidate when hit directly OR reached via two different children
        # (TaxNode::update, NcbiTaxonomy.cpp:577-592)
        counts = {}
        assigned = 0
        unassigned = 0
        total_weight = 0.0

        def update(tax, w, child, direct):
            e = counts.get(tax)
            if e is None:
                counts[tax] = [w, direct, child]
            else:
                if e[2] != child:
                    e[1] = True
                    e[2] = child
                e[0] += w

        for taxon, weight in weighted_taxa:
            if taxon == 0 or self._resolve(taxon) is None:
                unassigned += 1
                continue
            total_weight += weight
            assigned += 1
            cur = self._resolve(taxon)
            update(cur, weight, 0, True)
            node = self.nodes[cur]
            while node.parent_tax_id != node.tax_id:
                parent = self._resolve(node.parent_tax_id)
                update(parent, weight, cur, False)
                cur = parent
                node = self.nodes[parent]
        if total_weight == 0:
            return 0, assigned, unassigned, 0, 0.0
        selected = 0
        min_rank = ROOT_RANK
        selected_percent = 0.0
        for tax_id in sorted(counts):
            weight, is_cand = counts[tax_id][0], counts[tax_id][1]
            if not is_cand:
                continue
            percent = weight / total_weight
            if percent >= majority_cutoff:
                node = self.nodes[tax_id]
                cur_min_rank = ROOT_RANK
                while node.parent_tax_id != node.tax_id:
                    ri = find_rank_index(node.rank)
                    if ri > 0:
                        cur_min_rank = ri
                        break
                    node = self.nodes[self._resolve(node.parent_tax_id)]
                if cur_min_rank < min_rank or (cur_min_rank == min_rank
                                               and percent
                                               > selected_percent):
                    selected = tax_id
                    min_rank = cur_min_rank
                    selected_percent = percent
        if selected == ROOT_TAXID:
            return selected, assigned, unassigned, assigned, selected_percent
        if selected == 0:
            return 0, assigned, unassigned, 0, selected_percent
        agree = 0
        for taxon, _ in weighted_taxa:
            if taxon == 0 or self._resolve(taxon) is None:
                continue
            if self.is_ancestor(selected, taxon):
                agree += 1
        return selected, assigned, unassigned, agree, selected_percent

    def get_clade_counts(self, taxon_counts: dict):
        clade = {}     # taxid -> [clade_count, tax_count, children list]

        def entry(t):
            return clade.setdefault(t, [0, 0, []])

        for start, count in taxon_counts.items():
            e = entry(start)
            e[1] = count
            e[0] += count
            r = self._resolve(start)
            if r is None:
                continue
            child = r
            node = self.nodes[r]
            while (node.parent_tax_id != node.tax_id
                   and self._resolve(node.parent_tax_id) is not None):
                parent = self._resolve(node.parent_tax_id)
                node = self.nodes[parent]
                pe = entry(parent)
                pe[0] += count
                if child not in pe[2]:
                    pe[2].append(child)
                child = parent
        return clade


class MappingReader:
    """Text `<db>_mapping` (key \\t taxid, sorted by key)."""

    def __init__(self, db: str, db_input: bool = True):
        path = (db + "_mapping") if db_input else db
        if not os.path.exists(path):
            log.die(f"{db}_mapping does not exist. Please create the "
                    f"taxonomy mapping!")
        keys = []
        taxa = []
        with open(path, "rb") as f:
            head = f.read(8)
            f.seek(0)
            if head.startswith(b"TAXM"):
                log.die("Binary taxonomy mappings are not supported; "
                        "recreate with --tax-mapping-mode 0")
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    keys.append(int(parts[0]))
                    taxa.append(int(parts[1]))
        self.keys = np.array(keys, dtype=np.int64)
        self.taxa = np.array(taxa, dtype=np.int64)
        order = np.argsort(self.keys, kind="stable")
        self.keys = self.keys[order]
        self.taxa = self.taxa[order]

    def lookup(self, key: int) -> int:
        i = int(np.searchsorted(self.keys, key))
        if i < len(self.keys) and self.keys[i] == key:
            return int(self.taxa[i])
        return 0


class TaxonomyExpression:
    """--taxon-list filter (TaxonomyExpression.h): a plain taxid means
    is-ancestor; expressions support !, &&, || and ',' as OR."""

    def __init__(self, expression: str, taxonomy: NcbiTaxonomy,
                 comma_is: str = "or"):
        self.t = taxonomy
        self.expr = None
        self.single = None
        e = expression.strip()
        if e.lstrip("-").isdigit():
            self.single = int(e)
            return
        joined = {"or": " or ", "and": " and "}.get(comma_is, ",")
        e = e.replace("&&", " and ").replace("||", " or ")
        e = e.replace("!", " not ")
        e = e.replace(",", joined)
        import re
        e = re.sub(r"(\d+)", r"A(\1)", e)
        self.expr = compile(e, "<taxon-list>", "eval")

    def is_ancestor(self, taxon: int) -> bool:
        if self.single is not None:
            return self.t.is_ancestor(self.single, taxon)
        return bool(eval(self.expr, {"__builtins__": {}},
                         {"A": lambda a: self.t.is_ancestor(a, taxon)}))


# -- binary taxonomy serialization (NcbiTaxonomy.cpp:752-827) -------------------

_SERIALIZATION_VERSION = 2
_NODE_DTYPE = np.dtype([("id", "<i4"), ("taxId", "<i4"),
                        ("parentTaxId", "<i4"), ("_pad", "<i4"),
                        ("rankIdx", "<u8"), ("nameIdx", "<u8")])


def _flog2(x: int) -> int:
    return max(x.bit_length() - 1, 0)


def serialize_taxonomy(names_file: str, nodes_file: str,
                       merged_file: str) -> bytes:
    """Build the reference's `<db>_taxonomy` binary (version 2): header,
    TaxonNode array, D taxid->node map, Euler tour E/L/H, RMQ sparse table
    M, and the compacted string block (NcbiTaxonomy::serialize,
    NcbiTaxonomy.cpp:752-793 + StringBlock.h:58-113)."""
    strings = []          # StringBlock entries in append order

    def append_str(s: str) -> int:
        strings.append(s.encode())
        return len(strings) - 1

    def split_dmp(line: str, max_col: int):
        # splitByDelimiter (NcbiTaxonomy.cpp:91-104): the last column keeps
        # any trailing "\t|" when the line has no further delimiter
        out = []
        prev = 0
        i = 0
        while True:
            pos = line.find("\t|\t", prev)
            if pos == -1:
                pos = len(line)
            out.append(line[prev:pos])
            prev = pos + 3
            i += 1
            if not (pos < len(line) and prev < len(line) and i < max_col):
                return out

    tax_ids, parents, rank_idx = [], [], []
    max_tax_id = 0
    with open(nodes_file) as f:
        for line in f:
            parts = split_dmp(line.rstrip("\n"), 3)
            tax_ids.append(int(parts[0]))
            parents.append(int(parts[1]))
            rank_idx.append(append_str(parts[2]))
            max_tax_id = max(max_tax_id, tax_ids[-1])
    n = len(tax_ids)
    id_of = {t: i for i, t in enumerate(tax_ids)}
    # merged: only ids absent from nodes mapping to present ids
    merged = {}
    if os.path.exists(merged_file):
        with open(merged_file) as f:
            for line in f:
                parts = [p.strip() for p in line.split("|") if p.strip()]
                if len(parts) >= 2:
                    old, new = int(parts[0]), int(parts[1])
                    if old not in id_of and new in id_of:
                        merged[old] = new
                        max_tax_id = max(max_tax_id, old, new)
    name_idx = [0xFFFFFFFFFFFFFFFF] * n
    with open(names_file) as f:
        for line in f:
            if "scientific name" not in line:
                continue
            parts = split_dmp(line.rstrip("\n"), 2)
            t = int(parts[0])
            if t in id_of:
                name_idx[id_of[t]] = append_str(parts[1])
    D = np.full(max_tax_id + 1, -1, dtype=np.int32)
    for t, i in id_of.items():
        D[t] = i
    for old, new in merged.items():
        D[old] = id_of[new]
    # Euler tour (NcbiTaxonomy::elh)
    children = [[] for _ in range(n)]
    for i, t in enumerate(tax_ids):
        if parents[i] != t:
            children[D[parents[i]]].append(t)
    H = np.zeros(n, dtype=np.int32)
    E, L = [], []

    def elh(tax_id, level):
        # iterative DFS matching the recursive reference order
        stack = [(tax_id, level, 0)]
        while stack:
            t, lv, ci = stack.pop()
            i = D[t]
            if ci == 0:
                if H[i] == 0:
                    H[i] = len(E)
                E.append(int(i))
                L.append(lv)
            ch = children[i]
            if ci < len(ch):
                stack.append((t, lv, ci + 1))
                stack.append((ch[ci], lv + 1, 0))
            else:
                E.append(int(D[parents[i]]))
                L.append(lv - 1)

    elh(ROOT_TAXID, 0)
    E = np.array((E + [0] * (2 * n))[:2 * n], dtype=np.int32)
    L = np.array((L + [0] * (2 * n))[:2 * n], dtype=np.int32)
    # sparse table
    dim = 2 * n
    k = _flog2(dim) + 1
    M = np.zeros((dim, k), dtype=np.int32)
    M[:, 0] = np.arange(dim, dtype=np.int32)
    col = 1
    while (1 << col) <= dim:
        half = 1 << (col - 1)
        span = 1 << col
        rows = dim - span + 1
        a = M[:rows, col - 1]
        b = M[half:half + rows, col - 1]
        M[:rows, col] = np.where(L[a] < L[b], a, b)
        col += 1
    # compact string block (StringBlock::compact): lexicographic sort,
    # dedup, re-layout in sorted order
    order = sorted(range(len(strings)), key=lambda i: strings[i])
    new_off = [0] * len(strings)
    data = bytearray()
    prev = None
    for i in order:
        s = strings[i]
        if prev is not None and s == strings[prev]:
            new_off[i] = new_off[prev]
        else:
            new_off[i] = len(data)
            data += s + b"\0"
        prev = i
    nodes_arr = np.zeros(n, dtype=_NODE_DTYPE)
    nodes_arr["id"] = np.arange(n, dtype=np.int32)
    nodes_arr["taxId"] = tax_ids
    nodes_arr["parentTaxId"] = parents
    nodes_arr["rankIdx"] = rank_idx
    nodes_arr["nameIdx"] = name_idx
    out = bytearray()
    out += struct.pack("<i", _SERIALIZATION_VERSION)
    out += struct.pack("<Q", n)
    out += struct.pack("<i", max_tax_id)
    out += nodes_arr.tobytes()
    out += D.tobytes()
    out += E.tobytes()
    out += L.tobytes()
    out += H.tobytes()
    out += M.tobytes()
    out += struct.pack("<Q", len(data))          # byteCapacity
    out += struct.pack("<I", len(strings))       # entryCapacity (u32 T)
    out += struct.pack("<I", len(strings))       # entryCount
    out += bytes(data)
    out += np.array(new_off, dtype=np.uint32).tobytes()
    return bytes(out)


def load_binary_taxonomy(path: str) -> "NcbiTaxonomy":
    """Parse a reference `<db>_taxonomy` binary into an NcbiTaxonomy
    (NcbiTaxonomy::unserialize, NcbiTaxonomy.cpp:795-827)."""
    mem = open(path, "rb").read()
    off = 0
    version = struct.unpack_from("<i", mem, off)[0]
    off += 4
    if version != _SERIALIZATION_VERSION:
        log.die(f"Outdated taxonomy database {path} (version {version}); "
                f"recreate with createtaxdb")
    n = struct.unpack_from("<Q", mem, off)[0]
    off += 8
    max_tax_id = struct.unpack_from("<i", mem, off)[0]
    off += 4
    nodes_arr = np.frombuffer(mem, _NODE_DTYPE, n, off)
    off += n * _NODE_DTYPE.itemsize
    D = np.frombuffer(mem, np.int32, max_tax_id + 1, off)
    off += 4 * (max_tax_id + 1)
    off += 4 * (2 * n) * 2 + 4 * n          # skip E, L, H
    dim = 2 * n
    k = _flog2(dim) + 1
    off += 4 * dim * k                       # skip M
    byte_cap = struct.unpack_from("<Q", mem, off)[0]
    off += 8
    entry_cap = struct.unpack_from("<I", mem, off)[0]
    off += 4
    entry_count = struct.unpack_from("<I", mem, off)[0]
    off += 4
    data = mem[off:off + byte_cap]
    off += byte_cap
    offsets = np.frombuffer(mem, np.uint32, entry_cap, off)

    def get_str(idx):
        if idx >= entry_count:
            return ""
        start = int(offsets[idx])
        end = data.find(b"\0", start)
        return data[start:end].decode("utf-8", "replace")

    t = NcbiTaxonomy.__new__(NcbiTaxonomy)
    t.nodes = {}
    t.alias = {}
    for i in range(n):
        row = nodes_arr[i]
        nm = ("" if int(row["nameIdx"]) == 0xFFFFFFFFFFFFFFFF
              else get_str(int(row["nameIdx"])))
        t.nodes[int(row["taxId"])] = TaxonNode(
            int(row["taxId"]), int(row["parentTaxId"]),
            get_str(int(row["rankIdx"])), nm)
    tax_of_node = nodes_arr["taxId"]
    present = np.nonzero(D >= 0)[0]
    for tax in present.tolist():
        real = int(tax_of_node[D[tax]])
        if real != tax:
            t.alias[tax] = real
    return t
