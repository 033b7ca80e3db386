"""`filterdb`: per-entry line filtering/transformation over result DBs.

Full port of the reference's mode set (src/util/filterdb.cpp:124-565):
regex (default), file membership (plain file or DB), value mapping,
first-N-lines, numeric comparison, entry sorting (inc/dec/shuffle/priority),
beats-first, join-db, and tinyexpr-style expression filtering; modifiers
--trim-to-one-column and --include-identity. Several reference workflows
(taxonomy top-hit band, sliced profile search, multihitdb) depend on these.
"""

import os
import random
import re

from ..db.reader import DBReader
from ..db.writer import DBWriter
from ..utils import log
from .common import fast_atoi

REGEX_FILTERING = 0
FILE_FILTERING = 1
FILE_MAPPING = 2
GET_FIRST_LINES = 3
NUMERIC_COMPARISON = 4
SORT_ENTRIES = 5
BEATS_FIRST = 6
JOIN_DB = 7
EXPRESSION_FILTERING = 10

INCREASING, DECREASING, SHUFFLE, PRIORITY = 1, 2, 3, 4

_POSIX_CLASSES = {
    "[:digit:]": "0-9", "[:alpha:]": "a-zA-Z", "[:alnum:]": "a-zA-Z0-9",
    "[:space:]": r" \t\r\n\v\f", "[:upper:]": "A-Z", "[:lower:]": "a-z",
}


def _compile_posix(pattern: str):
    for k, v in _POSIX_CLASSES.items():
        pattern = pattern.replace(k, v)
    return re.compile(pattern)


def _column_value(line: bytes, column: int) -> bytes:
    parts = line.split()
    if len(parts) < column:
        log.die(f"Column={column} does not exist in line {line!r}")
    return parts[column - 1]


class _Expression:
    """Minimal tinyexpr-equivalent: arithmetic/comparison over $N column
    variables (reference ExpressionParser + lib/tinyexpr)."""

    _TOKEN = re.compile(r"\$(\d+)")

    def __init__(self, expr: str):
        self.cols = sorted({int(m) for m in self._TOKEN.findall(expr)})
        py = self._TOKEN.sub(lambda m: f"_c[{int(m.group(1))}]", expr)
        py = py.replace("&&", " and ").replace("||", " or ").replace(
            "^", "**")
        if not re.fullmatch(r"[\w\s\.\+\-\*/%<>=!()\[\],_]*", py):
            log.die(f"Unsupported filter expression: {expr}")
        self._code = compile(py, "<filter-expression>", "eval")

    def evaluate(self, parts) -> float:
        _c = {}
        for c in self.cols:
            try:
                _c[c] = float(parts[c])
            except (IndexError, ValueError):
                log.warning(f"Can not parse column {c}!")
                _c[c] = 0.0
        return float(eval(self._code, {"__builtins__": {}}, {"_c": _c}))


def filterdb(par, command):
    in_path, out_path = par.filenames[:2]
    column = par.filter_column
    trim = par.trim_to_one_column

    mode = REGEX_FILTERING
    regex = None
    filter_set = None
    mapping = None
    helper = None
    expr = None
    rng = random.Random()
    if par.sort_entries != 0:
        mode = SORT_ENTRIES
        weights = {}
        if par.sort_entries == PRIORITY:
            if not par.weights:
                log.die("Weights file (--weights) must be specified for "
                        "priority sorting.")
            with open(par.weights) as f:
                for line in f:
                    parts = line.split()
                    if len(parts) >= 2:
                        weights[int(parts[0])] = float(parts[1])
    elif par.filter_file:
        mode = FILE_FILTERING
        names = [par.filter_file]
        if (not os.path.exists(par.filter_file)
                and os.path.exists(par.filter_file + ".dbtype")):
            names = [par.filter_file]
        filter_set = set()
        for name in names:
            if os.path.exists(name):
                with open(name, "rb") as f:
                    for line in f:
                        key = line.split()[0] if line.split() else b""
                        if key:
                            filter_set.add(key.replace(b"\0", b""))
            else:
                with DBReader(name) as r:
                    for i in range(r.size):
                        for line in r.get_data(i).split(b"\n"):
                            tok = line.split()
                            if tok:
                                filter_set.add(tok[0])
    elif par.mapping_file:
        mode = FILE_MAPPING
        mapping = {}
        with open(par.mapping_file, "rb") as f:
            for line in f:
                parts = line.rstrip(b"\n").split(b"\t")
                if len(parts) >= 2:
                    mapping.setdefault(parts[0], []).append(parts[1])
    elif par.extract_lines > 0:
        mode = GET_FIRST_LINES
    elif par.join_db:
        mode = JOIN_DB
        helper = DBReader(par.join_db)
    elif par.beats_first:
        mode = BEATS_FIRST
    elif par.comparison_operator:
        mode = NUMERIC_COMPARISON
    elif par.filter_expression:
        mode = EXPRESSION_FILTERING
        expr = _Expression(par.filter_expression)
    else:
        mode = REGEX_FILTERING
        regex = _compile_posix(par.filter_regex)

    op = par.comparison_operator
    comp_value = par.comparison_value
    reader = DBReader(in_path)
    writer = DBWriter(out_path, reader.base_type, reader.extended_type)
    include_identity = par.include_identity

    for i in range(reader.size):
        query_key = reader.get_db_key(i)
        out_lines = []
        to_sort = []
        counter = 0
        reference_value = 0.0
        for line in reader.get_data(i).split(b"\n"):
            if not line:
                continue
            add_self = include_identity and fast_atoi(
                line.split(b"\t", 1)[0]) == query_key
            counter += 1
            colval = b""
            if mode != GET_FIRST_LINES or trim:
                colval = _column_value(line, column)

            nomatch = 0
            out_line = line
            if mode == GET_FIRST_LINES:
                nomatch = int(counter > par.extract_lines)
            elif mode == NUMERIC_COMPARISON:
                v = float(colval or 0)
                if op == "ge":
                    nomatch = int(not v >= comp_value)
                elif op == "le":
                    nomatch = int(not v <= comp_value)
                elif op == "e":
                    nomatch = int(not v == comp_value)
            elif mode == EXPRESSION_FILTERING:
                parts = [b""] + line.split()
                nomatch = int(expr.evaluate(parts) == 0)
            elif mode == REGEX_FILTERING:
                nomatch = int(regex.search(colval.decode()) is None)
            elif mode == JOIN_DB:
                jid = helper.get_id(fast_atoi(colval))
                if jid >= 0:
                    joined = helper.get_data(jid)
                    if par.column_to_take != -1:
                        # --column-to-take: append just one column of the
                        # joined entry (filterdb.cpp:383-395)
                        parts_j = joined.split()
                        joined = (parts_j[par.column_to_take] + b"\n"
                                  if par.column_to_take < len(parts_j)
                                  else b"\n")
                    out_line = line + b"\t" + joined
                    nomatch = 0
                else:
                    nomatch = 1
            elif mode == BEATS_FIRST:
                if counter == 1:
                    reference_value = float(colval or 0)
                else:
                    v = float(colval or 0)
                    if op == "ge":
                        nomatch = int(not v >= reference_value)
                    elif op == "le":
                        nomatch = int(not v <= reference_value)
                    elif op == "e":
                        nomatch = int(not v == reference_value)
                    elif op == "ip":
                        nomatch = int(not v >= reference_value * comp_value)
                    elif op == "op":
                        nomatch = int(not v <= reference_value * comp_value)
                    elif op == "ep":
                        nomatch = int(not v == reference_value * comp_value)
            elif mode == FILE_FILTERING:
                present = colval in filter_set
                nomatch = int(present != bool(par.positive_filter))
            elif mode == FILE_MAPPING:
                vals = mapping.get(colval)
                nomatch = 1
                if vals:
                    nomatch = 0
                    parts = line.split(b"\t")
                    repl = []
                    for v in vals:
                        newparts = parts[:column - 1] + [v] \
                            + parts[column:]
                        repl.append(b"\t".join(newparts))
                    out_line = b"\n".join(repl)
            elif mode == SORT_ENTRIES:
                if par.sort_entries == PRIORITY:
                    key = fast_atoi(colval)
                    to_sort.append((weights.get(key, 0.0), line))
                else:
                    to_sort.append((float(colval or 0), line))
                nomatch = 1

            if add_self:
                nomatch = 0
            if not nomatch:
                out_lines.append(colval if trim else out_line)

        if mode == SORT_ENTRIES:
            if par.sort_entries == INCREASING:
                to_sort.sort(key=lambda x: x[0])
            elif par.sort_entries in (DECREASING, PRIORITY):
                to_sort.sort(key=lambda x: -x[0])
            elif par.sort_entries == SHUFFLE:
                rng.shuffle(to_sort)
            out_lines = [x[1] for x in to_sort]

        payload = b"".join(x + b"\n" for x in out_lines)
        writer.write(query_key, payload)
    writer.close()
    if helper is not None:
        helper.close()
    return 0
