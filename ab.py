#!/usr/bin/env python3
"""A/B of the port on one CUDA card: the same work on several checkouts.

    python3 ab.py WHAT TREE [TREE ...]

WHAT is one of
  rescore  chip_smoke.py's phase-3 cases of diag_rescore and, where the
           tree has it, diag_rescore_profile (phase_rescore_kernel and
           phase_rescore_profile_kernel; the valid count is passed only
           where the tree's diag_rescore takes one);
  expand   its phase-3 cases of posting_expand (phase_expand_kernel);
  fwbw     its phase-3 cases of B5 (phase_fwbw_kernel), then a batch run
           of phase 14's shape: 50 queries of phase 5's lengths, 300
           targets each, in `fwbw`'s batches of consecutive queries (up to
           fwbw_cmd.BATCH_CELLS cells), B5's device ms summed over the
           batches (a `fwbw-path` line; unrelated pairs, as most of a
           prefilter list is; timed only: phase 14 holds the records);
  fwbw-forms
           B5 on batches of 32 to 512 related pairs of phase 3's
           commonest lengths and of 512 x 512, each timed with the warp
           form up to 512 query residues and up to 256 (a longer query a
           block of two warps or more), to find where more warps a pair
           pay (`fwbw-forms` lines; timed only);
  search   phase 6's easy-search, 1,000 queries against 50,000
           SwissProt-like targets from the script's seed (make_scale_data).
The kernel cases use the same seeded inputs for every tree, each held
against the plain version and timed on the card by device_ms. For search,
the score tables' disk cache is filled before the first run and each
tree's kernels and native helper are built before its clock starts, so no
run pays for a build; it fails unless every run wrote the same lines for
every query.

Each TREE runs in a process of its own, in the order given. A TREE is a
checkout of the repository, such as an older commit unpacked by `git
archive` into a git-ignored directory; `parent . . parent` compares two
versions on one card and host. Prints the card's line, then per run an
`ab WHAT tree` line and chip_smoke.py's case lines (`rescore-case`,
`rescore-profile-case`, `expand-case`, `fwbw-case` and `fwbw-path`) or a
`search-ab` line: the wall,
the seconds of each step, and the prefilter's own (index build, stage-0
worker sum, dispatch, wait, write, flushes)."""

import importlib
import inspect
import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

import chip_smoke

N_QUERIES = 1_000


def import_tree(tree):
    """The package of `tree`, checked to be that tree's."""
    sys.path.insert(0, tree)
    pkg = importlib.import_module("mmseqs2_tpu_torch")
    if not pkg.__file__.startswith(tree + "/"):
        raise RuntimeError(f"imported {pkg.__file__}, not {tree}'s package")


def run_rescore(tree, out):
    from mmseqs2_tpu_torch.ops import kernels, rescore
    kernels.build("rescore")
    counted = "n_valid" in inspect.signature(rescore.diag_rescore).parameters
    chip_smoke.phase_rescore_kernel(
        np.random.default_rng(chip_smoke.SEED),
        counts=(False, True) if counted else (False,))
    if hasattr(rescore, "diag_rescore_profile"):
        chip_smoke.phase_rescore_profile_kernel()


def run_expand(tree, out):
    from mmseqs2_tpu_torch.ops import kernels
    kernels.build("expand")
    chip_smoke.phase_expand_kernel()


def run_search(tree, out):
    import torch
    from mmseqs2_tpu_torch.commands import prefilter_kmer
    from mmseqs2_tpu_torch.ops import banded, kernels
    from mmseqs2_tpu_torch.workflow import engine
    # the tree's kernels and its native backtrace helper are built before
    # the clock starts: a build is no part of the search
    for src in sorted(kernels.CSRC.glob("*.cu")):
        kernels.build(src.stem)
    if banded._native_lib() is None:
        raise RuntimeError(f"{tree}: the native backtrace helper did not "
                           f"build")
    out = pathlib.Path(out)
    prefilter_kmer.reset_stats()
    engine.STEP_SECONDS.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    chip_smoke.run_cli(["easy-search", chip_smoke.WORK / "queries.fasta",
                        chip_smoke.WORK / "targets.fasta", out / "es.m8",
                        out / "tmp"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps, pst = dict(engine.STEP_SECONDS), dict(prefilter_kmer.STATS)
    res = dict(tree=tree, wall_s=wall, queries_per_s=N_QUERIES / wall,
               steps_s=steps,
               prefilter=dict(
                   index_build_s=pst["index_s"],
                   stage0_worker_sum_s=pst["prep_s"],
                   dispatch_s=pst["dispatch_s"], wait_s=pst["wait_s"],
                   write_s=pst["write_s"], flushes=pst["flushes"],
                   hits=pst["hits"]))
    chip_smoke.log("search-ab " + json.dumps(res))


def run_fwbw(tree, out):
    import torch
    from mmseqs2_tpu_torch.commands.fwbw_cmd import BATCH_CELLS
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import fwbw as F
    from mmseqs2_tpu_torch.ops import kernels
    kernels.build("fwbw")
    chip_smoke.phase_fwbw_kernel()
    rng = np.random.default_rng(chip_smoke.SEED + 18)
    submat = get_submat("blosum62.out", 2.0, 0.0)
    mat = torch.from_numpy(np.asarray(submat.sub_matrix, np.float32)).cuda()
    n_q, per_q = 50, 300
    aa_idx = np.array([submat.aa2num[c] for c in chip_smoke.AA])

    def seqs(lens):
        return [aa_idx[rng.choice(20, size=int(n), p=chip_smoke.PBACK)]
                for n in lens]

    queries = seqs(chip_smoke.lengths(rng, n_q))
    targets = seqs(chip_smoke.lengths(rng, n_q * per_q))
    batches, lo, cells = [], 0, 0
    for q in range(n_q):
        need = len(queries[q]) * sum(
            len(t) for t in targets[q * per_q:(q + 1) * per_q])
        if q > lo and cells + need > BATCH_CELLS:
            batches.append((lo, q))
            lo, cells = q, 0
        cells += need
    batches.append((lo, n_q))
    ms, n_cells, bound = 0.0, 0, 0.0
    for a, b in batches:
        pq = np.repeat(np.arange(b - a), per_q)
        pairs = F.make_pairs(queries[a:b], targets[a * per_q:b * per_q], pq,
                             range(len(pq)), "cuda")
        ms += chip_smoke.device_ms(lambda: F.fwbw(pairs, mat), 3)
        n_cells += pairs.n_cells
        bound += chip_smoke.fwbw_bound_ms(pairs)[0]
        del pairs
        torch.cuda.empty_cache()
    chip_smoke.log("fwbw-path " + json.dumps(dict(
        tree=tree, pairs=n_q * per_q, batches=len(batches), cells=n_cells,
        ms=ms, gcells_per_s=n_cells / ms / 1e6, bound_ms=bound,
        bound_share=bound / ms)))


def run_fwbw_forms(tree, out):
    import torch
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.ops import fwbw as F
    from mmseqs2_tpu_torch.ops import kernels
    kernels.build("fwbw")
    rng = np.random.default_rng(chip_smoke.SEED + 19)
    submat = get_submat("blosum62.out", 2.0, 0.0)
    mat = torch.from_numpy(np.asarray(submat.sub_matrix, np.float32)).cuda()
    for n in (32, 64, 128, 192, 256, 384, 512):
        for label, shapes in (
                ("commonest", rng.integers(250, 351, size=(n, 2))),
                ("512x512", np.full((n, 2), 512))):
            qs, ts = chip_smoke.related_pairs(rng, submat, shapes)
            pairs = F.make_pairs(qs, ts, range(n), range(n), "cuda")
            ql, tl = pairs.q_len.cpu().numpy(), pairs.t_len.cpu().numpy()
            row = dict(tree=tree, case=label, pairs=n)
            for cols in (512, 256):
                F.WARP_COLS, default = cols, F.WARP_COLS
                pairs.plan = F.launch_plan(ql, tl, "cuda")
                F.WARP_COLS = default
                row[f"warp_cols_{cols}"] = dict(
                    ms=chip_smoke.device_ms(lambda: F.fwbw(pairs, mat), 7),
                    forms=pairs.plan.forms())
            chip_smoke.log("fwbw-forms " + json.dumps(row))


RUNS = {"rescore": run_rescore, "expand": run_expand, "search": run_search,
        "fwbw": run_fwbw, "fwbw-forms": run_fwbw_forms}


def warm_score_tables():
    """The k-mer generator's score tables, computed once into their disk
    cache (every later process maps them)."""
    from mmseqs2_tpu_torch.data.submat import get_submat
    from mmseqs2_tpu_torch.prefilter.kmer_generator import SubKmerScores
    seed = get_submat("VTML80.out", 8.0, -0.2)
    alpha = seed.alphabet_size - 1
    for k in (3, 2):
        SubKmerScores(seed.sub_matrix, alpha, k).attach_disk_cache()


def main(argv):
    if argv[:1] == ["--tree"] and len(argv) == 4:
        _, what, tree, out = argv
        import_tree(tree)
        RUNS[what](tree, out)
        return 0
    if len(argv) < 2 or argv[0] not in RUNS:
        print(__doc__, file=sys.stderr)
        return 2
    what, trees = argv[0], argv[1:]
    chip_smoke.log(f"card: {chip_smoke.card_line()}")
    search = what == "search"
    if search:
        chip_smoke.WORK.mkdir(exist_ok=True)
        chip_smoke.make_scale_data(np.random.default_rng(chip_smoke.SEED),
                                   chip_smoke.N_TARGETS, N_QUERIES)
        warm_score_tables()
    outs = []
    for i, tree in enumerate(trees):
        tree = str(pathlib.Path(tree).resolve())
        chip_smoke.log(f"ab {what} tree {tree}")
        out = chip_smoke.WORK / f"search_ab_{i}"
        if search:
            out.mkdir(exist_ok=True)
        # search runs each tree with only its own package on the path
        env = dict(os.environ, PYTHONPATH="") if search else None
        subprocess.run([sys.executable, __file__, "--tree", what, tree,
                        str(out)], check=True, timeout=1200, env=env)
        if search:
            outs.append(chip_smoke.m8_by_query(out / "es.m8"))
    if not search:
        return 0
    same = all(o == outs[0] for o in outs)
    chip_smoke.log(f"search-ab results identical across runs: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
