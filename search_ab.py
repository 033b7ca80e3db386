#!/usr/bin/env python3
"""A/B of the main path (easy-search) on one CUDA card.

    python3 search_ab.py TREE [TREE ...]

Runs phase 6's easy-search of chip_smoke.py, 1,000 queries against 50,000
SwissProt-like targets from the script's seed (make_scale_data), on the
package of each TREE, in the order given, each in a process of its own.
A TREE is a checkout of the repository, such as an older commit unpacked
by `git archive` into a git-ignored directory; `parent . . parent`
compares two versions on one card and host. The score tables' disk cache
is filled before the first run, and each tree's kernels and native
helper are built before its clock starts, so no run pays for a build. Prints the card's
line, then per run a `search-ab` line: the wall, the seconds of each
step, and the prefilter's own (index build, stage-0 worker sum, dispatch,
wait, write, flushes). Fails unless every run wrote the same lines for
every query."""

import json
import os
import pathlib
import subprocess
import sys
import time

import numpy as np

import chip_smoke

N_QUERIES = 1_000


def run_tree(tree, out):
    """easy-search on the package of `tree` into `out`; prints its line."""
    sys.path.insert(0, tree)
    import mmseqs2_tpu_torch
    if not mmseqs2_tpu_torch.__file__.startswith(tree + "/"):
        raise RuntimeError(f"imported {mmseqs2_tpu_torch.__file__}, not "
                           f"{tree}'s package")
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
    if argv[:1] == ["--tree"] and len(argv) == 3:
        run_tree(argv[1], argv[2])
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    chip_smoke.log(f"card: {chip_smoke.card_line()}")
    chip_smoke.WORK.mkdir(exist_ok=True)
    chip_smoke.make_scale_data(np.random.default_rng(chip_smoke.SEED),
                               chip_smoke.N_TARGETS, N_QUERIES)
    warm_score_tables()
    outs = []
    for i, tree in enumerate(argv):
        tree = str(pathlib.Path(tree).resolve())
        out = chip_smoke.WORK / f"search_ab_{i}"
        out.mkdir(exist_ok=True)
        subprocess.run([sys.executable, __file__, "--tree", tree, str(out)],
                       check=True, timeout=900,
                       env=dict(os.environ, PYTHONPATH=""))
        outs.append(chip_smoke.m8_by_query(out / "es.m8"))
    same = all(o == outs[0] for o in outs)
    chip_smoke.log(f"search-ab results identical across runs: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
