#!/usr/bin/env python3
"""A/B of the diag_rescore kernel on one CUDA card.

    python3 rescore_ab.py TREE [TREE ...]

Runs chip_smoke.py's phase-3 rescore cases (phase_rescore_kernel: the same
seeded inputs for every tree, each case held against the plain version,
the kernel's time on the card by device_ms) on the package of each TREE, in
the order given, each in a process of its own. A TREE is a checkout of the
repository, such as an older commit unpacked by `git archive` into a
git-ignored directory; `parent . . parent` compares two versions on one
card. The valid count is passed only where the tree's diag_rescore takes
one. Prints the card's line, then per tree a `rescore-ab tree` line and
chip_smoke.py's `rescore-case` lines."""

import importlib
import inspect
import pathlib
import subprocess
import sys

import numpy as np

import chip_smoke


def run_tree(tree):
    """phase_rescore_kernel on the package of `tree`."""
    sys.path.insert(0, tree)
    pkg = importlib.import_module("mmseqs2_tpu_torch")
    if not pkg.__file__.startswith(tree + "/"):
        raise RuntimeError(f"imported {pkg.__file__}, not {tree}'s package")
    from mmseqs2_tpu_torch.ops import kernels, rescore
    kernels.build("rescore")
    counted = "n_valid" in inspect.signature(rescore.diag_rescore).parameters
    chip_smoke.phase_rescore_kernel(
        np.random.default_rng(chip_smoke.SEED),
        counts=(False, True) if counted else (False,))


def main(argv):
    if argv[:1] == ["--tree"] and len(argv) == 2:
        run_tree(argv[1])
        return 0
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    chip_smoke.log(f"card: {chip_smoke.card_line()}")
    for tree in argv:
        tree = str(pathlib.Path(tree).resolve())
        chip_smoke.log(f"rescore-ab tree {tree}")
        subprocess.run([sys.executable, __file__, "--tree", tree],
                       check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
