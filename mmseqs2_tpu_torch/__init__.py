"""mmseqs2_tpu_torch — the PyTorch/CUDA port of mmseqs2_tpu.

A second package beside the JAX reference (`mmseqs2_tpu`): the same commands,
database format and results, with plain tensor code in PyTorch and every
kernel the JAX package wrote in Pallas rewritten by hand in CUDA C++ for
Hopper (`csrc/`). It imports nothing from `mmseqs2_tpu`: the JAX-free modules
it needs are copied here.

Entry points run on the CUDA card unless the environment variable
MMSEQS2_TPU_TORCH_DEVICE=cpu asks for the CPU (see device.py).
"""

import pathlib

__version__ = "0.1.0"

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent
REPO_ROOT = PACKAGE_DIR.parent
# kernels and native helpers are built here at first use (git-ignored)
BUILD_DIR = PACKAGE_DIR / "_build"
