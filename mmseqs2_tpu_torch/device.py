"""Device picker: the CUDA card by default, the CPU only on request.

MMSEQS2_TPU_TORCH_DEVICE selects the device of every entry point:
  unset or "cuda"  the CUDA card; raises when PyTorch sees none
  "cpu"            the CPU, where each kernel wrapper runs its plain
                   PyTorch version (the tests use this)
There is no quiet fallback from the card to the CPU.
"""

import os

import torch

ENV = "MMSEQS2_TPU_TORCH_DEVICE"


def get_device() -> torch.device:
    want = os.environ.get(ENV, "cuda").strip().lower() or "cuda"
    if want == "cpu":
        return torch.device("cpu")
    if want != "cuda":
        raise ValueError(f"{ENV}={want!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"no CUDA device is available; set {ENV}=cpu to run on the CPU")
    return torch.device("cuda")
