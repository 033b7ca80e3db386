from .aligner import Aligner, AlnResult  # noqa: F401
