from .engine import Workflow  # noqa: F401
