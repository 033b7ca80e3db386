"""`gpuserver` command shim (implementation in server/device_server.py)."""

from ..server.device_server import gpuserver  # noqa: F401
