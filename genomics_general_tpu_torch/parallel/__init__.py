from . import multihost  # noqa: F401
