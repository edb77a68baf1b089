from . import popgen  # noqa: F401
