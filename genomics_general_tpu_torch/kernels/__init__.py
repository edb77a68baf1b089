from . import pairdist, transfer  # noqa: F401
