from . import geno  # noqa: F401
