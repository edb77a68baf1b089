"""The port's benchmark: popgenWindows cells of public cohorts, each cell,
configuration, analysis reference and metric a file of its own (README.md)."""
