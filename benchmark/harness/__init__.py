"""The harness: it finds a cell's files by name, makes its input, drives the
timed window, reads the trace and compares the output with the reference."""
