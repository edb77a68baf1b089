"""The program's ``dist_stats`` stage (the host's distance statistics on
the mirrored [W, H, H] arrays, on the collect lane) over the traced
passes' wall time, in % (engine.StageTimer: the stage summed over the
passes)."""

STAGE = "dist_stats"


def read(record):
    stages, wall = record.get("stages"), record.get("traced_pass_wall_s")
    if not stages or not wall or STAGE not in stages:
        return None
    return 100.0 * stages[STAGE] / wall
