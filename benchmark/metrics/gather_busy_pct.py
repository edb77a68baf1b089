"""The program's ``gather`` stage (the wait for every card's slab of the
pair counts and its copy to the host, on the collect lane) over the
traced passes' wall time, in % (engine.StageTimer: the stage summed over
the passes)."""

STAGE = "gather"


def read(record):
    stages, wall = record.get("stages"), record.get("traced_pass_wall_s")
    if not stages or not wall or STAGE not in stages:
        return None
    return 100.0 * stages[STAGE] / wall
