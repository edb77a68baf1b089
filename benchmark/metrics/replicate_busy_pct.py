"""The program's ``replicate`` stage (the flush span's upload to every
card of the mesh, on the dispatch lane) over the traced passes' wall
time, in % (engine.StageTimer: the stage summed over the passes)."""

STAGE = "replicate"


def read(record):
    stages, wall = record.get("stages"), record.get("traced_pass_wall_s")
    if not stages or not wall or STAGE not in stages:
        return None
    return 100.0 * stages[STAGE] / wall
