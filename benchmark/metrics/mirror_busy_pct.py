"""The program's ``mirror`` stage (the packed triangles unpacked into the
int32 [W, H, H] mismatch and shared arrays, on the collect lane) over
the traced passes' wall time, in % (engine.StageTimer: the stage summed
over the passes)."""

STAGE = "mirror"


def read(record):
    stages, wall = record.get("stages"), record.get("traced_pass_wall_s")
    if not stages or not wall or STAGE not in stages:
        return None
    return 100.0 * stages[STAGE] / wall
