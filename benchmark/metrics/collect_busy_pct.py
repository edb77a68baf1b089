"""The program's collect lane busy over the traced passes' wall time, in %
(engine.StageTimer: the lane's stages summed over the passes)."""

LANE = "collect"


def read(record):
    lanes, wall = record.get("lanes"), record.get("traced_pass_wall_s")
    if not lanes or not wall or LANE not in lanes:
        return None
    return 100.0 * lanes[LANE] / wall
