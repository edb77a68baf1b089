"""Input sites processed per second of the window: every site of every
pass, over the window's whole wall time (host clock)."""


def read(record):
    if not record.get("elapsed_s"):
        return None
    return record["sites_per_pass"] * record["passes"] / record["elapsed_s"]
