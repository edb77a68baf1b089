"""Kernel launches the program counted (the LAUNCHES counters of its
kernel modules) over the traced passes, per planned window."""


def read(record):
    launches = record.get("launches")
    if launches is None or not record.get("windows_per_pass"):
        return None
    return sum(launches.values()) / (record["windows_per_pass"]
                                     * record["passes"])
