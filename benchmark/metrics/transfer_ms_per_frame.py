"""Wall ms a frame of the transfer layer's phases (each between two
synchronises) in the timed pass; None where the system has no such
phase."""


def read(rec):
    return rec.phase_ms("transfer")
