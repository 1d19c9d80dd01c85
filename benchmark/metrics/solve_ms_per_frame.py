"""Wall ms a frame of the solve layer's phases (each between two
synchronises) in the timed pass; None where the system has no such
phase."""


def read(rec):
    return rec.phase_ms("solve")
