"""Wall ms a frame of the hybrid solve's SPD re-solve (between two
synchronises) in the timed pass; None where the system has no such
phase."""


def read(rec):
    return rec.phase_ms("spd")
