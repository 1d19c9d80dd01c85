"""Frames completed in the window over the whole window (host clock, the
window ended by a synchronise after its last frame)."""


def read(rec):
    return rec.frames / rec.window_s if rec.frames else None
