"""The host's waits on the device a frame in the profiled pass: the CUDA
runtime's synchronising calls inside the frames' ranges."""


def read(rec):
    if not rec.traced_frames:
        return None
    return rec.trace["host_syncs"] / rec.traced_frames
