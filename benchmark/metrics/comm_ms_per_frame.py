"""NCCL kernels' device ms a frame in the profiled pass (rank 0); None
where the run launched none."""


def read(rec):
    if not rec.trace["nccl_s"]:
        return None
    return 1e3 * rec.trace["nccl_s"] / rec.traced_frames
