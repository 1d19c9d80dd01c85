"""The profiled pass's compulsory bytes (``work_bytes``, from the frames'
own counts) at the card's HBM rate, over the device time of the pass, in
percent.  The rate is the data sheet's at 700 W; the result line gives the
card's power limit beside it."""

from benchmark.work_bytes import HBM_BYTES_PER_S


def read(rec):
    if not rec.frame_bytes or not rec.trace["device_s"]:
        return None
    return 100.0 * sum(rec.frame_bytes) / HBM_BYTES_PER_S / rec.trace["device_s"]
