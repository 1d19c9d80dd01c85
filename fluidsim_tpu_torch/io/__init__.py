"""Run-time I/O of the port: the ``.vdb`` writer and reader, the native
writer queue, the asynchronous frame exporter, checkpoints, metrics and
rendering — the counterparts of ``fluidsim_tpu/io``."""
