"""Slab-sharded FLIP and MPM over ``torch.distributed``, one process per
slab of the grid's x axis — the counterpart of ``fluidsim_tpu/parallel/``."""
