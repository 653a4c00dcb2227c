"""Multi-layout stacks (counterpart of carle_tpu/parallel): so far the packed
stack on one device, :class:`~.packed_env.PackedSpatialStack` with
``mesh=None``."""
