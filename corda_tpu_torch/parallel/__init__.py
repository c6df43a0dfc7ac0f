"""Several devices: a mesh of torch devices and the batch split over it.

The reference shards its signature batches over a jax.sharding mesh
(corda_tpu/parallel/). Here a mesh is a list of torch devices, one
verify chunk splits into one contiguous slice of rows per device, each
slice runs its own kernel launch on its own card, and no byte moves
between cards: the work is elementwise over the batch, so there is no
collective. `parallel.dryrun` drives the split and the per-shard
verifiers over n cards, as the reference's dryrun_multichip does.
"""
