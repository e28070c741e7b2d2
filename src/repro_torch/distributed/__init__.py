"""Distributed substrate: sharding rules as DTensor placements, the manual
data-axis group, the GPipe pipeline, checkpointing and the fault-tolerant
training loop."""
