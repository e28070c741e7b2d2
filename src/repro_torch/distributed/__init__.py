"""Distributed substrate on one process: checkpointing and the
fault-tolerant training loop."""
