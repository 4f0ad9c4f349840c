"""Optimizers, training loops, metrics, checkpoints, preemption and sweeps."""
