"""Timing on the card, phase timers, profiler traces and fit checkpoints."""
