"""Checkpoints in the reference's CSV layouts."""
