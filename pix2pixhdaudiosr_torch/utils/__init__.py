"""Checkpoint helpers of the port."""
