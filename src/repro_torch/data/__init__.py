"""Synthetic data with a checkpointable cursor."""
