"""Fault tolerance: injection, detection, elastic rescale, stragglers."""
