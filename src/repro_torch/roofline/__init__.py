"""Roofline analysis from compiled dry-run artifacts."""
