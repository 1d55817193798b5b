"""Launchers: the training entry point."""
