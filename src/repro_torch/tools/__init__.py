"""CLI tools."""
