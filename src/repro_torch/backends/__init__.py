"""Checkpoint backends: FTI-like, SCR-like, VeloC-like (behind TCL)."""
