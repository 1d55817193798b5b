"""Redundancy schemes: partner copies, XOR/Reed-Solomon erasure groups."""
