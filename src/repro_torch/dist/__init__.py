"""repro_torch.dist — so far only the int8 payload codec
(:mod:`repro_torch.dist.compression`) the Pack-side compression tier uses."""
