"""``flash_bwd_roofline``, read in the cell with no store and no fault; it
moves ``train_tokens_per_s.steady``."""
from perfbench.spec import reader

read = reader("flash_bwd_roofline")
