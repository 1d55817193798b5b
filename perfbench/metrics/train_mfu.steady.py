"""``train_mfu``, read in the cell with no store and no fault; it moves
``train_tokens_per_s.steady``."""
from perfbench.spec import reader

read = reader("train_mfu")
