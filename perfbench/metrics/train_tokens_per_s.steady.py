"""``train_tokens_per_s``, read in the cell with no store and no fault."""
from perfbench.spec import reader

read = reader("train_tokens_per_s")
