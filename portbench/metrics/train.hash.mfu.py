"""train.hash.mfu: the window's model operations over its seconds and
the compute dtype's peak, in the hash field's training cells."""
from portbench.lib.readers import train_mfu as read  # noqa: F401
