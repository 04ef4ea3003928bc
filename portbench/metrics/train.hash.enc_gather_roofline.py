"""train.hash.enc_gather_roofline: the encoder forward's share of its
bound, in the hash field's training cells."""
from portbench.lib.readers import enc_gather_roofline as read  # noqa: F401
