"""train.packed.enc_scatter_roofline: the encoder backward's share of
its bound, in the packed field's training cells."""
from portbench.lib.readers import enc_scatter_roofline as read  # noqa: F401
