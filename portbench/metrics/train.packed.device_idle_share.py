"""train.packed.device_idle_share: the share of the profiled slice in
which nothing ran on the device, in the packed field's training cells."""
from portbench.lib.readers import device_idle_share as read  # noqa: F401
