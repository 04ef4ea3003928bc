"""train.packed.launches_per_step: launch calls in the profiled slice
over its steps, in the packed field's training cells."""
from portbench.lib.readers import launches_per_step as read  # noqa: F401
