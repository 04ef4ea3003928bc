"""serve.field_useful_share: the samples a view needs over the rows the
program's field evaluates a view (its field_points counter), in %."""
from portbench.lib.program_readers import \
    field_useful_share as read  # noqa: F401
