"""serve.drain_trips: the one-shot renderer's drain trips a view in the
traced slice, by the program's counters."""
from portbench.lib.program_readers import \
    drain_trips_per_view as read  # noqa: F401
