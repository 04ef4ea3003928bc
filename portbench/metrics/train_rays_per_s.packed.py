"""train_rays_per_s.packed: every ray of every step completed in the
window over its seconds, in the packed field's training cells."""
from portbench.lib.readers import rays_per_s as read  # noqa: F401
