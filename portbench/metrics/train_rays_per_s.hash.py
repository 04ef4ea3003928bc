"""train_rays_per_s.hash: every ray of every step completed in the
window over its seconds, in the hash field's training cells."""
from portbench.lib.readers import rays_per_s as read  # noqa: F401
