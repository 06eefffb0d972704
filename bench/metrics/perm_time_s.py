"""perm_time_s: see ``bench.readers.perm_time_s``."""

from bench.readers import perm_time_s as read  # noqa: F401
