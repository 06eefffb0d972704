"""perms_per_s: see ``bench.readers.perms_per_s``."""

from bench.readers import perms_per_s as read  # noqa: F401
