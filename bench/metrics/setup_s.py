"""setup_s: see ``bench.readers.setup_s``."""

from bench.readers import setup_s as read  # noqa: F401
