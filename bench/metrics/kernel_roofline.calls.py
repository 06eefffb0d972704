"""kernel_roofline.calls: see ``bench.readers.kernel_roofline``."""

from bench.readers import kernel_roofline as read  # noqa: F401
