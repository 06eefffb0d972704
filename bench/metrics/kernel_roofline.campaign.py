"""kernel_roofline.campaign: see ``bench.readers.kernel_roofline``."""

from bench.readers import kernel_roofline as read  # noqa: F401
