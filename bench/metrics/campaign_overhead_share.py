"""campaign_overhead_share: see ``bench.readers.campaign_overhead_share``."""

from bench.readers import campaign_overhead_share as read  # noqa: F401
