"""Kernel geometry autotuner (cost-model-seeded search + on-disk table).

``table.py`` is the persistence layer the planner reads
(:class:`~repro_torch.tune.table.TuningTable`); ``search.py`` is the tuner
that fills it on the card (enumerate valid candidates -> rank by the
model -> measure top-k -> persist winners with the predicted-vs-measured
ratio).  ``launch/tune.py`` is the CLI.
"""

from .table import TableEntry, TuningTable, density_bucket, resolve_geometry

__all__ = ["TableEntry", "TuningTable", "density_bucket",
           "resolve_geometry"]
