"""SUperman permanents on PyTorch and CUDA (the port of ``repro``).

``permanent(A)`` / ``permanent_batch(As)`` run on the card by default
(``device="cpu"`` for the host); the dense real f64 path goes through the
CUDA kernel in ``kernels/csrc/ryser_dense.cu``, the dense complex128 path
(split re/im planes) through ``kernels/csrc/ryser_complex.cu``.  A leaf
beyond ``campaign_threshold`` (dense n >= 31 at the default) runs as a
resumable campaign of checkpointed waves (``core/distributed.py``);
``CampaignPaused`` signals a spent ``campaign_max_waves`` budget.
"""

from .core.engine import CampaignPaused, permanent, permanent_batch
from .core.planner import SolverConfig
from .core.solver import PermanentSolver

__all__ = ["permanent", "permanent_batch", "PermanentSolver", "SolverConfig",
           "CampaignPaused"]
