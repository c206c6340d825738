"""The paper's own workload configs: the six stencils x the SZ grid,
re-exported so launch scripts can select them with --arch-like names."""

from repro_torch.core.timemodel import STENCILS  # noqa: F401
from repro_torch.core.workload import paper_sizes, paper_workload  # noqa: F401
