"""The LM architectures' parameter trees as ``nn.Module``s (init only; the
forward passes come with serving and training), the parameter accounting
of the LM codesign cells, and the carry of a JAX package tree."""

from .convert import from_reference_params  # noqa: F401
from .model import LEARNED_POS_MAX, Model, active_params, count_params  # noqa: F401
from .transformer import segments  # noqa: F401
