"""The LM model zoo: parameter trees as ``nn.Module``s, their forward
passes (attention variants, MoE, SSD, blocks and stacks, the model and its
loss), the parameter accounting of the LM codesign cells, and the carry of
a JAX package tree and its caches."""

from .convert import (  # noqa: F401
    caches_from_reference,
    caches_to_reference,
    from_reference_params,
    load_reference_tree,
)
from .model import (  # noqa: F401
    LEARNED_POS_MAX,
    Model,
    active_params,
    chunked_ce,
    count_params,
    forward,
    forward_hidden,
    lm_loss,
    mrope_positions,
)
from .transformer import segments  # noqa: F401
