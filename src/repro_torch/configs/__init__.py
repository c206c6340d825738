"""Architecture + shape configuration registry (``--arch``, ``--shape``)."""

from .base import (  # noqa: F401
    ARCHS,
    SHAPES,
    ArchConfig,
    AttnConfig,
    MoEConfig,
    ShapeSpec,
    SSMConfig,
    get,
    get_arch,
    list_archs,
    register,
)
