"""The six stencils and their kernels: the tile-parameterized K1/K2
(:mod:`.tiled_stencils`) that the measurement harness times, the one-step
K3/K4 (:mod:`.stencil_common`, :mod:`.ops`), their plain torch versions,
and the eager oracle :mod:`.ref`. The CUDA sources are under ``csrc/`` and
are built by :mod:`._build`."""
