"""The paper's models and the codesign optimizer, in PyTorch: analytical
area and time models, the numpy oracle, the torch sweep engine and the
eq.-18 driver."""

from .area import (  # noqa: F401
    GTX980,
    MAXWELL,
    TITAN_X,
    HardwarePoint,
    LinearAreaModel,
    cacheless,
)
from .codesign import (  # noqa: F401
    STOCK,
    CodesignResult,
    HardwareSpace,
    codesign,
    enumerate_hw_space,
    evaluate_fixed_hw,
)
from .pareto import pareto_front, pareto_mask, pareto_mask_batched  # noqa: F401
from .solver import (  # noqa: F401
    LATTICE_2D,
    LATTICE_3D,
    TileLattice,
    decode_index,
    refine_point,
    solve_cell,
)
from .sweep import (  # noqa: F401
    clear_caches,
    device_count,
    refine_points,
    sweep_cell,
    sweep_cells,
    sweep_cells_sharded,
)
from .timemodel import (  # noqa: F401
    GPUS_BY_NAME,
    MAXWELL_GPU,
    STENCILS,
    TITANX_GPU,
    GPUSpec,
    ProblemSize,
    StencilSpec,
    stencil_gflops,
    stencil_time,
)
from .workload import Workload, WorkloadCell, paper_sizes, paper_workload  # noqa: F401
