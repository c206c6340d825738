"""Measurement and calibration: the timing harness over the K1/K2 tile
kernels (:mod:`.harness`) and the log-space refit of the time model's
machine parameters (:mod:`.calibrate`). Results are the same JSON as the
JAX package's, so either package can fit or frame the other's."""

from .calibrate import (  # noqa: F401
    RECOVERY_RTOL,
    CalibrationResult,
    fit_machine_params,
    predicted_times,
    synthetic_records,
)
from .harness import (  # noqa: F401
    MeasurementRecord,
    MeasurementRun,
    default_grid,
    measure_grid,
    measure_one,
)
