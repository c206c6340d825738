"""Codesign query service over precomputed sweep artifacts, in the port.

The eq.-18 separability decomposition caches per-cell/per-hardware optima
as a ``(cells x hardware)`` matrix; once persisted, every workload
question is a cheap vectorized re-reduction ("sensitivity for free",
paper §V.B). The port so far has the in-process half of the JAX
package's service, with the same on-disk format:

* :mod:`repro_torch.service.store`   -- versioned, content-addressed
  on-disk artifacts (compressed npz + JSON manifest, mmap-backed lazy
  loads, a cross-process build lock);
* :mod:`repro_torch.service.query`   -- ``QueryRequest -> QueryResponse``
  re-reductions (mixes, top-k, Pareto, what-ifs) with an LRU;
* :mod:`repro_torch.service.server`  -- thread-safe in-process server that
  microbatches concurrent queries into one reduction pass and sweeps on the
  card exactly once on an artifact miss;
* :mod:`repro_torch.service.resilience` -- request deadlines;
* :mod:`repro_torch.service.faults`  -- deterministic fault injection;
* :mod:`repro_torch.service.errors`  -- the structured-error vocabulary.

The gateway, wire codec, client and service CLI come in a later slice.
"""

from . import faults  # noqa: F401
from .errors import ERROR_HTTP_STATUS, GatewayError  # noqa: F401
from .query import QueryEngine, QueryRequest, QueryResponse  # noqa: F401
from .resilience import Deadline, DeadlineExceededError  # noqa: F401
from .server import CodesignServer, LMServer, server_from_artifact  # noqa: F401
from .store import (  # noqa: F401
    KINDS,
    Artifact,
    ArtifactStore,
    BuildLockTimeoutError,
    artifact_spec,
    spec_key,
)
