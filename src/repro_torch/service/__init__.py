"""Codesign query service over precomputed sweep artifacts, in the port.

The eq.-18 separability decomposition caches per-cell/per-hardware optima
as a ``(cells x hardware)`` matrix; once persisted, every workload
question is a cheap vectorized re-reduction ("sensitivity for free",
paper §V.B). The port serves it as the JAX package does, with the same
on-disk format and the same wire bytes:

* :mod:`repro_torch.service.store`   -- versioned, content-addressed
  on-disk artifacts (compressed npz + JSON manifest, mmap-backed lazy
  loads, a cross-process build lock);
* :mod:`repro_torch.service.query`   -- ``QueryRequest -> QueryResponse``
  re-reductions (mixes, top-k, Pareto, what-ifs) with an LRU;
* :mod:`repro_torch.service.server`  -- thread-safe in-process server that
  microbatches concurrent queries into one reduction pass and sweeps on the
  card exactly once on an artifact miss;
* :mod:`repro_torch.service.gateway` -- the fleet front door: discovers
  every artifact across store roots, routes each request by content key or
  selector (GPU / stencil set / workload), keeps an LRU-bounded pool of
  per-artifact servers, and serves it all over stdlib HTTP;
* :mod:`repro_torch.service.portfolio` -- K-design fleet portfolios
  persisted as ``kind: "portfolio"`` manifests and the
  heterogeneity-aware ``/v1/route`` server over them;
* :mod:`repro_torch.service.wire`    -- the versioned HTTP/JSON codec
  (requests, responses, structured errors);
* :mod:`repro_torch.service.client`  -- thin HTTP client for a gateway;
* :mod:`repro_torch.service.usage`   -- the persistent per-root usage
  ledger and the kind-aware retention plan behind ``gc``;
* :mod:`repro_torch.service.resilience` -- deadlines, admission control
  (token buckets + load shedding), circuit breakers and the client retry
  policy;
* :mod:`repro_torch.service.faults`  -- deterministic fault injection;
* :mod:`repro_torch.service.errors`  -- the structured-error vocabulary;
* :mod:`repro_torch.service.cli`     -- ``python -m repro_torch.service.cli
  query|build|portfolio|route|ls|upgrade|gc|serve``.

"""

from . import faults  # noqa: F401
from .client import GatewayClient  # noqa: F401
from .errors import ERROR_HTTP_STATUS  # noqa: F401
from .resilience import (  # noqa: F401
    CircuitOpenError,
    Deadline,
    DeadlineExceededError,
    GatewayResilience,
    RateLimitedError,
    RetryPolicy,
    ShedError,
)
from .gateway import (  # noqa: F401
    AmbiguousRouteError,
    AmbiguousWorkloadError,
    Gateway,
    GatewayError,
    GatewayHTTPServer,
    UnknownArtifactError,
    WrongArtifactKindError,
    serve_http,
)
from .portfolio import (  # noqa: F401
    PortfolioExhaustedError,
    PortfolioServer,
    RouteRequest,
    RouteResponse,
    UnknownCellError,
    build_portfolio,
)
from .query import QueryEngine, QueryRequest, QueryResponse  # noqa: F401
from .server import CodesignServer, LMServer, server_from_artifact  # noqa: F401
from .store import (  # noqa: F401
    KINDS,
    Artifact,
    ArtifactStore,
    BuildLockTimeoutError,
    artifact_spec,
    spec_key,
)
from .wire import RemoteError, WireError  # noqa: F401
