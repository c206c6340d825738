"""Process-level health gauges: is the *gateway itself* healthy?

Registered into the default registry so ``GET /v1/metrics`` can answer
"how big is this process" without anyone shelling into the box:

* ``repro_process_rss_bytes`` -- resident set size, read from
  ``/proc/self/statm`` (resident pages x page size). On non-Linux hosts
  the sampler falls back to ``resource.getrusage`` peak RSS, and on
  platforms with neither it degrades to not updating the gauge at all --
  never raising from a metrics scrape.
* ``repro_gateway_connections`` -- currently open gateway HTTP
  connections (inc/dec'd by the handler lifecycle).
* ``repro_gateway_pool_servers`` -- resident artifact servers in the
  gateway's LRU pool.

RSS is sampled lazily at scrape time (:func:`sample_process`) rather
than on a timer: metrics that nobody reads cost nothing.
"""

from __future__ import annotations

import os
from typing import Optional

from .metrics import get_registry

__all__ = [
    "M_CONNECTIONS",
    "M_POOL_SERVERS",
    "M_RSS",
    "rss_bytes",
    "sample_process",
]

M_RSS = get_registry().gauge(
    "repro_process_rss_bytes",
    "resident set size of the serving process (sampled at scrape)",
)
M_CONNECTIONS = get_registry().gauge(
    "repro_gateway_connections",
    "currently open gateway HTTP connections",
)
M_POOL_SERVERS = get_registry().gauge(
    "repro_gateway_pool_servers",
    "resident artifact servers in the gateway LRU pool",
)

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096


def rss_bytes() -> Optional[int]:
    """Current RSS in bytes, or None when the platform offers no cheap
    way to ask. Linux: /proc/self/statm. Elsewhere: getrusage peak RSS
    (a monotone over-estimate, but an honest upper bound)."""
    try:
        with open("/proc/self/statm", "rb") as f:
            fields = f.read().split()
        return int(fields[1]) * int(_PAGE_SIZE)
    except (OSError, IndexError, ValueError):
        pass
    try:
        import resource

        peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # ru_maxrss is KiB on Linux, bytes on macOS
        return int(peak) * (1 if peak > 1 << 32 else 1024)
    except Exception:
        return None


def sample_process() -> None:
    """Refresh the lazily-sampled process gauges (called on each
    ``/v1/metrics`` render). Never raises."""
    rss = rss_bytes()
    if rss is not None:
        M_RSS.set(rss)
