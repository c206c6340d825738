"""device_idle_pct.stencil: the card's idle share of the traced stencil
window, in %: 1 - (union of the device operations' intervals) / window."""

from h100bench.trace import idle_pct as read  # noqa: F401
