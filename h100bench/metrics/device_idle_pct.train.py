"""device_idle_pct.train: the card's idle share of the traced training
window, in %: 1 - (union of the device operations' intervals) / window."""

from h100bench.trace import idle_pct as read  # noqa: F401
