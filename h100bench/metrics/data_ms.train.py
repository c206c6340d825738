"""data_ms.train: host milliseconds per step to make a batch with the
program's synthetic pipeline and copy it to the card (the benchmark's own
span around ``make_batch``; the card has finished the previous step)."""


def read(rec):
    s = rec["spans"].get("data")
    return 1e3 * sum(s) / len(s) if s else None
