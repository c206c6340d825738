"""prefill_ms.serve: milliseconds of a batch's prefill in the traced window
(``serve.generate_timed``'s host clock, stopped once the card has
finished), the mean over the window's batches."""


def read(rec):
    p = rec.get("prefill_s")
    return 1e3 * sum(p) / len(p) if p else None
