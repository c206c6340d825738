"""codesign_ms.stencil: milliseconds of the eq.-18 codesign sweep run in
the cell's set-up, read from the program's ``repro_codesign_seconds``
histogram (its host clock through the sweep's read back)."""


def read(rec):
    return rec.get("codesign_ms")
