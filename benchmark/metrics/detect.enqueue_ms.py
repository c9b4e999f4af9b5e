"""Host ms per ``dispatch_tiles`` call (pinned copy, premold, the step's
enqueue), the mean over every batch of the window."""


def read(record):
    calls = record["spans"].get("dispatch")
    return 1e3 * sum(calls) / len(calls) if calls else None
