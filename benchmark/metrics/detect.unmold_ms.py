"""Host ms per batch in ``fetch`` and ``unmold_fetched``, after the wait on
the batch's event, the mean over every batch of the window."""


def read(record):
    calls = record["spans"].get("unmold")
    return 1e3 * sum(calls) / len(calls) if calls else None
