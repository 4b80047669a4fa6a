"""Milliseconds to bring a batch's snapshot stack and guard flags to the
host (Datagen._host, as the sweep fetches them), host clock around the copy
after a synchronize, mean over the window's batches."""


def read(rec):
    if not rec.batches:
        return None
    return 1e3 * sum(b["readback_s"] for b in rec.batches) / len(rec.batches)
