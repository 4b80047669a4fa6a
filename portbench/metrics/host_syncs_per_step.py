"""Host syncs per batched step: torch.cuda's sync debug mode over one call
of 3 snapshots (the eigh of every matrix function, the guard's flag per
snapshot), over its steps."""


def read(rec):
    if rec.syncs is None or not rec.traced_steps:
        return None
    return rec.syncs / rec.traced_steps
