"""Milliseconds per batched step in the program's `nls.eigh` spans
(ops/krylov.tridiag_eigh: T built, the finite mask, the batched
torch.linalg.eigh and the host's wait at its sync), their whole length,
over the traced call's steps. The traced call's host runs slower under the
profiler, so this reads high against the untraced step. None where the
trace holds no `nls.` span."""

from portbench.spans import program_spans


def read(rec):
    got = program_spans(rec)
    if got is None:
        return None
    return 1e3 * sum(e - s for name, s, e in got[1]
                     if name == "nls.eigh") / rec.traced_steps
