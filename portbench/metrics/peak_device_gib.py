"""Peak device memory of the window: torch.cuda.max_memory_allocated()
after reset_peak_memory_stats(), in GiB. It sets how many trajectories one
card holds."""


def read(rec):
    return rec.memory_peak_bytes / 2 ** 30 if rec.memory_peak_bytes else None
