"""device_peak_gib: ``torch.cuda.max_memory_allocated`` over the window
(after ``reset_peak_memory_stats``), the largest over the cell's cards, in
GiB; the point table and the plan's buffers are resident, so they count."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
