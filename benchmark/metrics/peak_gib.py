"""The device allocator's peak (torch.cuda.max_memory_allocated) over the
whole run, set-up included, in GiB; on a multi-rank cell the largest
rank's."""


def read(run):
    return run.memory_peak_bytes / 2**30 if run.memory_peak_bytes else None
