"""Peak device memory allocated on rank 0's card during the window, in GB
(1e9 bytes): `torch.cuda.max_memory_allocated()` after
`reset_peak_memory_stats()`."""
from nshedb_bench.readings import peak_gb


def read(run):
    return peak_gb(run)
