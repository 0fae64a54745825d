"""kernels.ssd_scan_roofline: the least time of the SSD scan's work at the
traced calls' shapes (``counts.ssd_scan``: each prefill's n_layer calls at
the bucket's rows) over the device time of K4's two kernels
(``kernels/ssd_scan``), in %.  None where the trace holds none of them;
another count than two kernels a call fails the run."""

from bench import counts
from bench.reference import mamba2

KERNELS = r"\bssd_chunk_(state|scan)_kernel\b"


def read(ctx):
    tr = ctx.trace
    c, T = ctx.conf["config"], ctx.traffic["prompt_len"]
    _, H, P, N = mamba2.dims(c)
    found = tr.kernels(KERNELS)
    if not found:
        return None
    counts.expect_kernels(found, 2 * c["n_layer"] * len(tr.steps), KERNELS)
    least = sum(c["n_layer"] * counts.least_s(*counts.ssd_scan(
        s.bucket, T, H, P, N, mamba2.scan_chunk(c, T))) for s in tr.steps)
    return 100.0 * least / (sum(e - s for _, s, e in found) / 1e6)
