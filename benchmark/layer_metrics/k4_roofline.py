"""K4 (csrc/gn6_kernel.cu, `k6_gn_wide`): the least time a GN solve could
take (costs.gn6_cost at the cell's shapes and settings) over the kernel's
device time a solve, in %. None where the trace kept no record of the
kernel."""

from benchmark import costs

KERNEL = "k6_gn_wide"


def read(run):
    hits = [v for n, v in run.trace["kernels"].items() if KERNEL in n]
    if not hits or not run.latencies:
        return None
    dev_ms = 1e3 * sum(s for _, s in hits) / len(run.latencies)
    sv = run.mix["solver"]
    N, c, El = run.shape
    K = costs.pcr_levels(N, sv.get("pcr_levels"))
    nbytes, flops = costs.gn6_cost(N, c, El, K, run.mix["iterations"], sv["cg_max_iterations"])
    return 100.0 * costs.bound_ms(nbytes, flops) / dev_ms
