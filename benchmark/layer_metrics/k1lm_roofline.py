"""K1-LM (csrc/gn_kernel.cu, `k_lm_persistent`): the least time a solve
could take (costs.lm_cost at the cell's shapes and settings) over the
kernel's device time a solve, in %. None where the trace kept no record
of the kernel."""

from benchmark import costs

KERNEL = "k_lm_persistent"


def read(run):
    hits = [v for n, v in run.trace["kernels"].items() if KERNEL in n]
    if not hits or not run.latencies:
        return None
    dev_ms = 1e3 * sum(s for _, s in hits) / len(run.latencies)
    sv = run.mix["solver"]
    N, c, El = run.shape
    K = costs.pcr_levels(N, sv.get("pcr_levels"))
    nbytes, flops = costs.lm_cost(N, c, El, K, sv["max_iterations"], sv["cg_max_iterations"])
    return 100.0 * costs.bound_ms(nbytes, flops) / dev_ms
