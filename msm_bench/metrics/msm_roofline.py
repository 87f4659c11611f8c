"""msm_roofline: the whole MSM's share of its roofline, in %: t_min
(``roofline.msm_min``, from the problem alone) times the MSMs traced, over
the kernel time (the union of kernel intervals, copies left out) summed
over the cell's cards."""


def read(run):
    if run.trace is None:
        return None
    kernel_s = sum(c.kernel_s for c in run.trace.cards.values())
    return 100 * run.t_min_s() * run.msms / kernel_s if kernel_s > 0 else None
