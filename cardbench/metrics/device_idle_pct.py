"""Device: the share of the traced window in which nothing ran on the
card (no kernel, copy or fill; ``torch.profiler``), in %."""


def read(run):
    if not run.summary or run.summary["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.summary["busy_s"] / run.window_s)
