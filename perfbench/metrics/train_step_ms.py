"""Training: the whole window over the steps completed in it."""


def read(run):
    if run.entry != "fit" or run.units == 0 or run.profile is not None:
        return None
    return 1000.0 * run.window_s / run.units
