"""Whole-scene evaluation: the whole window over the scenes completed in it."""


def read(run):
    if run.entry != "run_test" or run.units == 0 or run.profile is not None:
        return None
    return 1000.0 * run.window_s / run.units
