"""Median of a phase time from the stretch with ``timings=``, in ms."""
import statistics


def median_ms(run, entry, key, group=1):
    if run.entry != entry or not run.timings or not run.timings.get(key):
        return None
    values = run.timings[key]
    if group > 1:
        values = [sum(values[i:i + group]) for i in range(0, len(values) - group + 1, group)]
    return 1000.0 * statistics.median(values)
