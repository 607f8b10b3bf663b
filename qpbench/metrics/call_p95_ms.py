"""Layer: entry (``batch.solve_batch``).

The 95th percentile of one call's time on the host clock, from the call
until its x, exit flags and iterations are on the host, over every call
of a traced run's first window, which runs untraced
(``statistics.quantiles``, exclusive method)."""
import statistics


def read(ctx):
    lat = ctx.latencies_s
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=20)[18]
