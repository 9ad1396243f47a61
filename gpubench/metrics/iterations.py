"""iterations (steps, a count): the median over a traced window's requests
of the solve's Power-ψ steps."""
import statistics


def read(run):
    return float(statistics.median(run.iterations)) if run.iterations \
        else None
