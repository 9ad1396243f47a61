"""step_issue_us (us): the median of the program's ``engine.issue`` spans,
the host's time to issue one body of the solver loop (the step's pad and
s ⊙ 1/w, the launch's checks and the launch; one step a body here), in the
first half of a traced window."""
import statistics


def read(run):
    spans = [s["dur"] for s in run.program_spans
             if s["name"] == "engine.issue"]
    return statistics.median(spans) * 1e6 if spans else None
