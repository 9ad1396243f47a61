"""solve_roofline (%): the whole ranked request against the card's
bandwidth bound: its steps' and its ψ epilogue's least bytes
(``gpubench/roofline.py``) at the HBM bandwidth, over the request's wall
time, summed over the first, unprofiled half of a traced window. It still
bounds a gain after a kernel is fused away or taken off the path."""


def read(run):
    if not run.peaks or not run.latencies:
        return None
    bw = run.peaks["hbm_bytes_per_s"]
    least = wall = 0.0
    for lat, steps in zip(run.latencies, run.iterations):
        least += (steps * run.work["step"] + run.work["epilogue"]) / bw
        wall += lat
    return least / wall * 100.0
